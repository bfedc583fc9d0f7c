"""Bulk serving: ``FastSim.simulate_bulk(cond, noise=..., return_experts=True)``
called call after call, each on a fresh draw of the traffic's rows.

Set-up: the weights from the seed (generator experts, router and, where the
family has them, BatchNorm statistics), the router's last bias shifted so
that it sends a third of ``router_balance_rows`` conditions that the
traffic draws to each expert, the engine at the cell's precision, batch,
tile and dispatch form (checked on the engine after the build), and
``warm_calls`` calls on the window's shapes. The window
(``harness/window.py``): calls until ``--seconds`` have passed;
``showers_per_s`` is every shower returned over the window's whole time.
Each call keeps ``keep_per_call`` of its rows, drawn from the seed: their
inputs, expert ids and showers; the result line reports the kept rows'
``expert_shares``.

The check, once the window has closed, the peak memory has been read and
the engine is freed: the plain reference routes each kept row (float32) and
decodes it with its routed expert (float32); ``route_mismatch`` counts the
rows whose id differs where the reference's top two logits lie more than
``tie_logit_gap`` apart; each row's gap is the L2 gap, in log space,
between its served shower and the reference's, relative to the reference
shower's norm or, where that is below it, to the median norm of the
sample's reference showers; ``shower_gap`` is the largest gap (each row
over it is judged wrong),
``shower_gap_median`` the median, and ``shower_gap_median_rel`` the median
over the median gap that the reference itself reads on the stated int8 grid
(its step set as the program sets it, ``control_grid``) on the same rows. A
cell compares the numbers its ``check.limits`` names. A traced run
then profiles ``trace_calls`` more calls.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import torch

from harness import trace as tr
from reference.common import ieee_f32
from harness.traffic import draw
from harness.weights import balance_router, expert, make_tree, seed_stream, shares
from harness.window import window


def make_weights(run):
    """``(generator experts, router, batch statistics or {})`` from the seed;
    where the family has BatchNorms, their running statistics fitted to
    ``stats_fit_rows`` rows that the traffic draws, expert by expert."""
    ref, s, dev = run.reference, run.settings, run.device
    e = int(s["model.n_experts"])
    gen = make_tree(ref.generator_leaves(s), seed_stream(run.seed, 0), dev, lead=(e,))
    router = make_tree(ref.router_tree_leaves(s), seed_stream(run.seed, 1), dev)
    cal = torch.Generator(device=dev).manual_seed(seed_stream(run.seed, 6))
    cond = draw({"cond": run.traffic["fields"]["cond"]}, int(run.cell["router_balance_rows"]),
                cal, dev, s)["cond"]
    balance_router(router, ref.router, cond)
    stats = {}
    if hasattr(ref, "fit_batch_stats"):
        fit = torch.Generator(device=dev).manual_seed(seed_stream(run.seed, 2))
        x = draw(run.traffic["fields"], int(run.cell["stats_fit_rows"]), fit, dev, s)
        with torch.no_grad(), ieee_f32():
            per = [ref.fit_batch_stats(expert(gen, k), x["noise"], x["cond"]) for k in range(e)]
        stats = {bn: {k: torch.stack([q[bn][k] for q in per]) for k in per[0][bn]} for bn in per[0]}
    return gen, router, stats


def build_engine(run, gen, router, stats):
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim

    cell = run.cell
    engine = FastSim(gen, router, batch_size=int(run.traffic["rows_per_call"]),
                     precision=cell["precision"], device=run.device,
                     cfg=load_config(run.port_overrides()),
                     gen_stats={"batch_stats": stats} if stats else None)
    # the engine sets its tile and dispatch form here only, a private method
    form = (int(cell["tile"]), bool(cell["dyn_dispatch"]))
    engine._build_switch(tile=form[0], dyn_dispatch=form[1])
    built = (getattr(engine, "_tile", None), getattr(engine, "_dyn", None))
    if built != form:  # the engine changed: time no other path than the cell states
        raise SystemExit(f"benchmark: the engine reports tile and dyn form {built}, "
                         f"the cell states {form}")
    return engine


class Calls:
    """The traffic's rows, drawn call by call, through the engine; kept rows
    gathered on the device."""

    def __init__(self, run, engine):
        self.run, self.engine = run, engine
        self.rows = int(run.traffic["rows_per_call"])
        self.gen = torch.Generator(device=run.device).manual_seed(seed_stream(run.seed, 3))
        self.pick = torch.Generator(device=run.device).manual_seed(seed_stream(run.seed, 4))
        self.keep_n = int(run.cell["check"]["keep_per_call"])
        self.kept: List[Dict[str, torch.Tensor]] = []

    def __call__(self, keep: bool) -> None:
        with tr.span("inputs"):
            x = draw(self.run.traffic["fields"], self.rows, self.gen, self.run.device,
                     self.run.settings)
        with tr.span("simulate_bulk"):
            imgs, ids = self.engine.simulate_bulk(x["cond"], noise=x["noise"],
                                                  return_experts=True)
        if keep:
            rows = torch.randperm(self.rows, generator=self.pick,
                                  device=self.run.device)[:self.keep_n]
            self.kept.append({"cond": x["cond"][rows], "noise": x["noise"][rows],
                              "ids": ids[rows], "imgs": imgs[rows]})


def drive(run) -> None:
    run.mark("imports done")
    gen, router, stats = make_weights(run)
    if run.device.type == "cuda":
        # the peak is the program's: from the weights, not the fit that made them
        torch.cuda.reset_peak_memory_stats(run.device)
    run.mark("weights made")
    engine = build_engine(run, gen, router, stats)
    run.mark("engine built")
    calls = Calls(run, engine)
    with torch.no_grad():
        for i in range(int(run.cell["warm_calls"])):
            calls(keep=False)
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
            run.mark(f"warm call {i + 1} done")
        if run.trace_on:
            run.prepare()
        if run.cell["dyn_dispatch"] and run.device.type == "cuda" and not engine._graphs:
            raise SystemExit("benchmark: the dyn form captured no CUDA graph in the warm calls")
        n = window(run, lambda: calls(keep=True), run.seconds)
        run.window["work"] = run.attempted = n * calls.rows
        if run.trace_on:
            n_trace = int(run.cell["trace_calls"])
            run.trace = tr.record(lambda: [calls(keep=False) for _ in range(n_trace)])
            run.trace_work = n_trace * calls.rows
    if run.device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(run.device)
    kept = {k: torch.cat([c[k] for c in calls.kept]) for k in calls.kept[0]}
    run.report["expert_shares"] = shares(kept["ids"], int(run.settings["model.n_experts"]))
    del engine, calls
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    run.extra["check_inputs"] = (kept, gen, router, stats)  # the control's too
    run.mark("window closed, engine freed")
    run.failed, run.checks = check(run, kept, gen, router, stats)
    run.mark(f"{kept['ids'].shape[0]} kept rows checked")


def reference_rows(run, kept, gen, router, stats, bits: Optional[int] = None,
                   per_tensor: bool = False):
    """The reference's ``(ids, logits, log-space showers)`` of the kept rows,
    each decoded by ``decode_ids`` where given (see :func:`check`), else by
    the reference's own routing, in blocks of ``block_rows`` rows of one
    expert; ``bits`` decodes on the control's grid, its step set per sample
    or over each block (``per_tensor``)."""
    ref = run.reference
    block = int(run.cell["check"]["block_rows"])
    with torch.no_grad(), ieee_f32():
        logits = ref.router(router, kept["cond"])
        ref_ids = logits.argmax(-1)
        dec = kept.get("decode_ids", ref_ids)
        out = None
        for e in range(int(run.settings["model.n_experts"])):
            sel = torch.nonzero(dec == e)[:, 0]
            p, st = expert(gen, e), expert(stats, e) if stats else None
            for i in range(0, sel.numel(), block):
                r = sel[i:i + block]
                y = ref.generator(p, kept["noise"][r], kept["cond"][r], st, bits=bits,
                                  per_tensor=per_tensor)
                if out is None:
                    out = y.new_zeros((dec.shape[0], *y.shape[1:]))
                out[r] = y
    return ref_ids, logits, out


def check(run, kept, gen, router, stats, control: str = ""):
    """``(rows judged wrong, [(name, value, limit)])`` of the kept rows; a
    sample of ``max_rows`` of them, drawn from the seed. ``control``
    ``"int4"``: the reference on a 4-bit grid stands in the program's place
    (the control), its activations' step set as the program sets its int8
    one (``control_grid``: per ``sample``, or per ``tensor`` of a decode's
    rows)."""
    c = run.cell["check"]
    n = kept["ids"].shape[0]
    pick = torch.Generator(device=run.device).manual_seed(seed_stream(run.seed, 5))
    rows = torch.randperm(n, generator=pick, device=run.device)[:int(c["max_rows"])]
    kept = {k: v[rows] for k, v in kept.items()}
    if control:
        bits = {"int4": 4}[control]
        ids, _, logs = reference_rows(run, kept, gen, router, stats, bits=bits,
                                      per_tensor=c["control_grid"] == "tensor")
        kept = {**kept, "ids": ids, "imgs": torch.expm1(logs)}
    ids = kept["ids"].long()
    # each row decoded by the expert the program chose: a wrong route counts
    # once, under route_mismatch
    ref_ids, logits, ref_log = reference_rows(run, {**kept, "decode_ids": ids}, gen, router,
                                              stats)
    gap_logit = logits.gather(1, ref_ids[:, None]) - logits.gather(1, ids[:, None])
    wrong_route = (ids != ref_ids) & (gap_logit[:, 0] > float(c["tie_logit_gap"]))
    port_log = torch.log1p(kept["imgs"].float())
    # each shower's gap relative to its own norm, or to the median shower's
    # where it is fainter: the int8 grid of a faint shower is set by others
    ref_norm = ref_log.flatten(1).norm(dim=1)
    gap = ((port_log - ref_log).flatten(1).norm(dim=1)
           / torch.maximum(ref_norm, ref_norm.median()).clamp_min(1e-12))
    numbers = {"route_mismatch": float(wrong_route.sum()), "shower_gap": float(gap.max()),
               "shower_gap_median": float(gap.median())}
    if "shower_gap_median_rel" in c["limits"]:
        # the median gap over the one that the reference on the stated int8
        # grid reads on the same rows: what the precision itself costs there
        _, _, ref8 = reference_rows(run, {**kept, "decode_ids": ids}, gen, router, stats, bits=8,
                                    per_tensor=c["control_grid"] == "tensor")
        gap8 = ((ref8 - ref_log).flatten(1).norm(dim=1)
                / torch.maximum(ref_norm, ref_norm.median()).clamp_min(1e-12))
        numbers["shower_gap_median_rel"] = float(gap.median() / gap8.median().clamp_min(1e-12))
    run.extra["numbers"] = numbers  # every number, compared or not (calibrate.py)
    lim = {k: float(v) for k, v in c["limits"].items()}  # the numbers this cell compares
    wrong = wrong_route | (gap > lim.get("shower_gap", float("inf")))
    medians_over = any(numbers[k] > lim[k] for k in ("shower_gap_median", "shower_gap_median_rel")
                       if k in lim)
    failed = gap.numel() if medians_over else int(wrong.sum())
    return failed, [(k, numbers[k], v) for k, v in lim.items()]
