"""Training: the step that ``zdcsim_torch.train.step.build_train_step`` builds
for the configuration (the dense f32 step: D, G with aux, EMA, router),
called step after step on the state it returns, each step on a fresh batch
and fresh draws of the traffic.

Set-up: the benchmark's trees from the seed (generator, discriminator and
its spectral-norm state, aux regressor, router; Adam's moments 0, the EMA
equal to the generator) handed to the port as its train state; then
``checked_steps`` steps through the window's own call and feed, which warm
every shape and are the steps the check follows. The window
(``harness/window.py``): steps from there until ``--seconds`` have passed;
``train_samples_per_s`` is batch x steps over the window's whole time. The
window's last step keeps its inputs, its losses and the state before it.

The check, once the window has closed and the port's state is freed: the
plain reference (``reference/<cell's reference>.py``) runs the checked
steps from the same trees on the same batches and draws, and
- ``loss_gap``: the largest gap of a step's ``gen_loss``, ``disc_loss`` or
  ``router_loss``, over that loss of the reference or the median of them,
  whichever is larger;
- ``grad_gap``: the first step's gradient as each optimizer got it (Adam's
  first moment after one step over ``1 - b1``), leaf by leaf: the gap
  between the port's norm and the reference's, over the reference's norm
  of that leaf or the component's median leaf, whichever is larger, worst
  leaf;
- ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient lies under ``grad_floor``
  of the component's median leaf (round-off alone moves them under Adam).
Then it runs the window's last step from the port's own state before it
(the state far past the checked steps: Adam's count and bias correction,
the EMA, the spectral-norm state, the router's moments), on that step's
batch and draws, and reads ``last_loss_gap``, ``last_grad_gap`` (the
gradient from the first moments before and after) and ``last_change_gap``
(each leaf's change in that step, the EMA's leaves with the generator's)
alike.
"""

from __future__ import annotations

import gc
from typing import Any, Dict

import torch

from harness import trace as tr
from harness.traffic import draw
from harness.weights import make_tree, seed_stream
from harness.window import window

COMPONENTS = ("gen", "disc", "aux", "router")
LOSSES = ("gen_loss", "disc_loss", "router_loss")
B1 = 0.9


def make_trees(run) -> Dict[str, Any]:
    from reference.proton import generator_leaves, router_tree_leaves

    ref, s, dev = run.reference, run.settings, run.device
    e = (int(s["model.n_experts"]),)
    return {"gen": make_tree(generator_leaves(s), seed_stream(run.seed, 0), dev, e),
            "router": make_tree(router_tree_leaves(s), seed_stream(run.seed, 1), dev),
            "disc": make_tree(ref.disc_leaves(s), seed_stream(run.seed, 2), dev, e),
            "disc_stats": make_tree(ref.disc_stats_leaves(s), seed_stream(run.seed, 3), dev, e),
            "aux": make_tree(ref.aux_leaves(s), seed_stream(run.seed, 4), dev, e)}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}|{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, v


def port_state(trees):
    """The port's ``MoETrainState`` of the benchmark's trees (copies)."""
    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.train.state import AdamState, Component, MoETrainState

    def comp(tree, stats=None, stacked=True):
        params = {k: v.clone() for k, v in to_state_dict(tree, stacked=stacked).items()}
        zero = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
        return Component(params=params, stats=dict(_flat(stats or {})),
                         opt_state=AdamState(count=zero, mu={k: torch.zeros_like(v) for k, v in params.items()},
                                             nu={k: torch.zeros_like(v) for k, v in params.items()}))

    gen = comp(trees["gen"])
    return MoETrainState(gen=gen, disc=comp(trees["disc"], {k: v.clone() for k, v in
                                                               _flat(trees["disc_stats"])}),
                         aux=comp(trees["aux"]), router=comp(trees["router"], stacked=False),
                         ema_gen_params={k: v.clone() for k, v in gen.params.items()},
                         step=torch.zeros((), dtype=torch.int32, device=gen.opt_state.count.device))


class Feed:
    """Each step's batch and draws from the traffic."""

    def __init__(self, run):
        self.run = run
        self.rows = int(run.traffic["rows_per_call"])
        self.gen = torch.Generator(device=run.device).manual_seed(seed_stream(run.seed, 5))

    def __call__(self):
        t, s, dev = self.run.traffic, self.run.settings, self.run.device
        batch = draw(t["fields"], self.rows, self.gen, dev, s)
        d = draw(t["draws"], self.rows, self.gen, dev, s)
        keep = tuple(d.pop(k) for k in sorted(k for k in list(d) if k.startswith("aux_keep_")))
        return batch, {**d, "aux_keep": keep, "gen_keep_1": (), "gen_keep_2": ()}


def drive(run) -> None:
    from zdcsim_torch.config import load_config
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train.step import build_train_step

    run.mark("imports done")
    trees = make_trees(run)
    run.mark("trees made")
    cfg = load_config(run.port_overrides())
    modules = build_moe(cfg)
    step = build_train_step(modules, cfg)
    state = port_state(trees)
    keep: Dict[str, Any] = {"p0": {c: dict(getattr(state, c).params) for c in COMPONENTS}}
    feed = Feed(run)
    n_check = int(run.cell["checked_steps"])
    inputs, losses = [], []
    for i in range(n_check):
        batch, draws = feed()
        state, metrics = step(state, batch, draws, 0)
        inputs.append((batch, draws))
        losses.append({k: float(metrics[k]) for k in LOSSES})
        if i == 0:
            keep["mu1"] = {c: dict(getattr(state, c).opt_state.mu) for c in COMPONENTS}
        run.mark(f"checked step {i + 1} done")
    keep["params"] = {c: dict(getattr(state, c).params) for c in COMPONENTS}
    if run.trace_on:
        run.prepare()
    cuda = run.device.type == "cuda"
    last: Dict[str, Any] = {}

    def one():
        nonlocal state
        last.clear()  # the state two steps back goes
        batch, draws = feed()
        before = state
        state, metrics = step(before, batch, draws, 0)
        last.update(before=before, inputs=(batch, draws), metrics=metrics)

    n = window(run, one, run.seconds)
    run.window["work"] = n * feed.rows
    run.attempted = n
    if not all(torch.isfinite(v).all() for v in state.gen.params.values()):
        run.failed = n
    # the last step's readings, and the state before it moved to the host:
    # the traced steps and the peak do not hold it on the card
    keep["last"] = {"inputs": last["inputs"],
                    "losses": {k: float(last["metrics"][k]) for k in LOSSES},
                    "norms": port_step_norms(last["before"], state, trees),
                    "state": to_host(ref_state(last["before"], trees, n_check + n - 1))}
    last.clear()
    if run.trace_on:
        n_trace = int(run.cell["trace_steps"])

        def traced():
            nonlocal state
            for _ in range(n_trace):
                with tr.span("feed"):
                    batch, draws = feed()
                with tr.span("train_step"):
                    state, _ = step(state, batch, draws, 0)

        run.trace = tr.record(traced)
        run.trace_work = n_trace * feed.rows
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(run.device)
    del state, step, modules
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run.mark("window closed, port state freed")
    run.extra["check_inputs"] = (trees, inputs, losses, keep)
    bad, run.checks = check(run, trees, inputs, losses, keep)
    run.failed += bad
    run.mark("checked steps compared")


def _port_by_flax(tree: Dict[str, torch.Tensor], ref_tree) -> Dict[tuple, torch.Tensor]:
    """The port's ``state_dict`` leaves keyed by the reference's Flax paths,
    as the port lays them out (a layout does not change a leaf's norm)."""
    from reference.proton_train import leaves

    out = {}
    for path, _ in leaves(ref_tree):
        *mods, leaf = path
        out[path] = tree[".".join(mods) + "." + {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)]
    return out


def _to_flax(tree: Dict[str, torch.Tensor], ref_tree, lead: int) -> Dict[str, Any]:
    """The port's ``state_dict`` as a tree in the reference's layout:
    kernels ``[out, in]`` -> ``[in, out]``, OIHW -> HWIO, after ``lead``
    stacked axes."""
    from reference.proton_train import leaves

    out: Dict[str, Any] = {}
    keep = tuple(range(lead))
    for (path, ref), t in zip(leaves(ref_tree), _port_by_flax(tree, ref_tree).values()):
        if path[-1] == "kernel":
            t = (t.transpose(-1, -2) if t.ndim - lead == 2
                 else t.permute(*keep, lead + 2, lead + 3, lead + 1, lead))
        if t.shape != ref.shape:
            raise ValueError(f"{path}: the port's leaf {tuple(t.shape)}, the reference's "
                             f"{tuple(ref.shape)}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def ref_state(state, trees, count: int) -> Dict[str, Any]:
    """The port's train state as the reference's step takes it, after
    ``count`` steps by the benchmark's own count (Adam's count, and the
    router's, which trains in every step of epoch 0)."""
    def comp(c):
        p, lead = getattr(state, c), int(c != "router")
        return {k: _to_flax(v, trees[c], lead) for k, v in
                (("params", p.params), ("mu", p.opt_state.mu), ("nu", p.opt_state.nu))}

    disc_stats: Dict[str, Any] = {}
    for key, v in state.disc.stats.items():
        *mods, leaf = key.split("|")
        node = disc_stats
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return {"gen": comp("gen"), "disc": {**comp("disc"), "stats": disc_stats},
            "aux": comp("aux"),
            "router": {**comp("router"), "count": count},
            "ema": _to_flax(state.ema_gen_params, trees["gen"], 1), "count": count}


def to_host(tree, device="cpu"):
    """``tree``'s tensors moved to ``device``; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _flax(tree) -> Dict[tuple, torch.Tensor]:
    from reference.proton_train import leaves

    return dict(leaves(tree))


def _grads(mu0, mu1) -> Dict[tuple, float]:
    """Each leaf's gradient norm as Adam got it, from its first moment
    before (``mu0``; ``None``: zero) and after: ``mu1 = b1 mu0 + (1 - b1) g``."""
    return {k: float((v if mu0 is None else v - B1 * mu0[k]).norm()) / (1 - B1)
            for k, v in mu1.items()}


def _changes(p0, p1) -> Dict[tuple, float]:
    """Each leaf's norm of its change from ``p0`` to ``p1``."""
    return {k: float((p1[k] - p0[k]).norm()) for k in p1}


def port_step_norms(before, after, trees) -> Dict[str, tuple]:
    """``{component: (gradient norms, change norms)}`` of one step of the
    port, leaves keyed by Flax paths; ``"ema"``: the EMA's changes (no
    gradient of its own)."""
    out = {}
    for c in COMPONENTS:
        b, a = getattr(before, c), getattr(after, c)
        mu0, mu1, p0, p1 = (_port_by_flax(t, trees[c]) for t in
                            (b.opt_state.mu, a.opt_state.mu, b.params, a.params))
        out[c] = (_grads(mu0, mu1), _changes(p0, p1))
    out["ema"] = ({}, _changes(*(_port_by_flax(t, trees["gen"]) for t in
                                 (before.ema_gen_params, after.ema_gen_params))))
    return out


def follow(run, st, inputs, tf32: bool = False, rows=None, ema: bool = False):
    """The reference's readings of ``inputs``' steps from its state ``st``
    (left as it is): ``(losses of each step, {component: (first step's
    gradient norms, changes' norms over all steps)})``, leaves keyed by Flax
    paths; ``ema``: the EMA's change too. ``tf32``: TF32 on (the control);
    ``rows``: each batch cut to its first rows, the mean taken over them (a
    fault)."""
    from reference.common import ieee_f32
    from reference.proton_train import step as ref_step

    st0, losses, mu1 = st, [], None
    b = torch.backends
    for i, (batch, draws) in enumerate(inputs):
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
            draws = {k: tuple(x[:, :rows] for x in v) if isinstance(v, tuple) else v[:rows]
                     for k, v in draws.items()}
        if tf32:
            saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
            b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = True, True
            try:
                st, m = ref_step(st, batch, draws, 0, run.settings)
            finally:
                b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved
        else:
            with ieee_f32():
                st, m = ref_step(st, batch, draws, 0, run.settings)
        losses.append(m)
        if i == 0:
            mu1 = {c: _flax(st[c]["mu"]) for c in COMPONENTS}
    norms = {c: (_grads(_flax(st0[c]["mu"]), mu1[c]),
                 _changes(_flax(st0[c]["params"]), _flax(st[c]["params"]))) for c in COMPONENTS}
    if ema:
        norms["ema"] = ({}, _changes(_flax(st0["ema"]), _flax(st["ema"])))
    return losses, norms


def _gap(port: Dict[tuple, float], ref: Dict[tuple, float]) -> float:
    """The worst leaf's gap of norms over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    if not ref:
        return 0.0
    med = sorted(ref.values())[len(ref) // 2]
    return max(abs(port[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


def compare(run, readings, ref, prefix: str = "") -> list:
    """``[(name, value, limit)]`` of ``readings`` against the reference's
    (each as :func:`follow` returns them), the names and limits under
    ``prefix``. The EMA's leaves count under the generator's floor."""
    c = run.cell["check"]
    (losses, norms), (r_losses, r_norms) = readings, ref
    # each loss's gap over its own size or the median loss's, whichever is
    # larger: a loss near zero (the generator's hinge) has no relative gap
    med_loss = sorted(abs(r[k]) for r in r_losses for k in r)[len(r_losses) * len(r_losses[0]) // 2]
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), med_loss, 1e-30)
                   for p, r in zip(losses, r_losses) for k in r)
    grad_gap = change_gap = 0.0
    for cn in r_norms:
        (g, d), (r_g, r_d) = norms[cn], r_norms[cn]
        r_gc = r_norms["gen" if cn == "ema" else cn][0]
        med = sorted(r_gc.values())[len(r_gc) // 2]
        moving = {k for k, v in r_gc.items() if v >= float(c["grad_floor"]) * med}
        grad_gap = max(grad_gap, _gap(g, r_g))
        change_gap = max(change_gap, _gap(d, {k: v for k, v in r_d.items() if k in moving}))
    lim = c["limits"]
    return [(prefix + n, v, float(lim[prefix + n])) for n, v in
            (("loss_gap", loss_gap), ("grad_gap", grad_gap), ("change_gap", change_gap))]


def _stand_in(run, st, inputs, control, ema=False):
    """What ``control`` (see :func:`check`) reads in the program's place on
    ``inputs``' steps from ``st``, beside the reference's readings."""
    ref = follow(run, st, inputs, ema=ema)
    if control == "tf32":
        return follow(run, st, inputs, tf32=True, ema=ema), ref
    if control == "half_batch":
        return follow(run, st, inputs, rows=inputs[0][0]["real"].shape[0] // 2, ema=ema), ref
    # "unchanged": nothing moves: every gradient and change 0
    return (ref[0], {c: ({k: 0.0 for k in g}, {k: 0.0 for k in d})
                     for c, (g, d) in ref[1].items()}), ref


def check(run, trees, inputs, losses, keep, control: str = "") -> tuple:
    """``(1 if any number is over its limit else 0, [(name, value, limit)])``.
    ``control``: what stands in the program's place, in the checked steps
    and in the window's last: ``"tf32"`` the reference with TF32 on,
    ``"half_batch"`` the reference on each batch's first half,
    ``"unchanged"`` a step that returns its state."""
    from reference.proton_train import init, tmap

    st = init(*(tmap(torch.clone, trees[k]) for k in ("gen", "disc", "disc_stats", "aux", "router")))
    last = keep["last"]
    st_last = to_host(last["state"], run.device)
    if control:
        first, ref = _stand_in(run, st, inputs, control)
        last_read, last_ref = _stand_in(run, st_last, [last["inputs"]], control, ema=True)
    else:
        first = (losses, {c: (_grads(None, _port_by_flax(keep["mu1"][c], trees[c])),
                              _changes(*(_port_by_flax(keep[k][c], trees[c])
                                         for k in ("p0", "params"))))
                          for c in COMPONENTS})
        ref = follow(run, st, inputs)
        last_read = ([last["losses"]], last["norms"])
        last_ref = follow(run, st_last, [last["inputs"]], ema=True)
    del st_last
    checks = compare(run, first, ref) + compare(run, last_read, last_ref, prefix="last_")
    run.extra["numbers"] = {n: v for n, v, _ in checks}  # calibrate.py's readings
    return int(any(v > lim for _, v, lim in checks)), checks
