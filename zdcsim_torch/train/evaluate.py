"""Evaluation of the train state: routed generation and the 5-channel
Wasserstein distance (counterpart of ``zdcsim/train/evaluate.py``).

Route the test conditions (argmax of the router's logits, Gumbel-perturbed
with ``eval.sample_routing``), generate each test shower with its routed
expert ``n_calc = min(epoch // 5 + 1, 5)`` times, take the 5 ZDC channel
sums of the generated and the real showers, and report the mean and std
over the runs of the channel-averaged W1, overall and per expert, beside
the scale-normalised ``ws_mean_rel``, the real-vs-real floor of two seeded
random halves, the routing counts and, given expert labels, the router's
classification metrics. As in JAX the router and the generator are the
state's parameters, not the EMA.

Per chunk of ``eval.chunk_size`` conditions (the last padded with repeats
of the first rows, the sums trimmed back) the generation runs the tiled
switch dispatch (``zdcsim_torch/inference/switch_dispatch.py``) at tile
``gcd(chunk, 64)``, or every expert then the routed gather where that tile
is under 2. ``eval.fused_epilogue`` takes the channel sums of the log-space
showers through kernel E (``zdcsim_torch/ops/epilogue_kernels.py``; on a
CPU tensor its plain version), else ``sum_channels(expm1(x))``. JAX's
``eval.bulk`` chooses between one XLA program and per-chunk dispatch, which
give equal results; PyTorch runs eagerly, so both are this one path.

The draws come from a ``torch.Generator`` on the state's device: the
routing's Gumbel noise ``[n, E]`` first (with ``eval.sample_routing``),
then the noise ``[n_calc, n, noise_dim]``, ``n`` the padded count. Either
may be passed in instead (the tests pass JAX's).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from zdcsim_torch.inference.switch_dispatch import tiled_switch_decode
from zdcsim_torch.models import MoEModules, expert_slices
from zdcsim_torch.ops.channels import sum_channels
from zdcsim_torch.ops.epilogue_kernels import expm1_channel_sums
from zdcsim_torch.ops.routing import gumbel_noise
from zdcsim_torch.ops.ws import masked_wasserstein_1d, wasserstein_per_channel
from zdcsim_torch.train.step import f32_matmuls


def _decode(module: torch.nn.Module, params, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One expert's log-space showers ``[T, H, W]``."""
    return functional_call(module, params, (z, c))[..., 0]


def _pad_rows(x: torch.Tensor, n_true: int, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` rows appended, repeats of its first rows."""
    reps = int(np.ceil(pad / n_true))
    return torch.cat([x] + [x[: max(1, pad)]] * reps)[: n_true + pad]


def build_evaluator(modules: MoEModules, cfg, chunk_size: Optional[int] = None):
    """``evaluate(state, test_arrays, epoch, generator=None,
    expert_labels=None, noise=None, gumbel=None) -> metrics``."""
    E = modules.n_experts
    noise_dim = modules.noise_dim
    h_img, w_img = modules.image_shape
    chunk_size = int(cfg.eval.chunk_size if chunk_size is None else chunk_size)
    sample_routing = bool(cfg.eval.sample_routing)
    fused_epilogue = bool(cfg.eval.fused_epilogue)

    def channels_of_log(img_log: torch.Tensor) -> torch.Tensor:
        """``[B, H, W]`` log-space showers -> ``[B, 5]`` linear channel sums."""
        if fused_epilogue:
            return expm1_channel_sums(img_log)
        return sum_channels(torch.expm1(img_log))

    def gen_chunk(params, experts, cond, idx, noise):
        b = cond.shape[0]
        tile = math.gcd(b, 64)
        if tile >= 2:
            decoders = [functools.partial(_decode, modules.generator, p) for p in experts]
            sel = tiled_switch_decode(decoders, idx, cond, noise, (h_img, w_img), tile=tile)
        else:  # every expert, then the routed gather
            imgs = modules.generate(params, noise, cond)  # [E, B, H, W, 1]
            sel = imgs[idx, torch.arange(b, device=idx.device), ..., 0]
        return channels_of_log(sel)

    def ws_all(ch_org, ch_gen, idx):
        """Overall per-channel W1 ``[5]`` and per-expert masked W1 ``[E, 5]``."""
        overall = wasserstein_per_channel(ch_org, ch_gen)
        per_exp = []
        for e in range(E):
            mask = (idx == e).to(torch.float32)
            per_exp.append(torch.stack([masked_wasserstein_1d(ch_org[:, k], mask,
                                                              ch_gen[:, k], mask)
                                        for k in range(ch_org.shape[1])]))
        return overall, torch.stack(per_exp)

    @torch.no_grad()
    def evaluate(state, test_arrays: Dict[str, object], epoch: int,
                 generator: Optional[torch.Generator] = None, expert_labels=None,
                 noise: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None):
        """``test_arrays``: ``cond [N, C]`` and ``real [N, H, W(, 1)]`` log-space
        showers (tensors or arrays); ``expert_labels``: optional ``[N]``
        expert assignments to score the routing against."""
        dev = next(iter(state.router.params.values())).device
        cond = torch.as_tensor(test_arrays["cond"]).to(dev, torch.float32)
        real = torch.as_tensor(test_arrays["real"]).to(dev)
        if real.ndim == 4:
            real = real[..., 0]
        n_true = cond.shape[0]
        # pad the last chunk up to chunk_size, so the W1 covers every test shower
        if n_true > chunk_size and n_true % chunk_size != 0:
            pad = chunk_size - (n_true % chunk_size)
            cond, real = _pad_rows(cond, n_true, pad), _pad_rows(real, n_true, pad)
        n = cond.shape[0]
        n_calc = int(min(epoch // 5 + 1, 5))
        chunks = max(1, n // chunk_size) if n >= chunk_size else 1
        csize = n // chunks
        if sample_routing and gumbel is None:
            gumbel = gumbel_noise((n, E), generator, dev)
        if noise is None:
            noise = torch.randn((n_calc, n, noise_dim), generator=generator, device=dev)
        noise = torch.as_tensor(noise).to(dev, torch.float32)
        if noise.shape != (n_calc, n, noise_dim):
            raise ValueError(f"noise must be [{n_calc}, {n}, {noise_dim}], got "
                             f"{tuple(noise.shape)}")
        if sample_routing:
            gumbel = torch.as_tensor(gumbel).to(dev, torch.float32)
            if gumbel.shape != (n, E):
                raise ValueError(f"gumbel must be [{n}, {E}], got {tuple(gumbel.shape)}")

        r_params, g_params = state.router.params, state.gen.params
        experts = expert_slices(g_params, E)
        slices = [slice(c * csize, (c + 1) * csize) for c in range(chunks)]
        with f32_matmuls():
            idx_parts, org_parts = [], []
            for sl in slices:
                logits = modules.route(r_params, cond[sl])
                if sample_routing:
                    logits = logits + gumbel[sl]
                idx_parts.append(torch.argmax(logits, dim=-1))
                org_parts.append(channels_of_log(real[sl]))
            idx = torch.cat(idx_parts)
            idx_true = idx[:n_true]
            ch_org = torch.cat(org_parts)[:n_true]
            ws_runs, ws_exp_runs = [], []
            for j in range(n_calc):
                ch_gen = torch.cat([gen_chunk(g_params, experts, cond[sl], idx[sl], noise[j, sl])
                                    for sl in slices])[:n_true]
                overall, per_exp = ws_all(ch_org, ch_gen, idx_true)
                ws_runs.append(overall)
                ws_exp_runs.append(per_exp)

        ws_runs = torch.stack(ws_runs).cpu().numpy()  # [n_calc, 5]
        ws_exp_runs = torch.stack(ws_exp_runs).cpu().numpy()  # [n_calc, E, 5]
        ws_by_run = ws_runs.mean(axis=1)
        ws_exp_by_run = ws_exp_runs.mean(axis=2)
        counts = (idx_true[None, :] == torch.arange(E, device=dev)[:, None]).sum(1).cpu().numpy()
        # scale-normalised fidelity, and the finite-sample floor: W1 between
        # two seeded random halves of the real showers
        scale = float(ch_org.mean())
        half = n_true // 2
        if half >= 8:
            perm = torch.as_tensor(np.random.default_rng(0).permutation(n_true), device=dev)
            ch_perm = ch_org[perm]
            floor = float(wasserstein_per_channel(ch_perm[:half], ch_perm[half: 2 * half]).mean())
        else:
            floor = float("nan")
        metrics = {
            "ws_mean": float(ws_by_run.mean()),
            "ws_std": float(ws_by_run.std()),
            "ws_mean_exp": ws_exp_by_run.mean(axis=0),
            "ws_std_exp": ws_exp_by_run.std(axis=0),
            "ws_mean_rel": float(ws_by_run.mean()) / scale if scale > 0 else float("nan"),
            "ws_real_floor": floor,
            "eval_expert_counts": counts,
            "epoch": epoch,
        }
        if expert_labels is not None and len(np.unique(np.asarray(expert_labels)[:n_true])) > 1:
            from zdcsim_torch.evals.router_metrics import router_classification_metrics

            cls = router_classification_metrics(
                idx_true.cpu().numpy(), np.asarray(expert_labels)[:n_true], E)
            metrics.update({f"router_{k}": v for k, v in cls.items()})
        return metrics

    return evaluate
