"""Serving-time expert distillation (counterpart of ``zdcsim/inference/distill.py``).

Each student expert regresses its teacher expert's log-space output on
fresh ``(noise, cond)`` draws, weighted towards the conditions the router
sends it: per-pixel L2 plus a relative term on the 5-channel photon sums,
which the fidelity gate scores. The student's parameters take optax's
``adam(cosine_decay_schedule(lr, steps))`` (``train.state``); the teacher
and the router are frozen.

The student is a stacked generator as the train state holds one (a flat
``{state_dict name: [E, ...]}`` tree, run by ``MoEModules.generate``). The
teachers are built as the JAX experiment scripts build them
(:func:`proton_teacher`, :func:`module_teacher`): the bf16 serving forward,
cast to float32. Each inner step draws ``batch_size`` rows of the condition
pool and N(0, 1) noise from one ``torch.Generator``, or takes them as given
(``draws``: JAX's ``jax.random`` streams cannot be reproduced in torch, so
the tests hand the port the draws that JAX's step makes). The channel sums
stay plain PyTorch, as in JAX: they need a gradient.

The step runs inside the train step's :func:`f32_matmuls` and
:func:`deterministic`: no TF32, and two calls from one state are equal bit
for bit on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from zdcsim_torch.ops.channels import sum_channels
from zdcsim_torch.train.state import AdamState, adam_init, adam_update, cosine_decay_schedule
from zdcsim_torch.train.step import _grad, _leaves, deterministic, f32_matmuls

Tree = Dict[str, torch.Tensor]
Draws = Sequence[Tuple[torch.Tensor, torch.Tensor]]  # (rows [B], noise [B, Z]) per inner step


def distill_loss(s_out: torch.Tensor, t_out: torch.Tensor, idx: torch.Tensor,
                 sum_weight: float = 0.1, off_routed_weight: float = 0.1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss, pix, chsum)`` of the student's ``[E, B, H, W, 1]`` against the
    teacher's (``zdcsim/inference/distill.py:60-79``): each expert weighs the
    samples routed to it (``idx [B]``) 1 and the others
    ``off_routed_weight``, normalised over the batch; ``pix`` the weighted
    mean over H, W, C of the squared error, ``chsum`` of ``|ch_s - ch_t| /
    (|ch_t| + 10)`` on the linear-space channel sums, both averaged over
    the experts; ``loss = pix + sum_weight * chsum``."""
    e_count = t_out.shape[0]
    masks = F.one_hot(idx, e_count).to(s_out.dtype).T  # [E, B]
    wts = masks + off_routed_weight * (1.0 - masks)
    wts = wts / wts.sum(dim=1, keepdim=True)
    pix = ((s_out - t_out) ** 2).mean(dim=(2, 3, 4))  # [E, B]
    pix_loss = (wts * pix).sum() / e_count
    hw = t_out.shape[2:4]
    ch_t = sum_channels(torch.expm1(t_out[..., 0].reshape(-1, *hw)))
    ch_s = sum_channels(torch.expm1(s_out[..., 0].reshape(-1, *hw)))
    rel = ((ch_s - ch_t).abs() / (ch_t.abs() + 10.0)).mean(dim=-1).reshape(e_count, -1)
    sum_loss = (wts * rel).sum() / e_count
    return pix_loss + sum_weight * sum_loss, pix_loss, sum_loss


def draw_distill(generator: torch.Generator, n_pool: int, batch_size: int, noise_dim: int,
                 inner_steps: int, device) -> Draws:
    """One call's draws from ``generator`` (on ``device``): per inner step,
    ``batch_size`` rows of a pool of ``n_pool`` conditions (uniform, with
    replacement) and ``[batch_size, noise_dim]`` N(0, 1) noise."""
    return [(torch.randint(0, int(n_pool), (int(batch_size),), generator=generator,
                           device=device),
             torch.randn((int(batch_size), int(noise_dim)), generator=generator, device=device))
            for _ in range(int(inner_steps))]


def build_distill_step(student_apply: Callable, teacher_apply: Callable, router_apply: Callable,
                       schedule: Callable, noise_dim: int, *, sum_weight: float = 0.1,
                       off_routed_weight: float = 0.1, inner_steps: int = 25):
    """``step(params, opt_state, cond_pool, batch_size, generator=None,
    draws=None) -> (params, opt_state, metrics)``: ``inner_steps`` Adam
    updates at ``schedule(count)`` (``zdcsim/inference/distill.py:37``).

    Args:
        student_apply: ``(params, noise [B, Z], cond [B, C]) -> [E, B, H, W, 1]``.
        teacher_apply: ``(noise, cond) -> [E, B, H, W, 1]``, its weights
            closed over; run without a graph (its output is detached).
        router_apply: ``cond -> idx [B]``, the deterministic routing.
        schedule: the learning rate of the update count,
            :func:`zdcsim_torch.train.state.cosine_decay_schedule`.

    ``draws`` (one ``(rows, noise)`` per inner step) replaces the draws from
    ``generator`` (:func:`draw_distill`). The metrics are ``loss``, ``pix``
    and ``chsum`` of the last inner step, as detached scalars. The state
    passed in is left as it was.
    """

    def one(params: Tree, opt_state: AdamState, cond: torch.Tensor, noise: torch.Tensor):
        with torch.no_grad():
            t_out = teacher_apply(noise, cond)
            idx = router_apply(cond)
        leaves = _leaves(params)
        loss, pix, chsum = distill_loss(student_apply(leaves, noise, cond), t_out, idx,
                                        sum_weight, off_routed_weight)
        # optax reads the schedule at the count before the update
        params, opt_state = adam_update(schedule(opt_state.count), opt_state, params,
                                        _grad(loss, leaves))
        return params, opt_state, {"loss": loss.detach(), "pix": pix.detach(),
                                   "chsum": chsum.detach()}

    def step(params: Tree, opt_state: AdamState, cond_pool: torch.Tensor, batch_size: int,
             generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None):
        if draws is None:
            draws = draw_distill(generator, cond_pool.shape[0], batch_size, noise_dim,
                                 inner_steps, cond_pool.device)
        if len(draws) != inner_steps:
            raise ValueError(f"the step takes {inner_steps} draws, got {len(draws)}")
        metrics: Dict[str, torch.Tensor] = {}
        with f32_matmuls(), deterministic():
            for rows, noise in draws:
                params, opt_state, metrics = one(params, opt_state, cond_pool[rows], noise)
        return params, opt_state, metrics

    return step


def distill_generator(student, student_params: Tree, teacher_apply: Callable,
                      router_apply: Callable, cond_pool, generator: torch.Generator,
                      noise_dim: int, *, steps: int = 2000, batch_size: int = 256,
                      lr: float = 2e-3, inner_steps: int = 25, sum_weight: float = 0.1,
                      off_routed_weight: float = 0.1, log_every: int = 250,
                      logger: Optional[Callable[[str], Any]] = None
                      ) -> Tuple[Tree, Dict[str, float]]:
    """Train a width-scaled student against a frozen teacher
    (``zdcsim/inference/distill.py:111``): ``max(1, steps // inner_steps)``
    calls of :func:`build_distill_step` under cosine-decayed Adam, on draws
    from ``generator``. ``student`` runs the stacked student
    (``MoEModules.generate``); ``cond_pool`` sits on the student's device.
    Returns ``(student_params, final metrics as floats)``."""
    schedule = cosine_decay_schedule(lr, steps)
    step = build_distill_step(
        student.generate, teacher_apply, router_apply, schedule, noise_dim,
        sum_weight=sum_weight, off_routed_weight=off_routed_weight, inner_steps=inner_steps)
    device = next(iter(student_params.values())).device
    cond_pool = torch.as_tensor(cond_pool, dtype=torch.float32).to(device)
    params, opt_state, metrics = student_params, adam_init(student_params), {}
    n_calls = max(1, steps // inner_steps)
    for i in range(n_calls):
        params, opt_state, metrics = step(params, opt_state, cond_pool, batch_size, generator)
        if logger is not None and (i * inner_steps) % log_every < inner_steps:
            # one scalar readback per log line (a device sync point)
            logger(f"distill step {min((i + 1) * inner_steps, steps)}/{steps}: "
                   f"loss={float(metrics['loss']):.5f} pix={float(metrics['pix']):.5f} "
                   f"chsum={float(metrics['chsum']):.5f}")
    return params, {k: float(v) for k, v in metrics.items()}


# -- the teachers and the router, as the experiment scripts build them ----------


def proton_teacher(gen: Dict[str, Any], device, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """The proton teacher of ``experiments/distill_r4.py:146-155``: the bf16
    ``fast_generator_apply`` of each expert of the stacked Flax-layout tree
    ``gen`` (``convert.from_jax_params``), stacked and cast to float32
    (``dtype``: another compute dtype)."""
    from zdcsim_torch.convert import expert, tree_to_torch
    from zdcsim_torch.models.proton_fast import fast_generator_apply

    n = next(iter(gen["Conv_0"].values())).shape[0]
    experts = [tree_to_torch(expert(gen, e), dtype=dtype, device=device) for e in range(n)]

    def apply(noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        z, c = noise.to(dtype), cond.to(dtype)
        return torch.stack([fast_generator_apply(p, z, c) for p in experts]).to(torch.float32)

    return apply


def module_teacher(modules, params: Tree, stats: Optional[Tree] = None,
                   dtype: torch.dtype = torch.bfloat16) -> Callable:
    """A teacher run by its generator module in ``dtype``, cast to float32:
    the neutron teacher of ``experiments/distill_neutron_r4.py:172-181``
    (``GeneratorNeutron(norm="group")`` in bf16). ``params`` is the stacked
    PyTorch-layout tree (``convert.to_state_dict(..., stacked=True)``)."""
    p16 = {k: v.to(dtype) for k, v in params.items()}
    s16 = {k: v.to(dtype) for k, v in (stats or {}).items()}

    def apply(noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return modules.generate(p16, noise.to(dtype), cond.to(dtype), s16).to(torch.float32)

    return apply


def router_argmax(model_cfg, router_sd: Tree, device) -> Callable:
    """``cond -> argmax(logits)``: the float32 router that ``model_cfg``
    names, with the weights ``router_sd``."""
    from zdcsim_torch.models.router import build_router

    net = build_router(model_cfg).to(device)
    net.load_state_dict({k: v.to(device) for k, v in router_sd.items()})
    net.eval()

    def apply(cond: torch.Tensor) -> torch.Tensor:
        return torch.argmax(net(cond.to(torch.float32))[1], dim=-1)

    return apply
