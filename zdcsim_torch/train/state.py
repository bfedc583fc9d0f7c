"""Train state and expert-masked optimizer updates (counterpart of
``zdcsim/train/state.py``).

Each component's per-expert parameters live stacked on a leading ``[E,
...]`` axis of one flat tree (``{state_dict name: tensor}``, PyTorch
layout), with one Adam state; its stats (the discriminator's spectral-norm
``u`` and ``sigma``, the neutron ``norm=batch`` generator's and aux
regressor's BatchNorm ``mean`` and ``var``) are a flat tree keyed by Flax's
``batch_stats`` paths joined by ``|``. Adam is a plain function on
``(count, mu, nu)`` with optax's arithmetic, so optax's state maps onto it
leaf for leaf (``zdcsim_torch.convert``), and the per-expert mask selects
parameters, moments and stats. The count is one scalar shared by the experts that always
advances, as optax's.

Every function returns new tensors and leaves its inputs as they are.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from zdcsim_torch.models import MoEModules
from zdcsim_torch.models.layers import MaskedBatchNorm, _SpectralNorm

Tree = Dict[str, torch.Tensor]
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam as make_optimizers builds it


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: ``count`` int32 scalar, ``mu``/``nu`` like
    the parameters."""

    count: torch.Tensor
    mu: Tree
    nu: Tree


@dataclass
class Component:
    """One model component: parameters, stats, optimizer state."""

    params: Tree
    stats: Tree
    opt_state: AdamState


@dataclass
class MoETrainState:
    gen: Component
    disc: Component
    aux: Component
    router: Component
    ema_gen_params: Tree  # shadow generator weights
    step: torch.Tensor  # int32 scalar

    def to(self, device: str | torch.device | None = None,
           dtype: Optional[torch.dtype] = None) -> "MoETrainState":
        """A copy on ``device`` with its floating-point tensors in ``dtype``
        (``None``: as they are); ``count`` and ``step`` stay int32."""
        return _to(self, device, dtype)


def _to(x: Any, device, dtype) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype if x.is_floating_point() else None)
    if isinstance(x, dict):
        return {k: _to(v, device, dtype) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), device, dtype)
                                     for f in dataclasses.fields(x)})


def make_optimizers(cfg) -> Dict[str, float]:
    """The learning rate of each component's Adam (``b1=0.9``, ``b2=0.999``,
    ``eps=1e-8``)."""
    m = cfg.model
    return {"gen": float(m.generator.lr_g), "disc": float(m.discriminator.lr_d),
            "aux": float(m.aux_reg.lr_a), "router": float(m.router.lr_r)}


def adam_init(params: Tree) -> AdamState:
    device = next(iter(params.values())).device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def adam_update(lr: float, state: AdamState, params: Tree, grads: Tree):
    """optax ``adam(lr)`` then ``apply_updates``: returns ``(new params, new
    state)``. ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2`` (as
    ``lerp``), bias-corrected at ``count + 1`` in float32, ``p - lr mu_hat /
    (sqrt(nu_hat) + eps)``: optax's formula, in fewer passes over memory."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.tensor(B1, dtype=torch.float32, device=c.device) ** c
    bc2 = 1 - torch.tensor(B2, dtype=torch.float32, device=c.device) ** c
    new_p, mu, nu = {}, {}, {}
    for k, g in grads.items():
        mu[k] = torch.lerp(state.mu[k], g, 1 - B1)
        nu[k] = torch.lerp(state.nu[k], g * g, 1 - B2)
        denom = (nu[k] / bc2).sqrt_().add_(ADAM_EPS)
        new_p[k] = torch.addcdiv(params[k], mu[k] * (-lr / bc1), denom)
    return new_p, AdamState(count=count, mu=mu, nu=nu)


def _where_expert(active: torch.Tensor, new: Tree, old: Tree) -> Tree:
    """Per leaf: ``old`` for the experts where ``active`` is False."""
    e = active.shape[0]
    return {k: torch.where(active.reshape((e,) + (1,) * (v.ndim - 1)), v, old[k])
            for k, v in new.items()}


def masked_expert_update(lr: float, comp: Component, grads: Tree, active: torch.Tensor,
                         new_stats: Optional[Tree] = None) -> Component:
    """Adam applied to the active experts only (``active``: ``[E]`` bool);
    inactive experts keep parameters, moments and stats; the count advances.
    ``new_stats`` replaces the stats, masked the same way."""
    params, opt = adam_update(lr, comp.opt_state, comp.params, grads)
    stats = comp.stats if new_stats is None else _where_expert(active, new_stats, comp.stats)
    return Component(
        params=_where_expert(active, params, comp.params), stats=stats,
        opt_state=AdamState(count=opt.count,
                            mu=_where_expert(active, opt.mu, comp.opt_state.mu),
                            nu=_where_expert(active, opt.nu, comp.opt_state.nu)))


def gated_update(lr: float, comp: Component, grads: Tree, enabled: bool) -> Component:
    """Adam gated by one flag (the router's ``stop_router_training_epoch``):
    when it is off, parameters and the whole optimizer state, count included,
    stay as they were."""
    if not enabled:
        return comp
    params, opt = adam_update(lr, comp.opt_state, comp.params, grads)
    return Component(params=params, stats=comp.stats, opt_state=opt)


def ema_update(ema_params: Tree, new_params: Tree, decay: float) -> Tree:
    """``ema = decay * ema + (1 - decay) * new``."""
    return {k: decay * e + (1.0 - decay) * new_params[k] for k, e in ema_params.items()}


def _lecun_normal(shape, fan_in: int, generator: torch.Generator, device) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated to [-2, 2] (drawn as
    ``jax.random.truncated_normal`` draws it, through the inverse error
    function of a uniform), scaled to variance ``1 / fan_in``."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi,
                                                                       generator=generator)
    x = torch.clamp(math.sqrt(2) * torch.erfinv(u), -2.0, 2.0)
    return x * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def _init_params(module: torch.nn.Module, n_experts: Optional[int],
                 generator: torch.Generator, device) -> Tree:
    """Flax's initialisers on ``module``'s parameter shapes, stacked on a
    leading ``[n_experts]`` axis (``None``: unstacked): kernels
    ``lecun_normal`` (fan-in: every axis but the output's), biases zeros,
    norm scales ones."""
    lead = () if n_experts is None else (n_experts,)
    out = {}
    for name, p in module.named_parameters():
        shape = lead + tuple(p.shape)
        if name.endswith(".weight") and p.ndim >= 2:
            out[name] = _lecun_normal(shape, math.prod(p.shape[1:]), generator, device)
        elif name.endswith(".weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _init_stats(module: torch.nn.Module, n_experts: int, generator: torch.Generator,
                device) -> Tree:
    """Flax's initial ``batch_stats``, stacked on a leading ``[E]`` axis: each
    spectral-norm layer's ``u ~ N(0, 1)`` of shape ``[E, 1, out]`` and
    ``sigma = 1`` of shape ``[E]``; each ``MaskedBatchNorm``'s ``mean`` 0 and
    ``var`` 1 of shape ``[E, features]``."""
    out = {}
    for path, m in module.named_modules():
        if isinstance(m, _SpectralNorm):
            ku, ks = m.stats_keys()
            n_out = getattr(m, m.inner).weight.shape[0]
            out[ku] = torch.randn((n_experts, 1, n_out), generator=generator, device=device)
            out[ks] = torch.ones((n_experts,), device=device)
        elif isinstance(m, MaskedBatchNorm):
            shape, key = (n_experts, m.weight.shape[0]), path.replace(".", "|")
            out[f"{key}|mean"] = torch.zeros(shape, device=device)
            out[f"{key}|var"] = torch.ones(shape, device=device)
    return out


def init_state(modules: MoEModules, cfg, seed: int = 0,
               device: str | torch.device | None = None) -> MoETrainState:
    """All four components and their optimizers, on ``device`` (CUDA unless
    the caller asks for the CPU), from ``seed``. The draws are not JAX's:
    the JAX state is carried across by ``zdcsim_torch.convert``."""
    from zdcsim_torch.device import default_device

    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    e = modules.n_experts

    def comp(params, stats):
        return Component(params=params, stats=stats, opt_state=adam_init(params))

    gen_params = _init_params(modules.generator, e, gen, dev)
    return MoETrainState(
        gen=comp(gen_params, _init_stats(modules.generator, e, gen, dev)),
        disc=comp(_init_params(modules.discriminator, e, gen, dev),
                  _init_stats(modules.discriminator, e, gen, dev)),
        aux=comp(_init_params(modules.aux_reg, e, gen, dev),
                 _init_stats(modules.aux_reg, e, gen, dev)),
        router=comp(_init_params(modules.router, None, gen, dev), {}),
        ema_gen_params={k: v.clone() for k, v in gen_params.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev))
