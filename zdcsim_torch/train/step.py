"""The MoE-GAN train step, dense form (counterpart of the dense step of
``zdcsim/train/step.py:221-424``).

Every sample runs through every expert (parameters stacked on a leading
expert axis), and each expert's loss terms are masked means weighted by its
batch share ``w_e = B_e / B``. Per batch, in the JAX step's order:

1. router forward, Gumbel softmax at the epoch's temperature, argmax ->
   masks, ``w``, ``active = B_e > 1``;
2. discriminator hinge update on the frozen generator's fakes, masked to
   the active experts;
3. generator and aux-regressor update against the *updated* discriminator
   (hinge, SDI-GAN diversity, intensity and log-cosh aux terms); the
   discriminator's spectral-norm stats of these forwards are kept, re-masked;
4. EMA of the generator;
5. router update from the GAN, entropy, expert-distribution,
   differentiation and load-balancing terms, frozen from
   ``stop_router_training_epoch`` on.

The step draws nothing: the Gumbel noise, the two generator noises and the
aux regressor's dropout keep masks are inputs (:func:`draw_step_noise` makes
them from an explicit ``torch.Generator``), so the CPU tests hand the port
JAX's draws. ``precision="f32"`` runs with TF32 off in cuBLAS and cuDNN for
the duration of the step (``train_step.precision`` says so).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from zdcsim_torch.models import MoEModules
from zdcsim_torch.ops.losses import (
    adaptive_load_balancing_loss, alb_annealing_weight, differentiation_loss,
    expert_distribution_loss, expert_utilization_entropy, hinge_discriminator_loss,
    hinge_generator_loss, intensity_regularization, log_cosh_loss, sdi_gan_regularization,
    tau_schedule,
)
from zdcsim_torch.ops.routing import expert_masks, gumbel_noise
from zdcsim_torch.train.state import (
    Component, MoETrainState, ema_update, gated_update, make_optimizers, masked_expert_update,
)

Tree = Dict[str, torch.Tensor]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue 1 item {item}")


def check_options(cfg) -> None:
    """Raise ``NotImplementedError`` for every option this step does not
    port, naming its ``ROADMAP.md`` item; nothing is silently ignored."""
    t = cfg.train
    if cfg.model.architecture != "proton":
        raise _not_ported("training the neutron family", "6b")
    if str(t.dispatch) == "switch":
        raise _not_ported("train.dispatch=switch (the switch step)", "6a")
    if str(t.dispatch) != "dense":
        raise ValueError(f"train.dispatch must be dense|switch, got {t.dispatch!r}")
    if str(t.precision) == "bf16":
        raise _not_ported("train.precision=bf16", "6c")
    if str(t.precision) != "f32":
        raise ValueError(f"train.precision must be f32|bf16, got {t.precision!r}")
    if bool(t.remat):
        raise _not_ported("train.remat", "6c")
    if bool(t.fast_generator):
        raise _not_ported("train.fast_generator", "6c")


def _f32_knobs():
    """``(name, object, attribute, value)`` of PyTorch's float32 precision settings
    of cuBLAS and cuDNN convs that mean IEEE float32. Where PyTorch has the
    per-backend ``fp32_precision`` settings, they are set to ``"ieee"``: the
    legacy ``allow_tf32`` flags set them to ``"none"``, which is not IEEE on
    every path (cuDNN convs of channels-last inputs ran in TF32 on an H100
    with ``allow_tf32`` off)."""
    b = torch.backends
    if hasattr(getattr(b.cudnn, "conv", None), "fp32_precision"):
        return [("cuda.matmul.fp32_precision", b.cuda.matmul, "fp32_precision", "ieee"),
                ("cudnn.conv.fp32_precision", b.cudnn.conv, "fp32_precision", "ieee")]
    return [("cuda.matmul.allow_tf32", b.cuda.matmul, "allow_tf32", False),
            ("cudnn.allow_tf32", b.cudnn, "allow_tf32", False)]


@contextlib.contextmanager
def f32_matmuls():
    """cuBLAS and cuDNN in IEEE float32 (no TF32) inside the block."""
    knobs = _f32_knobs()
    saved = [getattr(obj, attr) for _, obj, attr, _ in knobs]
    for _, obj, attr, value in knobs:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for (_, obj, attr, _), value in zip(knobs, saved):
            setattr(obj, attr, value)


def _leaves(tree: Tree) -> Tree:
    """Fresh leaves that require grad, sharing storage with ``tree``."""
    return {k: v.detach().requires_grad_() for k, v in tree.items()}


def _grad(loss: torch.Tensor, leaves: Tree) -> Tree:
    """``d loss / d leaves``; zeros where the loss does not reach a leaf."""
    keys = [k for k in leaves]
    grads = (torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
             if loss.requires_grad else [None] * len(keys))
    return {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(keys, grads)}


def draw_step_noise(generator: torch.Generator, modules: MoEModules, batch_size: int,
                    device: str | torch.device | None = None) -> Dict[str, object]:
    """One step's random draws on ``device`` (CUDA unless the caller asks for
    the CPU) from ``generator`` (on that device): ``gumbel [B, E]``,
    ``noise_1``, ``noise_2 [B, noise_dim]`` (N(0, 1)) and ``aux_keep``, the
    aux regressor's dropout keep masks ``[E, B, *shape]`` (bool, kept with
    probability ``1 - rate``, as ``flax.linen.Dropout`` draws them)."""
    from zdcsim_torch.device import default_device

    dev = default_device(device)
    b, e = int(batch_size), modules.n_experts
    aux = modules.aux_reg
    return {
        "gumbel": gumbel_noise((b, e), generator, dev),
        "noise_1": torch.randn((b, modules.noise_dim), generator=generator, device=dev),
        "noise_2": torch.randn((b, modules.noise_dim), generator=generator, device=dev),
        "aux_keep": tuple(torch.rand((e, b, *shape), generator=generator, device=dev)
                          < 1.0 - aux.rate for shape in aux.dropout_shapes),
    }


def build_train_step(modules: MoEModules, cfg):
    """``train_step(state, batch, draws, epoch) -> (state, metrics)``.

    ``batch``: ``real [B, H, W, 1]``, ``cond [B, C]``, ``std [B, 1]``,
    ``intensity [B, 1]``, ``positions [B, 2]`` on the state's device;
    ``draws`` as :func:`draw_step_noise` returns them; ``epoch`` an int. The
    state passed in is left as it was; the metrics carry the JAX step's
    names (``zdcsim/train/step.py:401-421``), as detached tensors."""
    check_options(cfg)
    E = modules.n_experts
    mc, r = cfg.model, cfg.model.router
    di_strength = float(mc.generator.di_strength)
    in_strength = float(mc.generator.in_strength)
    aux_strength = float(mc.aux_reg.strength)
    gan_s, util_s, ed_s = float(r.gan_strength), float(r.util_strength), float(r.ed_strength)
    diff_s, alb_s = float(r.diff_strength), float(r.alb_strength)
    taus = float(r.tau_start), float(r.tau_min), float(r.tau_decay)
    stop_epoch = r.stop_router_training_epoch
    alpha, min_weight = int(r.alpha), float(r.min_weight)
    differentiable_gan = bool(r.differentiable_gan_term)
    sdi_quirk = bool(mc.generator.sdi_pairwise_quirk)
    ema_decay = float(cfg.train.ema_decay)
    lrs = make_optimizers(cfg)

    def per_expert(fn, *args):
        return torch.stack([fn(*(a[e] for a in args)) for e in range(E)])

    def router_step(state, cond, gumbel, tau, idx, epoch, fake_scores, gen_loss_e, sums_routed,
                    mean_int_e):
        zero = torch.zeros((), device=cond.device)
        if E == 1:
            return state.router, zero, dict(gan=zero, entropy=zero, ed=zero, diff=zero, alb=zero)
        r_params = _leaves(state.router.params)
        soft_r = torch.softmax((modules.route(r_params, cond) + gumbel) / tau, dim=-1)
        hard = torch.nn.functional.one_hot(idx, E).to(soft_r.dtype)
        gates_st = hard + soft_r - soft_r.detach()
        if differentiable_gan:  # ST-gate-weighted per-sample hinge: reaches the router
            gan = (gates_st.T * (-fake_scores)).sum(dim=0).mean() * gan_s
        else:  # the reference's constant term
            gan = gen_loss_e.mean() * gan_s
        terms = dict(
            gan=gan,
            entropy=-expert_utilization_entropy(soft_r, util_s) if util_s != 0.0 else zero,
            ed=(expert_distribution_loss(gates_st, sums_routed[:, None]) * ed_s
                if ed_s != 0.0 else zero),
            diff=-differentiation_loss(mean_int_e) * diff_s if diff_s != 0.0 else zero,
            alb=(adaptive_load_balancing_loss(soft_r.sum(dim=0), alb_s)
                 if alb_s != 0.0 else zero),
        )
        decreasing_w = alb_annealing_weight(epoch, alpha, min_weight).to(cond.device)
        loss = (terms["ed"] + terms["gan"] + terms["diff"] + terms["entropy"]
                + decreasing_w * terms["alb"])
        enabled = stop_epoch is None or int(epoch) < int(stop_epoch)
        router = gated_update(lrs["router"], state.router, _grad(loss, r_params), enabled)
        return router, loss.detach() if enabled else zero, {k: v.detach() for k, v in
                                                             terms.items()}

    def step(state: MoETrainState, batch: Tree, draws, epoch: int
             ) -> Tuple[MoETrainState, Tree]:
        real, cond, std = batch["real"], batch["cond"], batch["std"]
        intensity, positions = batch["intensity"], batch["positions"]
        noise_1, noise_2, gumbel = draws["noise_1"], draws["noise_2"], draws["gumbel"]
        B = real.shape[0]
        tau = tau_schedule(epoch, *taus).to(real.device)

        # ------ routing ------
        with torch.no_grad():
            logits = modules.route(state.router.params, cond)
            idx = torch.argmax(torch.softmax((logits + gumbel) / tau, dim=-1), dim=-1)
            masks = expert_masks(idx, E)  # [E, B]
            counts = masks.sum(dim=1)
            w = counts / B
            active = counts > 1.0  # experts of <= 1 sample skip training
            active_f = active.to(torch.float32)
            fake_1 = modules.generate(state.gen.params, noise_1, cond)  # [E, B, H, W, 1]

        # ------ discriminator update ------
        d_params = _leaves(state.disc.params)
        real_scores, _, st1 = modules.discriminate(d_params, state.disc.stats,
                                                   real.expand(E, *real.shape), cond)
        fake_scores, _, st2 = modules.discriminate(d_params, st1, fake_1, cond)
        disc_loss_e = per_expert(hinge_discriminator_loss, real_scores[..., 0],
                                 fake_scores[..., 0], masks) * w * active_f
        disc_new = masked_expert_update(lrs["disc"], state.disc,
                                        _grad(disc_loss_e.sum(), d_params), active,
                                        new_stats=st2)

        # ------ generator + aux update against the updated discriminator ------
        g_params, a_params = _leaves(state.gen.params), _leaves(state.aux.params)
        fake1 = modules.generate(g_params, noise_1, cond)
        fake2 = modules.generate(g_params, noise_2, cond)
        s1, l1, dst1 = modules.discriminate(disc_new.params, disc_new.stats, fake1, cond)
        s2, l2, dst2 = modules.discriminate(disc_new.params, dst1, fake2, cond)
        hinge_e = per_expert(hinge_generator_loss, s1[..., 0], masks)
        div_e = per_expert(
            lambda a, b, m: sdi_gan_regularization(a, b, noise_1, noise_2, std, di_strength,
                                                   m, sdi_quirk), l1, l2, masks)
        ints = [intensity_regularization(fake1[e], intensity, in_strength, masks[e])
                for e in range(E)]
        int_loss_e, sums1, std_int_e, mean_int_e = (torch.stack(t) for t in zip(*ints))
        aux_pred = modules.regress(a_params, fake1, draws["aux_keep"])  # [E, B, 2]
        aux_loss_e = per_expert(lambda p, m: log_cosh_loss(positions, p, m),
                                aux_pred, masks) * aux_strength
        gen_total_e = (hinge_e + div_e + int_loss_e + aux_loss_e) * w * active_f
        grads = _grad(gen_total_e.sum(), {**{("g", k): v for k, v in g_params.items()},
                                           **{("a", k): v for k, v in a_params.items()}})
        gen_new = masked_expert_update(lrs["gen"], state.gen,
                                       {k: grads[("g", k)] for k in g_params}, active)
        aux_new = masked_expert_update(lrs["aux"], state.aux,
                                       {k: grads[("a", k)] for k in a_params}, active)
        # the G step's discriminator forwards advance the power iteration too
        e_shape = lambda v: active.reshape((E,) + (1,) * (v.ndim - 1))  # noqa: E731
        disc_new = Component(
            params=disc_new.params,
            stats={k: torch.where(e_shape(v), v, disc_new.stats[k]) for k, v in dst2.items()},
            opt_state=disc_new.opt_state)
        ema = ema_update(state.ema_gen_params, gen_new.params, ema_decay)

        # ------ router update ------
        sums_routed = sums1.detach()[idx, torch.arange(B, device=idx.device)]
        mean_int_det = mean_int_e.detach() * active_f
        gen_loss_det = gen_total_e.detach()
        router_new, router_loss, raux = router_step(
            state, cond, gumbel, tau, idx, epoch, s1.detach()[..., 0], gen_loss_det,
            sums_routed, mean_int_det)

        new_state = MoETrainState(gen=gen_new, disc=disc_new, aux=aux_new, router=router_new,
                                  ema_gen_params=ema, step=state.step + 1)
        zero_inactive = lambda x: torch.where(active, x.detach(), 0.0)  # noqa: E731
        metrics = {
            "gen_loss": gen_loss_det.mean(),
            "disc_loss": disc_loss_e.detach().mean(),
            "div_loss": zero_inactive(div_e).mean(),
            "intensity_loss": zero_inactive(int_loss_e).mean(),
            "aux_reg_loss": zero_inactive(aux_loss_e).mean(),
            "router_loss": router_loss,
            "expert_distribution_loss": raux["ed"],
            "differentiation_loss": -raux["diff"],
            "expert_entropy_loss": raux["entropy"],
            "adaptive_load_balancing_loss": raux["alb"],
            "gan_loss": raux["gan"],
            "tau": tau,
            "gen_loss_experts": gen_loss_det,
            "disc_loss_experts": disc_loss_e.detach(),
            "div_loss_experts": zero_inactive(div_e),
            "intensity_loss_experts": zero_inactive(int_loss_e),
            "aux_reg_loss_experts": zero_inactive(aux_loss_e),
            "std_intensities_experts": zero_inactive(std_int_e),
            "mean_intensities_experts": mean_int_det,
            "n_choosen_experts_mean_epoch": w,
        }
        return new_state, metrics

    def train_step(state: MoETrainState, batch: Tree, draws, epoch: int):
        with f32_matmuls():
            return step(state, batch, draws, epoch)

    train_step.precision = {"train.precision": "f32",
                            **{name: value for name, _, _, value in _f32_knobs()}}
    return train_step
