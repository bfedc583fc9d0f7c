"""The MoE-GAN train step (counterpart of ``zdcsim/train/step.py``): the dense
form (``:221-424``) and the switch form (``train.dispatch=switch``,
``:514-763``).

Dense: every sample runs through every expert (parameters stacked on a
leading expert axis), and each expert's loss terms are masked means weighted
by its batch share ``w_e = B_e / B``. Per batch, in the JAX step's order:

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

Switch (``E > 1``): each sample runs through its routed expert only, in
chunks of ``train.dispatch_tile`` (``tiled_switch_apply``; each chunk's
forward checkpointed with ``train.dispatch_remat``), at about 1/E of the
dense step's generator, discriminator and aux work. The losses take the
routed ``[B]`` arrays under each expert's mask, so they equal the dense
step's up to rounding. As in JAX: the router's GAN term is the constant
one (the differentiable one needs every expert's score of every sample);
the chunk forwards read the spectral-norm ``u`` without advancing it, and
one dense forward of one sample over every expert advances it after the D
update and again after the G update (re-masked); the G phase scores with
the updated discriminator's parameters and the old stats.

The step draws nothing: the Gumbel noise, the two generator noises and the
aux regressor's dropout keep masks are inputs (:func:`draw_step_noise` makes
them from an explicit ``torch.Generator``), so the CPU tests hand the port
JAX's draws. The dense step takes one keep mask per (expert, row), the
switch step one per row (JAX draws per (expert, chunk); each row's lane is
what matters).

Options (``zdcsim/train/step.py:147-219``): ``train.precision=bf16`` casts
the floating parameters and inputs of the generator and the aux regressor
to bfloat16 at each use, their outputs back; gradients reach the float32
master weights through the casts, and losses, Adam and EMA stay float32;
the router is not cast. JAX's discriminator promotes each spectral-norm
kernel to float32 through its float32 ``u`` (``flax.linen.SpectralNorm``)
and every later op with it, so its bf16 forward is the float32 forward on
bfloat16-rounded parameters and inputs, and so it is here.
``train.remat`` checkpoints the dense step's G, D and aux forwards
(``torch.utils.checkpoint``, non-reentrant). ``train.fast_generator``
runs the proton generator's FLOP-reduced forward
(``proton_fast.fast_generator_apply(train=True)``) on a differentiable
Flax-layout view of its parameters.

The step runs inside :func:`f32_matmuls` (IEEE float32 in cuBLAS and cuDNN,
no TF32; bfloat16 work is unaffected) and :func:`deterministic` (cuDNN's
deterministic algorithms), each restored after the step: two steps from one
state on one set of draws are equal bit for bit (``train_step.precision``
lists the settings).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from zdcsim_torch.convert import flax_view
from zdcsim_torch.inference.switch_dispatch import tiled_switch_apply
from zdcsim_torch.models import MoEModules, expert_slices
from zdcsim_torch.models.proton_fast import fast_generator_apply
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
    """Raise for what this step does not run: ``NotImplementedError`` naming
    its ``ROADMAP.md`` item for the neutron family, ``ValueError`` for an
    unknown dispatch or precision."""
    t = cfg.train
    if cfg.model.architecture != "proton":
        raise _not_ported("training the neutron family", "6b")
    if str(t.dispatch) not in ("dense", "switch"):
        raise ValueError(f"train.dispatch must be dense|switch, got {t.dispatch!r}")
    if str(t.precision) not in ("f32", "bf16"):
        raise ValueError(f"train.precision must be f32|bf16, got {t.precision!r}")


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


def _deterministic_knobs():
    """cuDNN's deterministic algorithms, chosen without autotuning."""
    b = torch.backends
    return [("cudnn.deterministic", b.cudnn, "deterministic", True),
            ("cudnn.benchmark", b.cudnn, "benchmark", False)]


@contextlib.contextmanager
def _knobs_set(knobs):
    saved = [getattr(obj, attr) for _, obj, attr, _ in knobs]
    for _, obj, attr, value in knobs:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for (_, obj, attr, _), value in zip(knobs, saved):
            setattr(obj, attr, value)


def f32_matmuls():
    """cuBLAS and cuDNN in IEEE float32 (no TF32) inside the block."""
    return _knobs_set(_f32_knobs())


def deterministic():
    """cuDNN's deterministic algorithms inside the block (its default
    training convs add atomically). The step's other ops are reproducible
    on CUDA as they are: cuBLAS on one stream, the nearest resizes'
    backward by gathers (``models.layers.gather_nearest``), and the switch
    step's gathers, whose backward adds at most one nonzero cotangent to a
    row (a pad lane's is exactly 0)."""
    return _knobs_set(_deterministic_knobs())


def _leaves(tree: Tree) -> Tree:
    """Fresh leaves that require grad, sharing storage with ``tree``."""
    return {k: v.detach().requires_grad_() for k, v in tree.items()}


def _grad(loss: torch.Tensor, leaves: Tree) -> Tree:
    """``d loss / d leaves``; zeros where the loss does not reach a leaf."""
    keys = [k for k in leaves]
    grads = (torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
             if loss.requires_grad else [None] * len(keys))
    return {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(keys, grads)}


def _checkpointed(fn):
    """``fn`` with its forward recomputed in the backward pass (JAX's
    ``jax.checkpoint``). The step draws nothing inside, so no RNG state is
    kept."""
    from torch.utils.checkpoint import checkpoint

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    return run


def draw_step_noise(generator: torch.Generator, modules: MoEModules, batch_size: int,
                    device: str | torch.device | None = None,
                    switch: bool = False) -> Dict[str, object]:
    """One step's random draws on ``device`` (CUDA unless the caller asks for
    the CPU) from ``generator`` (on that device): ``gumbel [B, E]``,
    ``noise_1``, ``noise_2 [B, noise_dim]`` (N(0, 1)) and ``aux_keep``, the
    aux regressor's dropout keep masks (bool, kept with probability ``1 -
    rate``, as ``flax.linen.Dropout`` draws them): ``[E, B, *shape]`` per
    Dropout layer for the dense step, ``[B, *shape]`` (one mask per row,
    that of the row's routed expert) for the switch step (``switch``, as
    ``train_step.switch`` says)."""
    from zdcsim_torch.device import default_device

    dev = default_device(device)
    b, e = int(batch_size), modules.n_experts
    aux = modules.aux_reg
    lead = (b,) if switch else (e, b)
    return {
        "gumbel": gumbel_noise((b, e), generator, dev),
        "noise_1": torch.randn((b, modules.noise_dim), generator=generator, device=dev),
        "noise_2": torch.randn((b, modules.noise_dim), generator=generator, device=dev),
        "aux_keep": tuple(torch.rand((*lead, *shape), generator=generator, device=dev)
                          < 1.0 - aux.rate for shape in aux.dropout_shapes),
    }


def build_train_step(modules: MoEModules, cfg):
    """``train_step(state, batch, draws, epoch) -> (state, metrics)``.

    ``batch``: ``real [B, H, W, 1]``, ``cond [B, C]``, ``std [B, 1]``,
    ``intensity [B, 1]``, ``positions [B, 2]`` on the state's device;
    ``draws`` as :func:`draw_step_noise` returns them (its ``switch`` form
    where ``train_step.switch``); ``epoch`` an int. The state passed in is
    left as it was; the metrics carry the JAX step's names
    (``zdcsim/train/step.py:401-421``), as detached tensors."""
    check_options(cfg)
    E = modules.n_experts
    mc, r, t = cfg.model, cfg.model.router, cfg.train
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
    ema_decay = float(t.ema_decay)
    lrs = make_optimizers(cfg)
    bf16 = str(t.precision) == "bf16"
    fast_gen = bool(t.fast_generator) and modules.names.get("generator") == "Generator"
    switch = str(t.dispatch) == "switch" and E > 1  # JAX's rule
    tile, switch_remat = int(t.dispatch_tile), bool(t.dispatch_remat)

    # ------ the forwards, in the step's precision ------
    def c16(x):
        return x.to(torch.bfloat16) if bf16 else x

    def r16(x):  # bfloat16-rounded, in the input's dtype (the discriminator)
        return x.to(torch.bfloat16).to(x.dtype) if bf16 else x

    def cast(tree, f=c16):
        return {k: f(v) for k, v in tree.items()} if bf16 else tree

    def gen_one(p, noise, cond):
        """One expert (``p``: its slice, cast) on ``noise``, ``cond``."""
        if fast_gen:
            out = fast_generator_apply(flax_view(p), c16(noise), c16(cond), train=True)
        else:
            out = modules.generate_one(p, c16(noise), c16(cond))
        return out.to(noise.dtype)

    def gen_forward(params, noise, cond):
        return torch.stack([gen_one(p, noise, cond) for p in expert_slices(cast(params), E)])

    def disc_forward(params, stats, img, cond):
        return modules.discriminate(cast(params, r16), stats, r16(img), r16(cond))

    def aux_forward(params, img, keep):
        return modules.regress(cast(params), c16(img), keep).to(img.dtype)

    if bool(t.remat):
        gen_forward, disc_forward, aux_forward = (
            _checkpointed(f) for f in (gen_forward, disc_forward, aux_forward))

    def per_expert(fn, *args):
        return torch.stack([fn(*(a[e] for a in args)) for e in range(E)])

    def per_mask(fn, masks):
        return torch.stack([fn(masks[e]) for e in range(E)])

    def route(state, cond, gumbel, tau):
        with torch.no_grad():
            logits = modules.route(state.router.params, cond)
            idx = torch.argmax(torch.softmax((logits + gumbel) / tau, dim=-1), dim=-1)
            masks = expert_masks(idx, E)  # [E, B]
            counts = masks.sum(dim=1)
            active = counts > 1.0  # experts of <= 1 sample skip training
            return idx, masks, counts / idx.shape[0], active, active.to(torch.float32)

    def advance_sn(disc, stats, real, cond):
        """The spectral-norm stats after one train forward of ``real[:1]``
        through every expert (the switch step's power iteration)."""
        with torch.no_grad():
            return disc_forward(disc.params, stats, real[None, :1].expand(E, 1, *real.shape[1:]),
                                cond[:1])[2]

    def remask_stats(disc, new_stats, active):
        e_shape = lambda v: active.reshape((E,) + (1,) * (v.ndim - 1))  # noqa: E731
        return Component(
            params=disc.params,
            stats={k: torch.where(e_shape(v), v, disc.stats[k]) for k, v in new_stats.items()},
            opt_state=disc.opt_state)

    def router_step(state, cond, gumbel, tau, idx, epoch, fake_scores, gen_loss_e, sums_routed,
                    mean_int_e):
        """``fake_scores=None``: the reference's constant GAN term."""
        zero = torch.zeros((), device=cond.device)
        if E == 1:
            return state.router, zero, dict(gan=zero, entropy=zero, ed=zero, diff=zero, alb=zero)
        r_params = _leaves(state.router.params)
        soft_r = torch.softmax((modules.route(r_params, cond) + gumbel) / tau, dim=-1)
        hard = torch.nn.functional.one_hot(idx, E).to(soft_r.dtype)
        gates_st = hard + soft_r - soft_r.detach()
        if fake_scores is not None:  # ST-gate-weighted per-sample hinge: reaches the router
            gan = (gates_st.T * (-fake_scores)).sum(dim=0).mean() * gan_s
        else:
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

    def finish(state, gen_new, disc_new, aux_new, router_out, tau, active, w, disc_loss_e,
               gen_total_e, div_e, int_loss_e, aux_loss_e, std_int_e, mean_int_det):
        router_new, router_loss, raux = router_out
        new_state = MoETrainState(gen=gen_new, disc=disc_new, aux=aux_new, router=router_new,
                                  ema_gen_params=ema_update(state.ema_gen_params, gen_new.params,
                                                            ema_decay),
                                  step=state.step + 1)
        zero_inactive = lambda x: torch.where(active, x.detach(), 0.0)  # noqa: E731
        gen_loss_det = gen_total_e.detach()
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

    def step(state: MoETrainState, batch: Tree, draws, epoch: int
             ) -> Tuple[MoETrainState, Tree]:
        real, cond, std = batch["real"], batch["cond"], batch["std"]
        intensity, positions = batch["intensity"], batch["positions"]
        noise_1, noise_2, gumbel = draws["noise_1"], draws["noise_2"], draws["gumbel"]
        B = real.shape[0]
        tau = tau_schedule(epoch, *taus).to(real.device)
        idx, masks, w, active, active_f = route(state, cond, gumbel, tau)
        with torch.no_grad():
            fake_1 = gen_forward(state.gen.params, noise_1, cond)  # [E, B, H, W, 1]

        # ------ discriminator update ------
        d_params = _leaves(state.disc.params)
        real_scores, _, st1 = disc_forward(d_params, state.disc.stats,
                                           real.expand(E, *real.shape), cond)
        fake_scores, _, st2 = disc_forward(d_params, st1, fake_1, cond)
        disc_loss_e = per_expert(hinge_discriminator_loss, real_scores[..., 0],
                                 fake_scores[..., 0], masks) * w * active_f
        disc_new = masked_expert_update(lrs["disc"], state.disc,
                                        _grad(disc_loss_e.sum(), d_params), active,
                                        new_stats=st2)

        # ------ generator + aux update against the updated discriminator ------
        g_params, a_params = _leaves(state.gen.params), _leaves(state.aux.params)
        fake1 = gen_forward(g_params, noise_1, cond)
        fake2 = gen_forward(g_params, noise_2, cond)
        s1, l1, dst1 = disc_forward(disc_new.params, disc_new.stats, fake1, cond)
        s2, l2, dst2 = disc_forward(disc_new.params, dst1, fake2, cond)
        hinge_e = per_expert(hinge_generator_loss, s1[..., 0], masks)
        div_e = per_expert(
            lambda a, b, m: sdi_gan_regularization(a, b, noise_1, noise_2, std, di_strength,
                                                   m, sdi_quirk), l1, l2, masks)
        ints = [intensity_regularization(fake1[e], intensity, in_strength, masks[e])
                for e in range(E)]
        int_loss_e, sums1, std_int_e, mean_int_e = (torch.stack(t) for t in zip(*ints))
        aux_pred = aux_forward(a_params, fake1, draws["aux_keep"])  # [E, B, 2]
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
        disc_new = remask_stats(disc_new, dst2, active)

        # ------ router update ------
        sums_routed = sums1.detach()[idx, torch.arange(B, device=idx.device)]
        mean_int_det = mean_int_e.detach() * active_f
        router_out = router_step(
            state, cond, gumbel, tau, idx, epoch,
            s1.detach()[..., 0] if differentiable_gan else None, gen_total_e.detach(),
            sums_routed, mean_int_det)
        return finish(state, gen_new, disc_new, aux_new, router_out, tau, active, w,
                      disc_loss_e, gen_total_e, div_e, int_loss_e, aux_loss_e, std_int_e,
                      mean_int_det)

    # ------ the switch form: each sample through its routed expert ------
    def dispatch(fns, idx, inputs):
        return tiled_switch_apply(fns, idx, inputs, tile=tile, remat=switch_remat)

    def gen_fns(params):
        return [lambda ch, p=p: gen_one(p, ch["z"], ch["c"])
                for p in expert_slices(cast(params), E)]

    def disc_fns(params, stats):
        return [lambda ch, p=p, s=s: modules.discriminate_one(p, s, r16(ch["img"]), r16(ch["c"]))
                for p, s in zip(expert_slices(cast(params, r16), E), expert_slices(stats, E))]

    def aux_fns(params, n_keep):
        return [lambda ch, p=p: modules.regress_one(
                    p, c16(ch["img"]), tuple(ch[f"keep{i}"] for i in range(n_keep))
                ).to(ch["img"].dtype)
                for p in expert_slices(cast(params), E)]

    def step_switch(state: MoETrainState, batch: Tree, draws, epoch: int
                    ) -> Tuple[MoETrainState, Tree]:
        if state.gen.stats or state.aux.stats:
            raise ValueError(
                "train.dispatch=switch requires stats-free generator/aux "
                "(proton, or neutron with model.norm=group); use dense for "
                "per-sub-batch BatchNorm semantics")
        real, cond, std = batch["real"], batch["cond"], batch["std"]
        intensity, positions = batch["intensity"], batch["positions"]
        noise_1, noise_2, gumbel = draws["noise_1"], draws["noise_2"], draws["gumbel"]
        B = real.shape[0]
        keep = draws["aux_keep"]
        if any(k.shape[0] != B or k.ndim != 1 + len(s)
               for k, s in zip(keep, modules.aux_reg.dropout_shapes)):
            raise ValueError("the switch step takes one aux keep mask per row, [B, *shape]: "
                             "draw_step_noise(..., switch=True)")
        tau = tau_schedule(epoch, *taus).to(real.device)
        idx, masks, w, active, active_f = route(state, cond, gumbel, tau)
        idx2, cond2 = torch.cat([idx, idx]), torch.cat([cond, cond])

        # ------ discriminator update ------
        with torch.no_grad():
            fake_1 = dispatch(gen_fns(state.gen.params), idx, {"z": noise_1, "c": cond})
        d_params = _leaves(state.disc.params)
        s, _ = dispatch(disc_fns(d_params, state.disc.stats), idx2,
                        {"img": torch.cat([real, fake_1]), "c": cond2})
        real_sc, fake_sc = s[:B, 0], s[B:, 0]
        disc_loss_e = per_mask(lambda m: hinge_discriminator_loss(real_sc, fake_sc, m),
                               masks) * w * active_f
        disc_new = masked_expert_update(lrs["disc"], state.disc,
                                        _grad(disc_loss_e.sum(), d_params), active,
                                        new_stats=advance_sn(state.disc, state.disc.stats,
                                                             real, cond))

        # ------ generator + aux update against the updated discriminator ------
        g_params, a_params = _leaves(state.gen.params), _leaves(state.aux.params)
        fakes = dispatch(gen_fns(g_params), idx2,
                         {"z": torch.cat([noise_1, noise_2]), "c": cond2})
        fake1 = fakes[:B]
        s, latents = dispatch(disc_fns(disc_new.params, state.disc.stats), idx2,
                              {"img": fakes, "c": cond2})
        s1, l1, l2 = s[:B, 0], latents[:B], latents[B:]
        aux_pred = dispatch(aux_fns(a_params, len(keep)), idx,
                            {"img": fake1, **{f"keep{i}": k for i, k in enumerate(keep)}})
        hinge_e = per_mask(lambda m: hinge_generator_loss(s1, m), masks)
        div_e = per_mask(lambda m: sdi_gan_regularization(
            l1, l2, noise_1, noise_2, std, di_strength, m, sdi_quirk), masks)
        ints = [intensity_regularization(fake1, intensity, in_strength, masks[e])
                for e in range(E)]
        int_loss_e, sums_r, std_int_e, mean_int_e = (torch.stack(t) for t in zip(*ints))
        aux_loss_e = per_mask(lambda m: log_cosh_loss(positions, aux_pred, m),
                              masks) * aux_strength
        gen_total_e = (hinge_e + div_e + int_loss_e + aux_loss_e) * w * active_f
        grads = _grad(gen_total_e.sum(), {**{("g", k): v for k, v in g_params.items()},
                                           **{("a", k): v for k, v in a_params.items()}})
        gen_new = masked_expert_update(lrs["gen"], state.gen,
                                       {k: grads[("g", k)] for k in g_params}, active)
        aux_new = masked_expert_update(lrs["aux"], state.aux,
                                       {k: grads[("a", k)] for k in a_params}, active)
        disc_new = remask_stats(disc_new, advance_sn(disc_new, disc_new.stats, real, cond),
                                active)

        # ------ router update (the constant GAN term) ------
        mean_int_det = mean_int_e.detach() * active_f
        router_out = router_step(state, cond, gumbel, tau, idx, epoch, None,
                                 gen_total_e.detach(), sums_r[0].detach(), mean_int_det)
        return finish(state, gen_new, disc_new, aux_new, router_out, tau, active, w,
                      disc_loss_e, gen_total_e, div_e, int_loss_e, aux_loss_e, std_int_e,
                      mean_int_det)

    body = step_switch if switch else step

    def train_step(state: MoETrainState, batch: Tree, draws, epoch: int):
        with f32_matmuls(), deterministic():
            return body(state, batch, draws, epoch)

    train_step.switch = switch
    train_step.precision = {"train.precision": str(t.precision),
                            **{name: value for name, _, _, value in
                               _f32_knobs() + _deterministic_knobs()}}
    return train_step
