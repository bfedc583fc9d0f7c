"""Plain reference of the proton MoE GAN's dense train step (the reference's
MoE trainer as its Flax port states it; ``train.dispatch: dense``,
``train.precision: f32``), on the benchmark's own trees.

Trees are the Flax layout (Dense kernels ``[in, out]``, conv kernels HWIO),
every leaf of the generator, the discriminator and the aux regressor
stacked on a leading expert axis; each expert runs on its slice in a Python
loop. One step, in order:

1. route: ``argmax(softmax((logits + gumbel) / tau))``; masks, shares ``w =
   B_e / B``, ``active = B_e > 1``;
2. discriminator: the hinge loss of every expert on the real images and on
   its generator's fakes (no gradient into the generator), masked to its
   rows, weighted by ``w * active``; spectral norm's power iteration runs
   on each forward; Adam on the active experts;
3. generator and aux regressor against the updated discriminator: hinge,
   the SDI-GAN diversity term on the latents of two noises, the photon-sum
   intensity term, the log-cosh position loss of the aux regressor (on the
   given dropout keep masks); Adam on the active experts; the
   discriminator's spectral-norm state of these forwards kept;
4. the EMA of the generator;
5. the router: the straight-through gates weighting the detached fake
   scores, the differentiation and load-balancing terms, Adam unless the
   router is frozen at ``stop_router_training_epoch``.

Everything in float32, TF32 off where ``tf32`` is False (the control runs it
with TF32 on).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from reference.common import NORM_EPS, conv, dense, groups_of, layer_norm, leaky, router_v1
from reference.proton import generator

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
SN_EPS = 1e-12

Tree = Dict[str, Any]


# ---- the discriminator and the aux regressor, as their leaves and forwards ----

def disc_leaves(cfg) -> list:
    h, w = cfg["dataset.input_image_shape"]
    h, w = (h - 2) // 2, (w - 2) // 2
    h, w = (h - 2) // 2, (w - 2) // 1
    cond = int(cfg["model.cond_dim"])
    out = []
    for name, shape in (("SNConv_0", (3, 3, 1, 32)), ("SNConv_1", (3, 3, 32, 16))):
        out += [((name, "Conv_0", "kernel"), shape, "lecun"),
                ((name, "Conv_0", "bias"), shape[-1:], "zeros")]
    for i, c in ((0, 32), (1, 16)):
        out += [((f"GroupNorm2d_{i}", "GroupNorm_0", "scale"), (c,), "ones"),
                ((f"GroupNorm2d_{i}", "GroupNorm_0", "bias"), (c,), "zeros")]
    for name, shape in (("SNDense_0", (16 * h * w + cond, 128)), ("SNDense_1", (128, 64)),
                        ("SNDense_2", (64, 1))):
        out += [((name, "Dense_0", "kernel"), shape, "lecun"),
                ((name, "Dense_0", "bias"), shape[-1:], "zeros")]
    for i, c in ((0, 128), (1, 64)):
        out += [((f"LayerNorm_{i}", "scale"), (c,), "ones"), ((f"LayerNorm_{i}", "bias"), (c,), "zeros")]
    return out


SN_LAYERS = (("SNConv_0", "Conv_0", 32), ("SNConv_1", "Conv_0", 16), ("SNDense_0", "Dense_0", 128),
             ("SNDense_1", "Dense_0", 64), ("SNDense_2", "Dense_0", 1))


def disc_stats_leaves(cfg) -> list:
    """Spectral norm's power-iteration state: ``u`` N(0, 1) ``[1, out]``,
    ``sigma`` 1."""
    out = []
    for name, inner, c in SN_LAYERS:
        out += [((name, "SpectralNorm_0", f"{inner}/kernel/u"), (1, c), "normal"),
                ((name, "SpectralNorm_0", f"{inner}/kernel/sigma"), (), "ones")]
    return out


def aux_leaves(cfg) -> list:
    out = [(("Conv_0", "kernel"), (5, 5, 1, 32), "lecun"), (("Conv_0", "bias"), (32,), "zeros"),
           (("GroupNorm2d_0", "GroupNorm_0", "scale"), (32,), "ones"),
           (("GroupNorm2d_0", "GroupNorm_0", "bias"), (32,), "zeros")]
    for b, (cin, c) in enumerate(((32, 32), (32, 64))):
        for i, (k, ci) in enumerate(((5, cin), (5, c), (1, cin))):
            out += [((f"ResidualBlock_{b}", f"Conv_{i}", "kernel"), (k, k, ci, c), "lecun"),
                    ((f"ResidualBlock_{b}", f"Conv_{i}", "bias"), (c,), "zeros"),
                    ((f"ResidualBlock_{b}", f"GroupNorm2d_{i}", "GroupNorm_0", "scale"), (c,), "ones"),
                    ((f"ResidualBlock_{b}", f"GroupNorm2d_{i}", "GroupNorm_0", "bias"), (c,), "zeros")]
    for i, (a, b) in enumerate(((64, 128), (128, 64), (64, 2))):
        out += [((f"Dense_{i}", "kernel"), (a, b), "lecun"), ((f"Dense_{i}", "bias"), (b,), "zeros")]
    for i, c in ((0, 128), (1, 64)):
        out += [((f"LayerNorm_{i}", "scale"), (c,), "ones"), ((f"LayerNorm_{i}", "bias"), (c,), "zeros")]
    return out


def _l2n(x):
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def _sn(kernel, st, inner):
    """Flax's SpectralNorm, one power step on the kernel flattened to
    ``[K, out]``: ``(kernel / sigma, new state)``."""
    w = kernel.reshape(-1, kernel.shape[-1])
    u = st[f"{inner}/kernel/u"]
    with torch.no_grad():
        v = _l2n(u @ w.T)
        u = _l2n(v @ w)
    sigma = ((v @ w) @ u.T)[0, 0]
    w_n = (w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))).reshape(kernel.shape)
    return w_n, {f"{inner}/kernel/u": u, f"{inner}/kernel/sigma": sigma.detach()}


def _gn(x, p, groups):
    b, h, w, c = x.shape
    g = groups_of(c, groups)
    xg = x.reshape(b, h, w, g, c // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    return ((xg - mu) / torch.sqrt(var + NORM_EPS)).reshape(b, h, w, c) * p["scale"] + p["bias"]


def _max_pool(x, window, strides=None):
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides or window)
    return y.permute(0, 2, 3, 1)


def discriminate(p, st, img, cond):
    """``(score [B, 1], latent [B, 64], new spectral-norm state)``."""
    new = {}
    x = img
    for i, (name, pool) in enumerate((("SNConv_0", (2, 2)), ("SNConv_1", (2, 1)))):
        k, new[name] = _sn(p[name]["Conv_0"]["kernel"], st[name]["SpectralNorm_0"], "Conv_0")
        x = conv(x, k, p[name]["Conv_0"]["bias"], (0, 0, 0, 0))
        x = _max_pool(leaky(_gn(x, p[f"GroupNorm2d_{i}"]["GroupNorm_0"], 8)), pool)
    x = torch.cat([x.reshape(x.shape[0], -1), cond], dim=1)
    for i, name in enumerate(("SNDense_0", "SNDense_1")):
        k, new[name] = _sn(p[name]["Dense_0"]["kernel"], st[name]["SpectralNorm_0"], "Dense_0")
        x = leaky(layer_norm(x @ k + p[name]["Dense_0"]["bias"], p[f"LayerNorm_{i}"]))
    k, new["SNDense_2"] = _sn(p["SNDense_2"]["Dense_0"]["kernel"], st["SNDense_2"]["SpectralNorm_0"],
                              "Dense_0")
    score = x @ k + p["SNDense_2"]["Dense_0"]["bias"]
    return score, x, {n: {"SpectralNorm_0": v} for n, v in new.items()}


def _same_pad(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_s(x, p, stride, pad):
    xt = F.pad(x.permute(0, 3, 1, 2), (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    y = F.conv2d(xt, p["kernel"].permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    return y + p["bias"]


def _residual(x, p, k, stride):
    q = k // 2
    y = torch.relu(_gn(_conv_s(x, p["Conv_0"], stride, ((q, q), (q, q))), p["GroupNorm2d_0"]["GroupNorm_0"], 32))
    y = _gn(_conv_s(y, p["Conv_1"], 1, ((q, q), (q, q))), p["GroupNorm2d_1"]["GroupNorm_0"], 32)
    pad = tuple(_same_pad(n, 1, stride) for n in x.shape[1:3])
    ident = _gn(_conv_s(x, p["Conv_2"], stride, pad), p["GroupNorm2d_2"]["GroupNorm_0"], 32)
    return torch.relu(y + ident)


def regress(p, img, keep, rate=0.3):
    """The aux regressor on ``keep`` (its two dropout keep masks): ``[B, 2]``."""
    x = torch.relu(_gn(_conv_s(img, p["Conv_0"], 2, ((1, 1), (1, 1))), p["GroupNorm2d_0"]["GroupNorm_0"], 8))
    x = _max_pool(x, (2, 2), (1, 1))
    x = _max_pool(_residual(x, p["ResidualBlock_0"], 5, 2), (2, 2), (1, 1))
    x = _max_pool(_residual(x, p["ResidualBlock_1"], 5, 2), (2, 2), (1, 1))
    y = x.mean(dim=(1, 2))
    for i in (0, 1):
        y = leaky(layer_norm(dense(y, p[f"Dense_{i}"]), p[f"LayerNorm_{i}"]))
        y = torch.where(keep[i], y / (1.0 - rate), torch.zeros_like(y))
    return dense(y, p["Dense_2"])


# ---- losses ----

def _mmean(x, m):
    return (x * m.reshape(-1, *([1] * (x.ndim - 1)))).sum() / (m.sum().clamp_min(1.0) * (x.numel() / x.shape[0]))


def _mstd(x, m):
    n = m.sum()
    mu = (x * m).sum() / n.clamp_min(1.0)
    return torch.sqrt((m * (x - mu) ** 2).sum() / (n - 1).clamp_min(1.0))


# ---- tree helpers ----

def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tmap(fn, *trees):
    return {k: tmap(fn, *(t[k] for t in trees)) if isinstance(v, dict) else fn(*(t[k] for t in trees))
            for k, v in trees[0].items()}


def expert(tree, e):
    return tmap(lambda v: v[e], tree)


def stack(trees):
    return tmap(lambda *vs: torch.stack(vs), *trees)


def _adam(p, mu, nu, g, count, lr, active=None):
    """optax's Adam at ``count`` (after the increment); ``active`` [E] keeps
    the inactive experts' parameters and moments."""
    mu_n = tmap(lambda m, gg: B1 * m + (1 - B1) * gg, mu, g)
    nu_n = tmap(lambda n, gg: B2 * n + (1 - B2) * gg * gg, nu, g)
    bc1, bc2 = 1 - B1 ** count, 1 - B2 ** count
    p_n = tmap(lambda pp, m, n: pp - lr * (m / bc1) / (torch.sqrt(n / bc2) + ADAM_EPS), p, mu_n, nu_n)
    if active is None:
        return p_n, mu_n, nu_n

    def keep(new, old):
        return torch.where(active.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

    return tmap(keep, p_n, p), tmap(keep, mu_n, mu), tmap(keep, nu_n, nu)


def _grads(loss, tree):
    flat = [v for _, v in leaves(tree)]
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter([torch.zeros_like(v) if g is None else g for v, g in zip(flat, gs)])
    return tmap(lambda v: next(it), tree)


def _req(tree):
    return tmap(lambda v: v.detach().clone().requires_grad_(), tree)


def step(state: Dict[str, Any], batch, draws, epoch: int, s: Dict[str, Any]):
    """One dense step; ``state`` as :func:`init` makes it (left as it is).
    Returns ``(new state, {"gen_loss", "disc_loss", "router_loss"})``."""
    E = int(s["model.n_experts"])
    real, cond, std = batch["real"], batch["cond"], batch["std"][:, 0]
    intensity, positions = batch["intensity"][:, 0], batch["positions"]
    z1, z2, gumbel = draws["noise_1"], draws["noise_2"], draws["gumbel"]
    B = real.shape[0]
    tau = max(float(s["model.router.tau_min"]),
              float(s["model.router.tau_start"]) * float(s["model.router.tau_decay"]) ** epoch)
    count = state["count"] + 1
    with torch.no_grad():
        logits = router_v1(state["router"]["params"], cond)
        idx = torch.softmax((logits + gumbel) / tau, -1).argmax(-1)
        masks = (idx[None, :] == torch.arange(E, device=idx.device)[:, None]).float()
        counts = masks.sum(1)
        w, active = counts / B, counts > 1.0
        act_f = active.float()
        gp = state["gen"]["params"]
        fake_1 = [generator(expert(gp, e), z1, cond)[..., None] for e in range(E)]

    # discriminator
    d = state["disc"]
    dp = _req(d["params"])
    d_loss_e, st2 = [], []
    for e in range(E):
        pe = expert(dp, e)
        rs, _, s1 = discriminate(pe, expert(d["stats"], e), real, cond)
        fs, _, s2 = discriminate(pe, s1, fake_1[e], cond)
        m = masks[e]
        loss = _mmean(torch.relu(1.0 - rs[:, 0]), m) + _mmean(torch.relu(1.0 + fs[:, 0]), m)
        d_loss_e.append(loss * w[e] * act_f[e])
        st2.append(s2)
    d_loss_e = torch.stack(d_loss_e)
    dg = _grads(d_loss_e.sum(), dp)
    lr_d = float(s["model.discriminator.lr_d"])
    d_params, d_mu, d_nu = _adam(d["params"], d["mu"], d["nu"], dg, count, lr_d, active)
    keep_st = lambda n, o: torch.where(active.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)  # noqa: E731
    d_stats = tmap(keep_st, stack(st2), d["stats"])

    # generator and aux regressor
    g_req, a_req = _req(gp), _req(state["aux"]["params"])
    g_total, s1_all, sums_all, mean_int = [], [], [], []
    for e in range(E):
        ge = expert(g_req, e)
        f1 = generator(ge, z1, cond)[..., None]
        f2 = generator(ge, z2, cond)[..., None]
        pd = expert(d_params, e)
        sc1, l1, dst1 = discriminate(pd, expert(d_stats, e), f1, cond)
        _, l2, dst2 = discriminate(pd, dst1, f2, cond)
        m = masks[e]
        hinge = -_mmean(sc1[:, 0], m)
        div = (l1 - l2).abs().mean(1) / ((z1 - z2).abs().mean(1) + 1e-5)
        div_loss = (_mmean(std, m) * _mmean(std / (div + 1e-5), m)
                    * float(s["model.generator.di_strength"]))
        sums = torch.expm1(f1.reshape(B, -1)).sum(1)
        int_loss = _mmean((sums - intensity).abs(), m) * float(s["model.generator.in_strength"])
        keep = tuple(k[e] for k in draws["aux_keep"])
        pred = regress(expert(a_req, e), f1, keep)
        dd = pred - positions
        aux_loss = _mmean(dd + F.softplus(-2.0 * dd) - math.log(2.0), m) * float(s["model.aux_reg.strength"])
        g_total.append((hinge + div_loss + int_loss + aux_loss) * w[e] * act_f[e])
        s1_all.append(sc1[:, 0].detach())
        sums_all.append(sums.detach())
        mean_int.append(_mmean(sums.detach(), m))
        st2[e] = dst2
    g_total = torch.stack(g_total)
    grads = _grads(g_total.sum(), {"g": g_req, "a": a_req})
    g, a = state["gen"], state["aux"]
    g_params, g_mu, g_nu = _adam(gp, g["mu"], g["nu"], grads["g"], count,
                                 float(s["model.generator.lr_g"]), active)
    a_params, a_mu, a_nu = _adam(a["params"], a["mu"], a["nu"], grads["a"], count,
                                 float(s["model.aux_reg.lr_a"]), active)
    d_stats = tmap(keep_st, stack(st2), d_stats)
    decay = float(s["train.ema_decay"])
    ema = tmap(lambda e_, p_: decay * e_ + (1 - decay) * p_, state["ema"], g_params)

    # router
    r = state["router"]
    rp = _req(r["params"])
    soft = torch.softmax((router_v1(rp, cond) + gumbel) / tau, -1)
    hard = F.one_hot(idx, E).float()
    gates = hard + soft - soft.detach()
    scores = torch.stack(s1_all)  # [E, B]
    gan = (gates.T * (-scores)).sum(0).mean() * float(s["model.router.gan_strength"])
    mean_int = torch.stack(mean_int) * act_f
    ii, jj = torch.triu_indices(E, E, 1, device=cond.device)
    diff = -(mean_int[ii] - mean_int[jj]).abs().sum() * float(s["model.router.diff_strength"])
    alb = torch.exp(1.0 / (soft.sum(0) + 1e-6)).mean() * float(s["model.router.alb_strength"])
    frac = min(max(epoch / float(s["model.router.alpha"]), 0.0), 1.0)
    w_alb = float(s["model.router.min_weight"]) + (1 - float(s["model.router.min_weight"])) * frac
    r_loss = gan + diff + w_alb * alb
    stop = s["model.router.stop_router_training_epoch"]
    r_on = stop is None or epoch < int(stop)
    if r_on:
        rg = _grads(r_loss, rp)
        r_count = r["count"] + 1
        r_params, r_mu, r_nu = _adam(r["params"], r["mu"], r["nu"], rg, r_count,
                                     float(s["model.router.lr_r"]))
        router = {"params": r_params, "mu": r_mu, "nu": r_nu, "count": r_count}
    else:
        router = r
    new = {"gen": {"params": g_params, "mu": g_mu, "nu": g_nu},
           "disc": {"params": d_params, "mu": d_mu, "nu": d_nu, "stats": d_stats},
           "aux": {"params": a_params, "mu": a_mu, "nu": a_nu},
           "router": router, "ema": ema, "count": count}
    if real.device.type == "meta":  # counted, not run (counts/train.py)
        return new, {}
    metrics = {"gen_loss": float(g_total.detach().mean()), "disc_loss": float(d_loss_e.detach().mean()),
               "router_loss": float(r_loss.detach()) if r_on else 0.0}
    return new, metrics


def init(gen, disc, disc_stats, aux, router) -> Dict[str, Any]:
    """The state of :func:`step` from the benchmark's trees: Adam's moments
    0, the EMA equal to the generator."""
    z = lambda t: tmap(torch.zeros_like, t)  # noqa: E731
    return {"gen": {"params": gen, "mu": z(gen), "nu": z(gen)},
            "disc": {"params": disc, "mu": z(disc), "nu": z(disc), "stats": disc_stats},
            "aux": {"params": aux, "mu": z(aux), "nu": z(aux)},
            "router": {"params": router, "mu": z(router), "nu": z(router), "count": 0},
            "ema": tmap(torch.clone, gen), "count": 0}
