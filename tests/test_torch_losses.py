"""The port's losses and routing primitives against ``zdcsim/ops/losses.py``
and ``zdcsim/ops/routing.py``, on the CPU.

Every function of both modules on the same numpy-seeded float32 inputs:
values within rtol 1e-5, and gradients (``jax.grad`` against autograd) of
a seeded weighted sum of the outputs within rtol 1e-5. The Gumbel noise is
JAX's own draw on the key, handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zdcsim.ops import losses as jl
from zdcsim.ops import routing as jr
from zdcsim_torch.ops import losses as tl
from zdcsim_torch.ops import routing as tr

B, E = 16, 3
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = (rng.random(B) < 0.6).astype(np.float32)
    mask[:2] = 1.0
    return rng, f, mask


def _check(jax_fn, torch_fn, args, diff_args, seed):
    """Values of ``jax_fn(*args)`` and ``torch_fn(*args)`` (numpy args; the
    others passed as they are), then the gradients of a weighted sum of the
    outputs with respect to the arguments at ``diff_args``."""
    rng = np.random.default_rng(seed + 1000)
    j_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    t_args = [torch.tensor(a, requires_grad=i in diff_args) if isinstance(a, np.ndarray) else a
              for i, a in enumerate(args)]
    j_out, t_out = jax_fn(*j_args), torch_fn(*t_args)
    j_outs = j_out if isinstance(j_out, tuple) else (j_out,)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    assert len(j_outs) == len(t_outs)
    weights = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in j_outs]
    for j, t in zip(j_outs, t_outs):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=0)
    if not diff_args:
        return

    def j_scalar(*dargs):
        a = list(j_args)
        for i, d in zip(diff_args, dargs):
            a[i] = d
        out = jax_fn(*a)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(out, weights))

    j_grads = jax.grad(j_scalar, argnums=tuple(range(len(diff_args))))(
        *[j_args[i] for i in diff_args])
    t_scalar = sum((o * torch.from_numpy(w)).sum() for o, w in zip(t_outs, weights))
    t_grads = torch.autograd.grad(t_scalar, [t_args[i] for i in diff_args])
    for jg, tg in zip(j_grads, t_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=0)


def _cases():
    rng, f, mask = _inputs(0)
    x3 = f(B, 3)
    scores_r, scores_f = f(B, 1), f(B, 1)
    l1, l2, n1, n2 = f(B, 16), f(B, 16), f(B, 10), f(B, 10)
    std = rng.random((B, 1)).astype(np.float32)
    imgs = (rng.random((B, 8, 6, 1)) * 2).astype(np.float32)
    target = (rng.random((B, 1)) * 300).astype(np.float32)
    coords, pred = (rng.random((B, 2)) * 5).astype(np.float32), (rng.random((B, 2)) * 5
                                                                 ).astype(np.float32)
    gates = jax.nn.softmax(f(B, E), axis=-1)
    gates = np.asarray(gates, dtype=np.float32)
    feats = (rng.random((B, 1)) * 10).astype(np.float32)
    means = (rng.random(E) * 1000).astype(np.float32)
    shares = (rng.random(E) * 5 + 0.5).astype(np.float32)
    cases = []
    for m_name, m in (("mask", mask), ("nomask", None)):
        cases += [
            (f"masked_mean-{m_name}", jl.masked_mean, tl.masked_mean, (x3, m), (0,)),
            (f"masked_std-{m_name}", jl.masked_std, tl.masked_std, (x3[:, 0], m), (0,)),
            (f"hinge_d-{m_name}", jl.hinge_discriminator_loss, tl.hinge_discriminator_loss,
             (scores_r, scores_f, m), (0, 1)),
            (f"hinge_g-{m_name}", jl.hinge_generator_loss, tl.hinge_generator_loss,
             (scores_f, m), (0,)),
            (f"intensity-{m_name}", jl.intensity_regularization, tl.intensity_regularization,
             (imgs, target, 1e-3, m), (0,)),
            (f"log_cosh-{m_name}", jl.log_cosh_loss, tl.log_cosh_loss, (coords, pred, m), (1,)),
        ]
        for quirk in (False, True):
            cases.append((f"sdi-{m_name}-quirk{quirk}", jl.sdi_gan_regularization,
                          tl.sdi_gan_regularization, (l1, l2, n1, n2, std, 0.1, m, quirk),
                          (0, 1, 4)))
    cases += [
        ("masked_std-ddof0", lambda x, m: jl.masked_std(x, m, 0),
         lambda x, m: tl.masked_std(x, m, 0), (x3[:, 0], mask), (0,)),
        ("masked_std-one-sample", jl.masked_std, tl.masked_std,
         (x3[:, 0], np.eye(B, dtype=np.float32)[3]), (0,)),
        ("utilization_entropy", jl.expert_utilization_entropy, tl.expert_utilization_entropy,
         (gates, 0.1), (0,)),
        # the gradient in the gates only: the step passes detached features,
        # whose gradient runs through the cancelling sq_i + sq_j - 2 f_i f_j
        ("expert_distribution", jl.expert_distribution_loss, tl.expert_distribution_loss,
         (gates, feats, 0.1), (0,)),
        ("differentiation", jl.differentiation_loss, tl.differentiation_loss, (means,), (0,)),
        ("alb", jl.adaptive_load_balancing_loss, tl.adaptive_load_balancing_loss,
         (shares, 1e-5), (0,)),
    ]
    return cases


CASES = _cases()


@pytest.mark.parametrize("name,jax_fn,torch_fn,args,diff", CASES, ids=[c[0] for c in CASES])
def test_loss_matches_jax(name, jax_fn, torch_fn, args, diff):
    _check(jax_fn, torch_fn, args, diff, seed=len(name))


@pytest.mark.parametrize("epoch", [0, 1, 7, 26.0, 40, 120])
def test_schedules_match_jax(epoch):
    np.testing.assert_allclose(tl.tau_schedule(epoch, 1.2, 0.8, 0.985).numpy(),
                               np.asarray(jl.tau_schedule(epoch, 1.2, 0.8, 0.985)), rtol=RTOL)
    np.testing.assert_allclose(tl.alb_annealing_weight(epoch, 60, 0.2).numpy(),
                               np.asarray(jl.alb_annealing_weight(epoch, 60, 0.2)), rtol=RTOL)
    assert tl.tau_schedule(epoch, 1.2, 0.8, 0.985).dtype == torch.float32


def test_expert_distribution_equal_features_keep_the_eps():
    """Equal features give distance sqrt(1e-12) = 1e-6, not 0 (``:180``)."""
    g = np.full((4, 2), 0.5, np.float32)
    feats = np.ones((4, 1), np.float32)
    ours = tl.expert_distribution_loss(torch.from_numpy(g), torch.from_numpy(feats)).item()
    ref = float(jl.expert_distribution_loss(jnp.asarray(g), jnp.asarray(feats)))
    assert ours == pytest.approx(ref, rel=RTOL) and ours > 0


@pytest.mark.parametrize("tau,hard", [(1.0, False), (0.8, False), (1.2, True)])
def test_gumbel_softmax_matches_jax_on_its_noise(tau, hard):
    key = jax.random.PRNGKey(7)
    logits = np.random.default_rng(3).standard_normal((B, E)).astype(np.float32)
    ref = jr.gumbel_softmax(key, jnp.asarray(logits), tau=tau, hard=hard)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (B, E), jnp.float32)))
    ours = tr.gumbel_softmax(torch.from_numpy(logits), tau=tau, hard=hard, noise=noise)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=0)


def test_straight_through_gates_match_jax():
    rng = np.random.default_rng(4)
    soft = np.asarray(jax.nn.softmax(rng.standard_normal((B, E)).astype(np.float32)))
    w = rng.standard_normal((B, E)).astype(np.float32)
    (g_ref, i_ref) = jr.straight_through_gates(jnp.asarray(soft))
    grad_ref = jax.grad(lambda s: jnp.sum(jr.straight_through_gates(s)[0] * w))(
        jnp.asarray(soft))
    t = torch.tensor(soft, requires_grad=True)
    g, i = tr.straight_through_gates(t)
    (g * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), rtol=RTOL, atol=1e-7)
    assert np.array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad_ref), rtol=RTOL)


@pytest.mark.parametrize("n_experts", [1, 3, 5])
def test_expert_masks_and_class_share_match_jax(n_experts):
    idx = np.random.default_rng(n_experts).integers(0, n_experts, size=B)
    np.testing.assert_array_equal(tr.expert_masks(torch.from_numpy(idx), n_experts).numpy(),
                                  np.asarray(jr.expert_masks(jnp.asarray(idx), n_experts)))
    np.testing.assert_allclose(tr.class_share(torch.from_numpy(idx), n_experts).numpy(),
                               np.asarray(jr.class_share(jnp.asarray(idx), n_experts)),
                               rtol=RTOL)


def test_gumbel_noise_is_drawn_from_the_generator():
    a = tr.gumbel_noise((1000, 3), torch.Generator().manual_seed(1))
    b = tr.gumbel_noise((1000, 3), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert abs(a.mean().item() - 0.5772) < 0.05  # the Euler-Mascheroni constant
