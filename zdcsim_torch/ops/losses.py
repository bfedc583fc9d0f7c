"""Loss functions of the MoE GAN (counterpart of ``zdcsim/ops/losses.py``).

Every loss takes a float ``mask`` over the whole batch (1.0 where the sample
is routed to the expert in question) and computes masked means, so one step
covers all experts with static shapes; ``mask=None`` reduces over the whole
batch. The arithmetic follows the JAX functions term for term, the
reference's quirks included where JAX keeps them (``pairwise_quirk``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-5


def _bcast_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[B]`` mask reshaped to broadcast against ``x`` of shape ``[B, ...]``."""
    return mask.reshape(mask.shape[0], *([1] * (x.ndim - 1)))


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``x`` over the samples where ``mask == 1`` (all their elements)."""
    if mask is None:
        return x.mean()
    denom = torch.clamp_min(mask.sum(), 1.0) * (x.numel() / x.shape[0])
    return (x * _bcast_mask(mask, x)).sum() / denom


def masked_std(x: torch.Tensor, mask: Optional[torch.Tensor], ddof: int = 1) -> torch.Tensor:
    """Masked standard deviation over ``[B]`` values, divided by
    ``max(n - ddof, 1)``."""
    if mask is None:
        mu = x.mean()
        return torch.sqrt(((x - mu) ** 2).sum() / max(x.numel() - ddof, 1.0))
    x = x.reshape(x.shape[0])
    n = mask.sum()
    mu = (x * mask).sum() / torch.clamp_min(n, 1.0)
    var = (mask * (x - mu) ** 2).sum() / torch.clamp_min(n - ddof, 1.0)
    return torch.sqrt(var)


def hinge_discriminator_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(1 - D(real)).mean() + relu(1 + D(fake)).mean()`` over routed samples."""
    real_scores = real_scores.reshape(real_scores.shape[0])
    fake_scores = fake_scores.reshape(fake_scores.shape[0])
    return (masked_mean(torch.relu(1.0 - real_scores), mask)
            + masked_mean(torch.relu(1.0 + fake_scores), mask))


def hinge_generator_loss(fake_scores: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``-D(fake).mean()`` over routed samples."""
    return -masked_mean(fake_scores.reshape(fake_scores.shape[0]), mask)


def sdi_gan_regularization(fake_latent: torch.Tensor, fake_latent_2: torch.Tensor,
                           noise: torch.Tensor, noise_2: torch.Tensor, std: torch.Tensor,
                           di_strength: float, mask: Optional[torch.Tensor] = None,
                           pairwise_quirk: bool = False) -> torch.Tensor:
    """SDI-GAN diversity term: ``div_i = mean|l1_i - l2_i| / (mean|z1_i -
    z2_i| + 1e-5)``, loss ``mean(std) * mean(std_i / (div_i + 1e-5)) *
    di_strength``; ``pairwise_quirk`` factorises the inner mean as the
    reference's accidental ``[B, B]`` broadcast does."""
    std = std.reshape(std.shape[0])
    abs_diff_latent = (fake_latent - fake_latent_2).abs().mean(dim=1)
    abs_diff_noise = (noise - noise_2).abs().mean(dim=1)
    div = abs_diff_latent / (abs_diff_noise + _EPS)
    if pairwise_quirk:
        per_sample = masked_mean(std, mask) * masked_mean(1.0 / (div + _EPS), mask)
    else:
        per_sample = masked_mean(std / (div + _EPS), mask)
    return masked_mean(std, mask) * per_sample * di_strength


def intensity_regularization(fake_images: torch.Tensor, intensity_target: torch.Tensor,
                             in_strength: float, mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """MAE between generated photon sums ``sum(expm1(img))`` and the targets.
    Returns ``(loss, sums [B], masked std of sums, masked mean of sums)``."""
    return intensity_terms(photon_sums(fake_images), intensity_target, in_strength, mask)


def photon_sums(fake_images: torch.Tensor) -> torch.Tensor:
    """``sum(expm1(img))`` of each of the ``[B, ...]`` log-space images: ``[B]``."""
    return torch.expm1(fake_images.reshape(fake_images.shape[0], -1)).sum(dim=1)


def intensity_terms(sums: torch.Tensor, intensity_target: torch.Tensor, in_strength: float,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`intensity_regularization` of the photon ``sums [B]`` (the train
    step on a mesh gathers each rank's sums, then reduces over the global
    batch here)."""
    target = intensity_target.reshape(sums.shape[0])
    loss = masked_mean((sums - target).abs(), mask) * in_strength
    return loss, sums, masked_std(sums, mask), masked_mean(sums, mask)


def log_cosh_loss(true_coords: torch.Tensor, pred_coords: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable log-cosh: ``mean(d + softplus(-2d) - log 2)``."""
    d = pred_coords - true_coords
    return masked_mean(d + F.softplus(-2.0 * d) - math.log(2.0), mask)


def expert_utilization_entropy(gates_soft: torch.Tensor, strength: float = 0.1) -> torch.Tensor:
    """Entropy of the batch-mean gate distribution, times ``strength``."""
    avg = gates_soft.mean(dim=0)
    return -(avg * torch.log(avg + 1e-9)).sum() * strength


def expert_distribution_loss(gating_probs: torch.Tensor, features: torch.Tensor,
                             lambda_reg: float = 0.1) -> torch.Tensor:
    """``sum((G G^T) * cdist(F)) / B * lambda_reg``, the distance
    ``sqrt(max(d2, 0) + 1e-12)``."""
    sq = (features ** 2).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (features @ features.T)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0) + 1e-12)
    sims = gating_probs @ gating_probs.T
    return (sims * dist).sum() / gating_probs.shape[0] * lambda_reg


def differentiation_loss(mean_intensities: torch.Tensor) -> torch.Tensor:
    """Sum over expert pairs ``i < j`` of ``|mean_i - mean_j|``."""
    ii, jj = torch.triu_indices(mean_intensities.shape[0], mean_intensities.shape[0], offset=1,
                                device=mean_intensities.device)
    return (mean_intensities[ii] - mean_intensities[jj]).abs().sum()


def adaptive_load_balancing_loss(routing_scores: torch.Tensor, alb_strength: float,
                                 eps: float = 1e-6) -> torch.Tensor:
    """``mean(exp(1 / (sum_batch gates_e + eps))) * strength``."""
    return torch.exp(1.0 / (routing_scores + eps)).mean() * alb_strength


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def tau_schedule(epoch, tau_start: float, tau_min: float, tau_decay: float) -> torch.Tensor:
    """Gumbel temperature ``max(tau_min, tau_start * tau_decay^epoch)``, float32."""
    return torch.clamp_min(_f32(tau_start) * _f32(tau_decay) ** _f32(epoch), tau_min)


def alb_annealing_weight(epoch, alpha: int, min_weight: float) -> torch.Tensor:
    """ALB weight ramping ``min_weight -> 1`` over ``alpha`` epochs, float32."""
    frac = torch.clamp(_f32(epoch) / float(alpha), 0.0, 1.0)
    return min_weight + (1.0 - min_weight) * frac
