"""1-D Wasserstein distance in PyTorch (counterpart of ``zdcsim/ops/ws.py``).

The L1 distance between the empirical CDFs of two samples with uniform
weights, as ``scipy.stats.wasserstein_distance`` computes it, on the
tensors' device.
"""

from __future__ import annotations

import torch


def wasserstein_1d(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W1 between the empirical distributions of the 1-D samples ``u``, ``v``."""
    u = torch.sort(u.reshape(-1)).values
    v = torch.sort(v.reshape(-1)).values
    if u.shape[0] == v.shape[0]:
        # equal sample counts: the mean absolute difference of order statistics
        return torch.mean(torch.abs(u - v))
    all_vals = torch.sort(torch.cat([u, v])).values
    deltas = torch.diff(all_vals)
    cdf_u = torch.searchsorted(u, all_vals[:-1], right=True) / u.shape[0]
    cdf_v = torch.searchsorted(v, all_vals[:-1], right=True) / v.shape[0]
    return torch.sum(torch.abs(cdf_u - cdf_v) * deltas)


def wasserstein_per_channel(ch_real: torch.Tensor, ch_gen: torch.Tensor) -> torch.Tensor:
    """Per-channel W1 of ``[N, C]`` against ``[M, C]`` channel sums: ``[C]``."""
    return torch.stack([wasserstein_1d(ch_real[:, c], ch_gen[:, c])
                        for c in range(ch_real.shape[1])])


def masked_wasserstein_1d(u: torch.Tensor, u_mask: torch.Tensor, v: torch.Tensor,
                          v_mask: torch.Tensor) -> torch.Tensor:
    """W1 between the masked subsets of two padded sample vectors.

    Entries whose mask is 0 are pushed to +inf before sorting and the CDFs
    renormalise by the true counts (the static-shape form of the JAX
    package). An empty side has no distribution: the result is then 0.
    """
    big = torch.tensor(float("inf"), dtype=u.dtype, device=u.device)
    u_sorted = torch.sort(torch.where(u_mask > 0, u, big)).values
    v_sorted = torch.sort(torch.where(v_mask > 0, v, big)).values
    n_u = torch.clamp(torch.sum(u_mask), min=1.0)
    n_v = torch.clamp(torch.sum(v_mask), min=1.0)

    all_vals = torch.sort(torch.cat([u_sorted, v_sorted])).values
    total = torch.sum(u_mask) + torch.sum(v_mask)
    # only positions strictly inside the valid merged support contribute
    pos = torch.arange(all_vals.shape[0] - 1, device=u.device)
    deltas = torch.where(pos < (total - 1), torch.diff(all_vals), 0.0)
    deltas = torch.where(torch.isfinite(deltas), deltas, 0.0)
    cdf_u = torch.clamp(torch.searchsorted(u_sorted, all_vals[:-1], right=True) / n_u, max=1.0)
    cdf_v = torch.clamp(torch.searchsorted(v_sorted, all_vals[:-1], right=True) / n_v, max=1.0)
    result = torch.sum(torch.abs(cdf_u - cdf_v) * deltas)
    both = (torch.sum(u_mask) > 0) & (torch.sum(v_mask) > 0)
    return torch.where(both, result, torch.zeros_like(result))
