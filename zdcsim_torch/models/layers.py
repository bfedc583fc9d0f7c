"""Shared building blocks (counterpart of ``zdcsim/models/layers.py``).

Functions take NHWC tensors, as the JAX package does. The modules hold their
weights in PyTorch's layout under the Flax names (``Dense_0``,
``LayerNorm_0``, ...) so that ``zdcsim_torch.convert`` maps one tree onto
the other by name. LayerNorm and GroupNorm use Flax's eps of 1e-6, not
PyTorch's 1e-5; ``MaskedBatchNorm`` keeps its own 1e-5.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_EPS = 1e-6
BN_EPS = 1e-5  # MaskedBatchNorm.epsilon (zdcsim/models/layers.py:138)
SN_EPS = 1e-12  # flax.linen.SpectralNorm's epsilon

# a rank's partial sums over the batch's rows -> the global batch's (the train
# step on a mesh passes the data axis's psum; None: the rank holds the batch)
RowSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def upsample_nearest(x: torch.Tensor, scale: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NHWC tensor by integer factors
    (``repeat_interleave`` with int counts: no index tensor, nothing read
    from the host)."""
    return x.repeat_interleave(scale[0], dim=1).repeat_interleave(scale[1], dim=2)


def nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """Source index of each output position, ``floor((i + 0.5) * n_in / n_out)``
    (``jax.image.resize(method='nearest')``; PyTorch's ``nearest-exact``)."""
    return np.floor((np.arange(n_out) + 0.5) * n_in / n_out).astype(np.int64)


def nearest_index_on(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    """:func:`nearest_index` computed on ``device`` in float64 (equal to the
    numpy one): no copy from the host, so a CUDA graph can hold it."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).to(torch.int64)


class _NearestGather(torch.autograd.Function):
    """``index_select`` along ``dim`` by a nearest-resize index; the backward
    adds each source position's (at most ``ceil(n_out / n_in)``) outputs
    by gathers in a fixed order, where ``index_select``'s backward adds
    atomically on CUDA (or, under ``torch.use_deterministic_algorithms``,
    sorts every element)."""

    @staticmethod
    def forward(ctx, x, dim, index):
        ctx.dim, ctx.n_in = dim, x.shape[dim]
        ctx.save_for_backward(index)
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        n_out = g.shape[ctx.dim]
        src = torch.arange(ctx.n_in, device=index.device)
        first = torch.searchsorted(index, src)
        count = torch.searchsorted(index, src, right=True) - first
        shape = [1] * g.ndim
        shape[ctx.dim] = ctx.n_in
        out = None
        for r in range(-(-n_out // ctx.n_in)):
            term = (g.index_select(ctx.dim, torch.clamp(first + r, max=n_out - 1))
                    * (count > r).to(g.dtype).reshape(shape))
            out = term if out is None else out + term
        return out, None, None


def gather_nearest(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, index)`` for a nearest-resize ``index``
    (:func:`nearest_index`: nondecreasing); under autograd, with a backward
    that is deterministic on CUDA and needs no index accumulation."""
    return _NearestGather.apply(x, dim, index)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NHWC tensor to ``size`` by gathering
    rows and columns (exact in every dtype, int8 included)."""
    _, h, w, _ = x.shape
    rows = nearest_index_on(size[0], h, x.device)
    cols = nearest_index_on(size[1], w, x.device)
    return gather_nearest(gather_nearest(x, 1, rows), 2, cols)


def group_norm_groups(channels: int, groups: int = 32) -> int:
    """Largest group count <= ``groups`` dividing ``channels``."""
    g = min(groups, channels)
    while channels % g != 0 and g > 1:
        g -= 1
    return g


class ExpertDense(nn.Module):
    """All-experts batched linear ``[E, B, I] x [E, I, O] -> [E, B, O]``
    (``zdcsim/models/layers.py:229``): ``kernel [E, I, O]`` and ``bias [E,
    1, O]`` in JAX's layout (``zdcsim_torch.convert`` carries a kernel of
    three axes as it is), one batched product. Flax reads the input width at
    the first call; here it is ``in_features``. Initialised as Flax's
    ``lecun_normal(batch_axis=(0,))`` (fan-in ``I``, truncated at two
    standard deviations) and zero biases, not from Flax's draws."""

    def __init__(self, n_experts: int, features: int, use_bias: bool = True, *,
                 in_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_experts, in_features, features))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(n_experts, 1, features)) if use_bias else None)
        std = in_features ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return torch.bmm(x, self.kernel)
        return torch.baddbmm(self.bias, x, self.kernel)


class MLPBlock(nn.Module):
    """Dense + LayerNorm + LeakyReLU(0.1)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.LayerNorm_0 = nn.LayerNorm(features, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.LayerNorm_0(self.Dense_0(x)))


class GroupNorm2d(nn.Module):
    """GroupNorm with the divisor-adjusted group count, on NCHW input."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(
            group_norm_groups(channels, groups), channels, eps=NORM_EPS
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


class MaskedBatchNorm(nn.Module):
    """The JAX ``MaskedBatchNorm`` (``zdcsim/models/layers.py:98``) on a
    feature axis of 1 (``[B, C]`` or NCHW ``[B, C, H, W]``). ``weight``/``bias``
    hold Flax's ``scale``/``bias``; the buffers ``running_mean``/``running_var``
    hold its ``batch_stats`` ``mean``/``var`` (the biased variance, as Flax
    stores it).

    Eval (``train=False``): ``(x - mean) * rsqrt(var + 1e-5) * scale + bias``
    on the running statistics; returns ``y``.

    Train: the statistics of the batch, in float32 and in two passes, each
    sample weighted by ``mask`` (``[B]``, the expert's routing mask; ``None``:
    every sample): ``mean = sum(m x) / cnt``, ``var = sum(m (x - mean)^2) /
    cnt``, ``cnt = max(sum(m) * spatial, 1)``
    (``parallel.collectives.masked_moments``; on a mesh ``sum_rows`` makes
    the sums the global batch's, as JAX's GSPMD statistics are). The rows
    outside the mask
    come out exactly zero (left normalised by another sub-batch's
    statistics, they grow through stacked layers until ``inf * 0`` poisons
    the masked losses). Returns ``(y, new running mean, new running
    var)``, ``0.9 old + 0.1 batch``, detached: the buffers are not written,
    so the caller keeps the statistics, as ``_SpectralNorm`` returns its
    ``u``. Either form computes in float32, or in the input's dtype where
    that is wider (float64: JAX's float32 rule for every dtype it runs), and
    casts ``y`` back to the input's dtype."""

    momentum = 0.9

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False, mask: Optional[torch.Tensor] = None,
                sum_rows: RowSum = None):
        wide = torch.promote_types(x.dtype, torch.float32)
        up = lambda t: t.to(wide)  # noqa: E731
        if not train:
            y = F.batch_norm(up(x), up(self.running_mean), up(self.running_var),
                             up(self.weight), up(self.bias), training=False, eps=BN_EPS)
            return y.to(x.dtype)
        from zdcsim_torch.parallel.collectives import masked_moments

        xf = up(x)
        axes = (0,) + tuple(range(2, x.ndim))
        feat = (1, -1) + (1,) * (x.ndim - 2)  # a per-feature vector against x
        m = None if mask is None else up(mask).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        mean, var, centered = masked_moments(xf, m, axes, sum_rows)
        y = centered * torch.rsqrt(var + BN_EPS).reshape(feat)
        y = y * up(self.weight).reshape(feat) + up(self.bias).reshape(feat)
        if m is not None:
            y = y * m
        keep = self.momentum
        new_mean = keep * up(self.running_mean) + (1.0 - keep) * mean.detach()
        new_var = keep * up(self.running_var) + (1.0 - keep) * var.detach()
        return y.to(x.dtype), new_mean, new_var


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Max pool of an NCHW tensor with VALID padding (``zdcsim/models/layers.py:73``);
    ``strides`` defaults to ``window``."""
    return F.max_pool2d(x, window, strides or window)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax's ``padding="SAME"`` along one axis: ``(low, high)`` such that the
    output has ``ceil(size / stride)`` positions."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``flax.linen.Dropout`` with its keep mask given: ``keep`` (bool, the
    shape of ``x``) keeps ``x / (1 - rate)``; ``None`` is the eval form."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def spectral_normalize(w_mat: torch.Tensor, u: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flax 0.12's ``SpectralNorm._spectral_normalize`` on a kernel flattened
    to ``[K, out]``, one power step: ``v = l2n(u W^T)``, ``u' = l2n(v W)``
    (``u``, ``v`` carry no gradient), ``sigma = v W u'^T`` (its gradient
    reaches ``W``). Returns ``(W / sigma, u' [1, out], sigma)``; a zero
    sigma divides by 1."""
    with torch.no_grad():
        w_d = w_mat.detach()
        v = _l2_normalize(u @ w_d.T)
        u = _l2_normalize(v @ w_d)
    sigma = ((v @ w_mat) @ u.T)[0, 0]
    return w_mat / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), u, sigma


class _SpectralNorm(nn.Module):
    """Shared body of :class:`SNDense` and :class:`SNConv`. The power-iteration
    state lives outside the module: ``forward`` takes the flat stats dict and
    returns ``(y, new entries)``. The keys are Flax's ``batch_stats`` paths
    joined by ``|`` (``SNConv_0|SpectralNorm_0|Conv_0/kernel/u`` and
    ``.../sigma``); ``u`` is ``[1, out]``, ``sigma`` a scalar. The iteration
    runs on every forward; its ``u`` and ``sigma`` are returned as the new
    entries only when ``train``, else the old ones are."""

    inner: str  # the wrapped layer's Flax name
    stats_name: str  # this layer's Flax name in its parent

    def stats_keys(self) -> Tuple[str, str]:
        """The keys of ``u`` and ``sigma`` in the stats dict."""
        base = f"{self.stats_name}|SpectralNorm_0|{self.inner}/kernel"
        return f"{base}/u", f"{base}/sigma"

    def _normalized(self, w_mat: torch.Tensor, stats: Dict[str, torch.Tensor], train: bool
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        ku, ks = self.stats_keys()
        w_n, u, sigma = spectral_normalize(w_mat, stats[ku])
        new = {ku: u, ks: sigma.detach()} if train else {ku: stats[ku], ks: stats[ks]}
        return w_n, new


class SNDense(_SpectralNorm):
    """Spectrally normalised Dense (``zdcsim/models/layers.py:197``); ``name``
    is its Flax name in the parent (``SNDense_0``)."""

    inner = "Dense_0"

    def __init__(self, in_features: int, features: int, name: str):
        super().__init__()
        self.stats_name = name
        self.Dense_0 = nn.Linear(in_features, features)

    def forward(self, x: torch.Tensor, stats: Dict[str, torch.Tensor], train: bool = True):
        w_n, new = self._normalized(self.Dense_0.weight.T, stats, train)  # [in, out]
        return x @ w_n + self.Dense_0.bias, new


class SNConv(_SpectralNorm):
    """Spectrally normalised Conv with VALID padding on NCHW input
    (``zdcsim/models/layers.py:210``). The kernel is flattened in Flax's HWIO
    row order, so ``v`` is Flax's vector."""

    inner = "Conv_0"

    def __init__(self, in_features: int, features: int, kernel_size: int, name: str,
                 strides: int = 1):
        super().__init__()
        self.stats_name = name
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size, stride=strides)

    def forward(self, x: torch.Tensor, stats: Dict[str, torch.Tensor], train: bool = True):
        w = self.Conv_0.weight  # OIHW
        w_mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])  # HWIO flattened: [K, out]
        w_n, new = self._normalized(w_mat, stats, train)
        w_n = w_n.reshape(w.shape[2], w.shape[3], w.shape[1], w.shape[0]).permute(3, 2, 0, 1)
        return F.conv2d(x, w_n, self.Conv_0.bias, stride=self.Conv_0.stride), new
