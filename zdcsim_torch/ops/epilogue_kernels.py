"""The fused expm1 + 5-channel-sum epilogues, with their plain versions
(counterpart of ``zdcsim/ops/pallas_kernels.py``).

- :func:`expm1_channel_sums` replaces Pallas kernel E: ``[B, H, W]``
  log-space showers -> ``[B, 5]`` channel sums of ``expm1`` of them, with no
  linear-space image written (the fidelity gate's real side).
- :func:`routed_expm1_channel_sums` replaces Pallas kernel F: the same on
  the routed expert's row of an all-expert ``[E, B, H, W]`` decode, reading
  only that row.

Both launch one hand-written CUDA source (``zdcsim_torch/csrc/
expm1_channel_sums.cu``) for a CUDA tensor and run the plain PyTorch version
for a CPU tensor; neither falls back from one to the other.
``<wrapper>.launches`` counts the kernel's launches (plain runs and CPU
calls do not count).

The source has two bodies, which :func:`bulk_fits` chooses by shape before
the launch. Where a shower is a multiple of 16 bytes on a 16-byte-aligned
base (56x30 and 44x44 in f32 and bf16), the bulk body: a persistent grid of
one wave, which the C entry point plans, whose blocks copy whole showers
into a ring in shared memory with TMA bulk copies and sum each row half with
its channel fixed, a warp a shower. Any other shape, or an unaligned view, takes the
direct body, one warp per shower reading device memory itself. E and F
share each body, so F on a routed row gives E's bits.
``<wrapper>.bulk_launches`` counts the launches that the C entry point
reports on the bulk body.
"""

from __future__ import annotations

import ctypes

import torch

from zdcsim_torch.ops import _build
from zdcsim_torch.ops.channels import sum_channels

_DTYPES = (torch.float32, torch.bfloat16)

# The largest shower, in bytes, that the bulk body takes (kMaxBulkShower of
# csrc/expm1_channel_sums.cu): each consumer warp's two slots fit a block.
BULK_MAX_SHOWER = 1 << 16


def bulk_fits(h: int, w: int, dtype: torch.dtype, data_ptr: int) -> bool:
    """True where the bulk body takes showers of ``h x w`` in ``dtype`` at
    ``data_ptr``: a TMA bulk copy moves a multiple of 16 bytes between
    16-byte-aligned addresses, and a shower is at most
    :data:`BULK_MAX_SHOWER` bytes."""
    n_bytes = h * w * (2 if dtype == torch.bfloat16 else 4)
    return n_bytes % 16 == 0 and n_bytes <= BULK_MAX_SHOWER and data_ptr % 16 == 0


def _launch(entry, x: torch.Tensor, args, direct_body: bool, name: str) -> int:
    """Calls the C entry ``entry(x, bf16, *args, bulk, &grid, stream)`` with
    the bulk body where :func:`bulk_fits` (and not ``direct_body``), checks
    its status and returns the bulk grid it reports (0: the direct body)."""
    h, w = x.shape[-2:]
    bulk = not direct_body and bulk_fits(h, w, x.dtype, x.data_ptr())
    grid = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        status = entry(x.data_ptr(), int(x.dtype == torch.bfloat16), *args, int(bulk),
                       ctypes.addressof(grid), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    return grid.value


def _check_images(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.ndim != ndim or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: expected a {ndim}-D float32/bfloat16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")


def expm1_channel_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`expm1_channel_sums`:
    ``sum_channels(expm1(x))`` in float32."""
    return sum_channels(torch.expm1(x.to(torch.float32)))


def expm1_channel_sums(x: torch.Tensor, _direct_body: bool = False) -> torch.Tensor:
    """``[B, H, W]`` float32/bfloat16 log-space showers -> ``[B, 5]`` float32
    sums of ``expm1(x)`` over the channel masks of ``zdcsim_torch.ops.channels``.
    ``_direct_body`` (debug only, to time the direct body beside the bulk one)
    runs the direct body on any shape."""
    _check_images(x, 3, "expm1_channel_sums")
    if x.device.type == "cpu":
        return expm1_channel_sums_plain(x)
    b, h, w = x.shape
    x = x.contiguous()
    out = torch.empty((b, 5), dtype=torch.float32, device=x.device)
    grid = _launch(_build.library().zdc_expm1_channel_sums, x, (out.data_ptr(), b, h, w),
                   _direct_body, "expm1_channel_sums")
    expm1_channel_sums.launches += 1
    expm1_channel_sums.bulk_launches += int(grid > 0)
    return out


expm1_channel_sums.launches = expm1_channel_sums.bulk_launches = 0


def routed_expm1_channel_sums_plain(imgs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`routed_expm1_channel_sums`: gather the
    routed rows, then :func:`expm1_channel_sums_plain`; NaN sums for an id
    outside ``[0, E)``, as the kernel writes."""
    e, b = imgs.shape[:2]
    ok = (idx >= 0) & (idx < e)
    rows = imgs[idx.clamp(0, e - 1), torch.arange(b, device=imgs.device)]
    out = expm1_channel_sums_plain(rows)
    return torch.where(ok[:, None], out, torch.full_like(out, float("nan")))


def routed_expm1_channel_sums(imgs: torch.Tensor, idx: torch.Tensor,
                              _direct_body: bool = False) -> torch.Tensor:
    """``[E, B, H, W]`` float32/bfloat16 log-space images and ``[B]`` int64
    expert ids -> ``[B, 5]`` float32: row ``b`` is
    ``expm1_channel_sums(imgs[idx[b], b])``, NaN where ``idx[b]`` is outside
    ``[0, E)``. ``_direct_body`` as for :func:`expm1_channel_sums`."""
    _check_images(imgs, 4, "routed_expm1_channel_sums")
    e, b, h, w = imgs.shape
    if idx.dtype != torch.int64 or idx.shape != (b,) or idx.device != imgs.device:
        raise ValueError(f"routed_expm1_channel_sums: idx must be [{b}] int64 on {imgs.device}, "
                         f"got {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    if imgs.device.type == "cpu":
        return routed_expm1_channel_sums_plain(imgs, idx)
    imgs, idx = imgs.contiguous(), idx.contiguous()
    out = torch.empty((b, 5), dtype=torch.float32, device=imgs.device)
    grid = _launch(_build.library().zdc_routed_expm1_channel_sums, imgs,
                   (idx.data_ptr(), out.data_ptr(), e, b, h, w), _direct_body,
                   "routed_expm1_channel_sums")
    routed_expm1_channel_sums.launches += 1
    routed_expm1_channel_sums.bulk_launches += int(grid > 0)
    return out


routed_expm1_channel_sums.launches = routed_expm1_channel_sums.bulk_launches = 0
