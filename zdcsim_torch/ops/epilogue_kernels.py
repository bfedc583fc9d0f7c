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
"""

from __future__ import annotations

import torch

from zdcsim_torch.ops import _build
from zdcsim_torch.ops.channels import sum_channels

_DTYPES = (torch.float32, torch.bfloat16)


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


def expm1_channel_sums(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` float32/bfloat16 log-space showers -> ``[B, 5]`` float32
    sums of ``expm1(x)`` over the channel masks of ``zdcsim_torch.ops.channels``."""
    _check_images(x, 3, "expm1_channel_sums")
    if x.device.type == "cpu":
        return expm1_channel_sums_plain(x)
    b, h, w = x.shape
    x = x.contiguous()
    out = torch.empty((b, 5), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.zdc_expm1_channel_sums(
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(), b, h, w,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(status, "expm1_channel_sums")
    expm1_channel_sums.launches += 1
    return out


expm1_channel_sums.launches = 0


def routed_expm1_channel_sums_plain(imgs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`routed_expm1_channel_sums`: gather the
    routed rows, then :func:`expm1_channel_sums_plain`; NaN sums for an id
    outside ``[0, E)``, as the kernel writes."""
    e, b = imgs.shape[:2]
    ok = (idx >= 0) & (idx < e)
    rows = imgs[idx.clamp(0, e - 1), torch.arange(b, device=imgs.device)]
    out = expm1_channel_sums_plain(rows)
    return torch.where(ok[:, None], out, torch.full_like(out, float("nan")))


def routed_expm1_channel_sums(imgs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[E, B, H, W]`` float32/bfloat16 log-space images and ``[B]`` int64
    expert ids -> ``[B, 5]`` float32: row ``b`` is
    ``expm1_channel_sums(imgs[idx[b], b])``, NaN where ``idx[b]`` is outside
    ``[0, E)``."""
    _check_images(imgs, 4, "routed_expm1_channel_sums")
    e, b, h, w = imgs.shape
    if idx.dtype != torch.int64 or idx.shape != (b,) or idx.device != imgs.device:
        raise ValueError(f"routed_expm1_channel_sums: idx must be [{b}] int64 on {imgs.device}, "
                         f"got {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    if imgs.device.type == "cpu":
        return routed_expm1_channel_sums_plain(imgs, idx)
    imgs, idx = imgs.contiguous(), idx.contiguous()
    out = torch.empty((b, 5), dtype=torch.float32, device=imgs.device)
    lib = _build.library()
    with torch.cuda.device(imgs.device):
        status = lib.zdc_routed_expm1_channel_sums(
            imgs.data_ptr(), int(imgs.dtype == torch.bfloat16), idx.data_ptr(),
            out.data_ptr(), e, b, h, w, torch.cuda.current_stream(imgs.device).cuda_stream,
        )
    _build.check(status, "routed_expm1_channel_sums")
    routed_expm1_channel_sums.launches += 1
    return out


routed_expm1_channel_sums.launches = 0
