"""The int8 serving-decode kernels of the ``pallas_ab`` and ``pallas`` paths,
with their plain versions (counterpart of ``zdcsim/ops/pallas_decode.py``).

- :func:`ln_leaky_rowquant` replaces Pallas kernel A: per-row LayerNorm
  (f32 statistics, centred variance, eps 1e-6) -> scale/bias ->
  LeakyReLU(0.1) -> per-row symmetric int8.
- :func:`up2_conv4_int8` replaces Pallas kernel B: nearest-2x upsample +
  4x4 pad-1 conv as 25 parity-phase int8 taps with int32 sums, per-phase and
  per-cout dequant x per-sample scale + bias, and the 2x2 interleave.
- :func:`gn_leaky_rowquant` replaces Pallas kernel C: GroupNorm (one-pass
  f32 statistics per sample and group, eps 1e-6) -> scale/bias ->
  LeakyReLU(0.1) -> per-sample symmetric int8.
- :func:`row_resize_conv4_int8` replaces Pallas kernel D: the nearest row
  resize 35 -> 56 folded into the 4x4 pad-1 conv by 8 row phases, int32
  sums, per-phase and per-cout dequant x per-sample scale + bias, written
  into the interleaved rows.

Each wrapper launches its hand-written CUDA kernel (``zdcsim_torch/csrc``)
for a CUDA tensor, and runs the plain PyTorch version for a CPU tensor; it
never falls back from one to the other. ``<wrapper>.launches`` counts the
kernel's launches (plain runs and CPU calls do not count).

A and C run as thread-block clusters: k blocks on neighbouring SMs share
each sample and exchange partial sums through distributed shared memory.
:func:`norm_quant_plan` chooses k, the threads and the shared memory of a
block; ``<wrapper>.cluster_launches`` counts the launches that the C entry
point reports in clusters of the plan's k with the plan's body (the share
kept in shared memory, or streamed where it does not fit).

B and D take their int8 weights packed once as ``[Cout, taps x Cin]``
(:func:`pack_k_major`; ``proton_fast.quantize_weights`` packs them per
expert), and each has two CUDA bodies, which the C entry point chooses by
shape: for Cin a multiple of 128 and Cout of 64 (``conv_mma_fits``; the
full-width teacher) the implicit GEMM on the int8 tensor cores that kernels G
and H run (``csrc/conv_mma.cuh``), for any other width the first ``__dp4a``
kernel. Both are exact, so both equal the plain version bit for bit.
``<wrapper>.mma_launches`` counts the launches that the entry point reports
on the tensor cores.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from zdcsim_torch.ops import _build

# Phase p = 2*pr + pc covers output pixels (2i+pr, 2j+pc); its (a, b) tap
# reads source offset (dr, dc) listed here (pallas_decode.py:122-128).
_PHASE_OFFSETS = {
    "ee": [(a - 1, b - 1) for a in range(3) for b in range(3)],
    "eo": [(a - 1, b) for a in range(3) for b in range(2)],
    "oe": [(a, b - 1) for a in range(2) for b in range(3)],
    "oo": [(a, b) for a in range(2) for b in range(2)],
}
_PHASES = ("ee", "eo", "oe", "oo")


def _phase_kernels(w: torch.Tensor) -> dict:
    """Original ``[4, 4, cin, cout]`` kernel -> the four merged phase kernels
    (computed in ``w``'s dtype, in the JAX package's order of additions)."""
    k_er = torch.stack([w[0], w[1] + w[2], w[3]])
    k_or = torch.stack([w[0] + w[1], w[2] + w[3]])

    def split_cols(k):
        ke = torch.stack([k[:, 0], k[:, 1] + k[:, 2], k[:, 3]], dim=1)
        ko = torch.stack([k[:, 0] + k[:, 1], k[:, 2] + k[:, 3]], dim=1)
        return ke, ko

    k_ee, k_eo = split_cols(k_er)
    k_oe, k_oo = split_cols(k_or)
    return {"ee": k_ee, "eo": k_eo, "oe": k_oe, "oo": k_oo}


def _quant_phases(w: torch.Tensor):
    """Merge in float32, quantize each phase kernel per output channel, flatten
    the taps: ``(kq [25, cin, cout] int8, sk [4, cout] f32)`` in
    ``_PHASES`` / ``_PHASE_OFFSETS`` order."""
    ks = _phase_kernels(w.to(torch.float32))
    taps, scales = [], []
    for name in _PHASES:
        k = ks[name]
        s = torch.clamp(k.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(k / s), -127, 127).to(torch.int8)
        taps.append(q.reshape(k.shape[0] * k.shape[1], k.shape[2], k.shape[3]))
        scales.append(s)
    return torch.cat(taps, dim=0), torch.stack(scales)


def interleave_phases(phases: torch.Tensor) -> torch.Tensor:
    """``[4, B, H, W, C]`` phase outputs on the source grid (``_PHASES``
    order) -> ``[B, 2H-1, 2W-1, C]``; the odd phases' last row/column falls
    outside the output and is trimmed."""
    _, b, h, w, c = phases.shape
    out = phases.reshape(2, 2, b, h, w, c).permute(2, 3, 0, 4, 1, 5)
    return out.reshape(b, 2 * h, 2 * w, c)[:, : 2 * h - 1, : 2 * w - 1]


def pack_k_major(kq: torch.Tensor) -> torch.Tensor:
    """``[taps..., Cin, Cout]`` int8 -> ``[Cout, taps x Cin]``, contiguous
    in K, taps major: the layout the int8 convs read (each K step of the
    tensor-core body is consecutive channels of one tap, each 32-bit word of
    the ``__dp4a`` body 4 of them)."""
    return kq.reshape(-1, kq.shape[-1]).t().contiguous()


def unpack_k_major(kp: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of :func:`pack_k_major`: a view of ``kp`` in the logical
    ``shape`` (``[taps..., Cin, Cout]``)."""
    return kp.t().reshape(shape)


def _check_packed(name: str, key: str, kp: torch.Tensor, taps: int, cin: int,
                  dev: torch.device, cout: int = None) -> int:
    """Refuse weights that are not :func:`pack_k_major`'s ``[Cout, taps x
    Cin]`` int8 on ``dev`` (of ``cout`` channels, where given); returns
    Cout."""
    n = "Cout" if cout is None else cout
    if (kp.dtype != torch.int8 or kp.ndim != 2 or kp.shape[1] != taps * cin
            or kp.device != dev or (cout is not None and kp.shape[0] != cout)):
        raise ValueError(f"{name}: {key} must be [{n}, {taps * cin}] int8 on {dev} (pack_k_major "
                         f"of [{taps} taps, {cin}, {n}]), got {tuple(kp.shape)} {kp.dtype} "
                         f"on {kp.device}")
    return kp.shape[0]


def _require_aligned(name, align, **params):
    """The tensor-core convs copy int8 operands 16 bytes at a time and read
    sk and bias as float2, from aligned addresses (a view with an offset may
    not be)."""
    for key, t in params.items():
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {key} must be {align}-byte aligned on the card")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")


def _require_f32(name: str, dev: torch.device, **params: torch.Tensor) -> None:
    """The kernels' per-channel parameters are float32 tensors on the data's
    device; callers cast them once (``proton_fast.quantize_weights``)."""
    for key, t in params.items():
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: {key} must be float32 on {dev}, got {t.dtype} on {t.device}")


# ---------------------------------------------------------------------------
# The launch plan of kernels A and C: thread-block clusters
# ---------------------------------------------------------------------------

CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
N_SMS = 132  # streaming multiprocessors of the H100 SXM
# Clusters of k blocks the H100 SXM holds at once at one block an SM
# (cudaOccupancyMaxActiveClusters, chip_smoke.py phase 9): a cluster lives in
# one GPC, and the GPCs' SM counts leave 12 SMs unused at k = 4 and 8.
ONE_WAVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
SMEM_PER_BLOCK = 232448  # 227 KB, the most shared memory one block may use
# csrc/cluster_norm.cuh kMaxDynSmem: 1 KB is left for static shared memory
MAX_DYN_SMEM = SMEM_PER_BLOCK - 1024
LN_UNIT = 4  # elements a thread of A takes at a time on aligned rows
LN_SHARE = 16  # A's share of a row is a multiple of 16 elements
LN_MAX_THREADS = 1024
GN_THREADS = 512


class NormQuantPlan(NamedTuple):
    """A launch of kernel A or C: ``k`` blocks, one cluster, per sample, of
    ``threads`` threads and ``smem`` bytes of dynamic shared memory each;
    ``kept``: each block keeps its share of the sample in shared memory
    (else it streams it from device memory in every pass)."""

    k: int
    threads: int
    smem: int
    kept: bool


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _block_plan(kind: str, sample, elem_bytes: int, k: int) -> NormQuantPlan:
    """One block's share at cluster size ``k``, as the C entry points lay it
    out. A keeps its share of the row as f32 (z is written over it), one
    4-element unit a thread at a time; C keeps ``ceil(HW / k)`` pixels as
    they lie, beside its fixed reduction space."""
    if kind == "ln":
        (f,) = sample
        share = _ceil_div(_ceil_div(f, k), LN_SHARE) * LN_SHARE
        keep, fixed = share * 4, 0
        threads = min(LN_MAX_THREADS, _ceil_div(share // LN_UNIT, 32) * 32)
    else:
        hw, c = sample
        threads = GN_THREADS
        keep = _ceil_div(hw, k) * c * elem_bytes
        fixed = 4 * (threads * 8 + 10 * c)
    kept = keep + fixed <= MAX_DYN_SMEM
    return NormQuantPlan(k, threads, (keep if kept else 0) + fixed, kept)


def gn_channels_ok(c: int) -> bool:
    """Kernel C takes C a multiple of 8 with C / 8 dividing 128 (one
    channel block of 8 a thread, a whole number of pixels a pass)."""
    return c > 0 and c % 8 == 0 and 128 % (c // 8) == 0


def norm_quant_plan(kind: str, b: int, sample, elem_bytes: int,
                    k: Optional[int] = None) -> NormQuantPlan:
    """The launch of kernel A (``kind="ln"``, ``sample=(F,)``) or C
    (``"gn"``, ``sample=(HW, C)``) on ``b`` samples of ``elem_bytes``-byte
    elements. Among the cluster sizes of :data:`CLUSTER_SIZES` at which a
    block's share fits in shared memory: the largest whose ``b`` clusters
    the card holds in one wave (:data:`ONE_WAVE_CLUSTERS`), which spreads
    each sample over the most SMs; where none does, the smallest, whose
    waves are fullest; where no share fits, k = 8, which streams the
    smallest share. ``k`` sets the cluster size instead. Raises
    ``ValueError`` on a C that kernel C refuses and on any other ``k``."""
    if kind not in ("ln", "gn"):
        raise ValueError(f"norm_quant_plan: kind must be 'ln' or 'gn', got {kind!r}")
    if kind == "gn" and not gn_channels_ok(sample[1]):
        raise ValueError(f"gn_leaky_rowquant: C={sample[1]} must be a multiple of 8 with C/8 "
                         "dividing 128")
    if k is not None:
        if k not in CLUSTER_SIZES:
            raise ValueError(f"norm_quant_plan: k must be one of {CLUSTER_SIZES}, got {k}")
        return _block_plan(kind, sample, elem_bytes, k)
    plans = [_block_plan(kind, sample, elem_bytes, kk) for kk in CLUSTER_SIZES]
    kept = [p for p in plans if p.kept]
    if not kept:
        return plans[-1]
    one_wave = [p for p in kept if b <= ONE_WAVE_CLUSTERS[p.k]]
    return one_wave[-1] if one_wave else kept[0]


def norm_quant_max_clusters(kind: str, dtype: torch.dtype, sample, k: int) -> int:
    """How many clusters of kernel A's or C's launch at cluster size ``k``
    the current card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    bf16 = int(dtype == torch.bfloat16)
    plan = norm_quant_plan(kind, 1, sample, 2 if bf16 else 4, k)
    n = ctypes.c_int(0)
    lib = _build.library()
    if kind == "ln":
        status = lib.zdc_ln_leaky_rowquant_max_clusters(bf16, sample[0], k, plan.threads,
                                                        ctypes.addressof(n))
    else:
        status = lib.zdc_gn_leaky_rowquant_max_clusters(bf16, *sample, k, plan.threads,
                                                        ctypes.addressof(n))
    _build.check(status, f"norm_quant_max_clusters({kind!r})")
    return n.value


def _count_cluster_launch(wrapper, plan: NormQuantPlan, cluster_k: ctypes.c_int,
                          kept: ctypes.c_int) -> None:
    wrapper.launches += 1
    wrapper.cluster_launches += int(cluster_k.value == plan.k and bool(kept.value) == plan.kept)


# ---------------------------------------------------------------------------
# Kernel A: LayerNorm + LeakyReLU + per-row int8
# ---------------------------------------------------------------------------

def ln_leaky_rowquant_plain(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """Plain PyTorch version of :func:`ln_leaky_rowquant`, op for op the
    kernel's arithmetic (its sums run in another order)."""
    y = y.to(torch.float32)
    mu = y.mean(dim=1, keepdim=True)
    d = y - mu
    var = (d * d).mean(dim=1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + 1e-6)
    z = d * rstd
    z = z * scale + bias
    z = torch.where(z >= 0, z, 0.1 * z)
    s = torch.clamp(z.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(z / s), -127, 127).to(torch.int8)
    return q, s


def ln_leaky_rowquant(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                      k: Optional[int] = None):
    """``LayerNorm(y) * scale + bias -> LeakyReLU(0.1) -> per-row int8``.

    y: ``[B, F]`` bf16 or f32; scale, bias: ``[F]`` f32. Returns ``(q [B, F] int8, s [B, 1] f32)`` with row ``i``
    ``~= q[i] * s[i]``. On the card each row runs on a cluster of
    :func:`norm_quant_plan`'s k blocks; ``k`` sets another cluster size.
    """
    _require_f32("ln_leaky_rowquant", y.device, scale=scale, bias=bias)
    if y.device.type == "cpu":
        return ln_leaky_rowquant_plain(y, scale, bias)
    _require_cuda(y, "ln_leaky_rowquant")
    if y.ndim != 2 or y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ln_leaky_rowquant: y must be 2-D bf16/f32, got {tuple(y.shape)} {y.dtype}")
    b, f = y.shape
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError("ln_leaky_rowquant: scale and bias must be [F]")
    y, scale, bias = y.contiguous(), scale.contiguous(), bias.contiguous()
    q = torch.empty((b, f), dtype=torch.int8, device=y.device)
    s = torch.empty((b, 1), dtype=torch.float32, device=y.device)
    plan = norm_quant_plan("ln", b, (f,), y.element_size(), k)
    cluster_k, kept = ctypes.c_int(0), ctypes.c_int(0)
    lib = _build.library()
    with torch.cuda.device(y.device):
        status = lib.zdc_ln_leaky_rowquant(
            y.data_ptr(), int(y.dtype == torch.bfloat16), scale.data_ptr(),
            bias.data_ptr(), q.data_ptr(), s.data_ptr(), b, f, plan.k, plan.threads,
            ctypes.addressof(cluster_k), ctypes.addressof(kept), _stream(y),
        )
    _build.check(status, "ln_leaky_rowquant")
    _count_cluster_launch(ln_leaky_rowquant, plan, cluster_k, kept)
    return q, s


ln_leaky_rowquant.launches = ln_leaky_rowquant.cluster_launches = 0


# ---------------------------------------------------------------------------
# Kernel B: all-phase int8 upsample2 + conv4, fused dequant + interleave
# ---------------------------------------------------------------------------

def up2_conv4_int8_plain(xq, sx, kp, sk, bias, out_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`up2_conv4_int8`: the packed weights read
    back through :func:`unpack_k_major`, each phase's taps as shifted float64
    matmuls of the int8 values (exact: every partial sum is an integer below
    2**53), then the kernel's f32 epilogue."""
    b, h, w, cin = xq.shape
    cout = kp.shape[0]
    xp = F.pad(xq.to(torch.float64), (0, 0, 1, 1, 1, 1))  # zero halo of 1
    k64 = unpack_k_major(kp, (25, cin, cout)).to(torch.float64)
    sxb = sx.reshape(b, 1, 1, 1)
    phases, tap = [], 0
    for p, name in enumerate(_PHASES):
        acc = torch.zeros((b, h, w, cout), dtype=torch.float64, device=xq.device)
        for dr, dc in _PHASE_OFFSETS[name]:
            acc += xp[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w, :] @ k64[tap]
            tap += 1
        val = acc.to(torch.float32) * sk[p] * sxb + bias
        phases.append(val.to(out_dtype))
    return interleave_phases(torch.stack(phases))


def up2_conv4_int8(xq, sx, kp, sk, bias, out_dtype=torch.bfloat16):
    """``conv4x4(pad1, nearest_up2(x))`` on int8 data.

    xq: ``[B, H, W, Cin]`` int8 (Cin a multiple of 4); sx: ``[B]`` or
    ``[B, 1]`` f32 per-sample dequant scales; kp, sk: the phase-merged int8
    kernel of :func:`_quant_phases`, packed by :func:`pack_k_major`
    (``[Cout, 25 x Cin]``), and its f32 scales ``[4, Cout]``; bias:
    ``[Cout]`` f32. Returns ``[B, 2H-1, 2W-1, Cout]`` in ``out_dtype`` (bf16
    or f32). H, W, Cin and Cout come from the tensors.
    """
    name = "up2_conv4_int8"
    _require_f32(name, xq.device, sx=sx, sk=sk, bias=bias)
    if xq.ndim != 4 or xq.dtype != torch.int8:
        raise ValueError(f"{name}: xq must be [B, H, W, Cin] int8, "
                         f"got {tuple(xq.shape)} {xq.dtype}")
    b, h, w, cin = xq.shape
    cout = _check_packed(name, "kp", kp, 25, cin, xq.device)
    if sk.shape != (4, cout) or bias.shape != (cout,) or sx.numel() != b:
        raise ValueError(f"{name}: sk must be [4, Cout], bias [Cout], sx [B]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bf16 or f32, got {out_dtype}")
    if xq.device.type == "cpu":
        return up2_conv4_int8_plain(xq, sx, kp, sk, bias, out_dtype)
    _require_cuda(xq, name)
    if cin % 4 != 0:
        raise ValueError(f"{name}: Cin={cin} must be a multiple of 4")
    dev = xq.device
    xq, kp = xq.contiguous(), kp.contiguous()
    sx, sk, bias = sx.reshape(b).contiguous(), sk.contiguous(), bias.contiguous()
    _require_aligned(name, 16, xq=xq, kp=kp)
    _require_aligned(name, 8, sk=sk, bias=bias)
    out = torch.empty((b, 2 * h - 1, 2 * w - 1, cout), dtype=out_dtype, device=dev)
    on_mma = ctypes.c_int(0)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.zdc_up2_conv4_int8(
            xq.data_ptr(), sx.data_ptr(), kp.data_ptr(), sk.data_ptr(), bias.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w, cin, cout,
            ctypes.addressof(on_mma), _stream(xq),
        )
    _build.check(status, name)
    up2_conv4_int8.launches += 1
    up2_conv4_int8.mma_launches += on_mma.value
    return out


up2_conv4_int8.launches = up2_conv4_int8.mma_launches = 0


# ---------------------------------------------------------------------------
# Kernel C: GroupNorm + LeakyReLU + per-sample int8
# ---------------------------------------------------------------------------

def gn_leaky_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 32) -> torch.Tensor:
    """GroupNorm (one-pass f32 statistics per sample and group, eps 1e-6) ->
    scale/bias -> LeakyReLU(0.1) of ``[B, H, W, C]``, in f32. The JAX kernels
    take ``lax.rsqrt``; this version and the CUDA kernels take the IEEE
    ``1 / sqrt``, as kernel A does."""
    b, h, w, c = x.shape
    x = x.to(torch.float32)
    xg = x.reshape(b, h * w, groups, c // groups)
    n = float(h * w * (c // groups))
    mu = xg.sum(dim=(1, 3)) / n  # [B, G]
    var = torch.clamp((xg * xg).sum(dim=(1, 3)) / n - mu * mu, min=0.0)
    rstd = 1.0 / torch.sqrt(var + 1e-6)
    y = (xg - mu[:, None, :, None]) * rstd[:, None, :, None]
    y = y.reshape(b, h, w, c) * scale + bias
    return torch.where(y >= 0, y, 0.1 * y)


def gn_leaky_rowquant_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            groups: int = 32):
    """Plain PyTorch version of :func:`gn_leaky_rowquant`, op for op the
    kernel's arithmetic (its sums run in another order):
    :func:`gn_leaky_plain`, then the per-sample int8."""
    b = x.shape[0]
    y = gn_leaky_plain(x, scale, bias, groups)
    s = torch.clamp(y.abs().amax(dim=(1, 2, 3)).reshape(b, 1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(y / s.reshape(b, 1, 1, 1)), -127, 127).to(torch.int8)
    return q, s


def gn_leaky_rowquant(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      groups: int = 32, *, k: Optional[int] = None):
    """``GroupNorm(x) * scale + bias -> LeakyReLU(0.1) -> per-sample int8``.

    x: ``[B, H, W, C]`` bf16 or f32, NHWC; statistics per sample and group of
    ``C / groups`` consecutive channels over H, W and the group's channels,
    one pass in f32 (``var = max(E[x^2] - E[x]^2, 0)``), eps 1e-6. scale,
    bias: ``[C]`` f32. Returns ``(q [B, H, W, C] int8, s [B, 1] f32)`` with
    sample ``i`` ``~= q[i] * s[i]``. On the card each sample runs on a
    cluster of :func:`norm_quant_plan`'s k blocks; ``k`` sets another
    cluster size.
    """
    _require_f32("gn_leaky_rowquant", x.device, scale=scale, bias=bias)
    if x.ndim != 4 or x.shape[-1] % groups:
        raise ValueError(f"gn_leaky_rowquant: x must be [B, H, W, C] with C % {groups} == 0, "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return gn_leaky_rowquant_plain(x, scale, bias, groups)
    _require_cuda(x, "gn_leaky_rowquant")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gn_leaky_rowquant: x must be bf16/f32, got {x.dtype}")
    b, h, w, c = x.shape
    plan = norm_quant_plan("gn", b, (h * w, c), x.element_size(), k)
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("gn_leaky_rowquant: scale and bias must be [C]")
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("gn_leaky_rowquant: x must be 16-byte aligned")
    q = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    s = torch.empty((b, 1), dtype=torch.float32, device=x.device)
    cluster_k, kept = ctypes.c_int(0), ctypes.c_int(0)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.zdc_gn_leaky_rowquant(
            x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(), bias.data_ptr(),
            q.data_ptr(), s.data_ptr(), b, h * w, c, groups, plan.k, plan.threads,
            ctypes.addressof(cluster_k), ctypes.addressof(kept), _stream(x),
        )
    _build.check(status, "gn_leaky_rowquant")
    _count_cluster_launch(gn_leaky_rowquant, plan, cluster_k, kept)
    return q, s


gn_leaky_rowquant.launches = gn_leaky_rowquant.cluster_launches = 0


# ---------------------------------------------------------------------------
# Kernel D: int8 row-resize conv (Conv_1), fused dequant + row interleave
# ---------------------------------------------------------------------------

def _quant_row_phases(w: torch.Tensor, plans):
    """Per-phase merged row-group kernels of a ``_row_phase_plan``, zero-padded
    to a uniform group count and quantized per phase and per cout.

    w: ``[4, 4, Cin, Cout]``; the merge runs in float32 in the JAX order of
    additions (``sum(w[a] for a in taps)``). Returns ``(kq [Q, maxL*4, Cin,
    Cout] int8, sk [Q, Cout] f32, offsets [Q][maxL])``: tap ``l*4 + b`` of
    phase ``p`` reads source row offset ``offsets[p][l]`` and column shift
    ``b - 1``; a padded group repeats the phase's first offset.
    """
    w = w.to(torch.float32)
    max_l = max(len(groups) for _, groups, _ in plans)
    kqs, sks, offsets = [], [], []
    for _, groups, _ in plans:
        ks = [sum(w[a] for a in taps) for _, taps in groups]
        ks += [torch.zeros_like(ks[0])] * (max_l - len(ks))
        k_p = torch.stack(ks)  # [maxL, 4, Cin, Cout]
        s = torch.clamp(k_p.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
        kqs.append(torch.clamp(torch.round(k_p / s), -127, 127).to(torch.int8)
                   .reshape(max_l * 4, *k_p.shape[2:]))
        sks.append(s)
        offsets.append([int(d) for d, _ in groups] + [int(groups[0][0])] * (max_l - len(groups)))
    return torch.stack(kqs), torch.stack(sks), offsets


def _row_plan_periods(h_src: int, n_resized_rows: int, name: str):
    """``(q, p)`` of the resize ``h_src -> n_resized_rows``; the kernel, like
    the JAX one, is specialised to the stride-5 plan of 35 -> 56."""
    g = math.gcd(h_src, n_resized_rows)
    p_num, q = h_src // g, n_resized_rows // g
    if p_num != 5:
        raise ValueError(f"{name}: only the stride-5 row plan (35 -> 56) is supported, "
                         f"got {h_src} -> {n_resized_rows} (stride {p_num})")
    return q, p_num


def row_phase_groups(offsets) -> list:
    """The real group count of each phase of a :func:`_quant_row_phases`
    offset table, whose groups must read consecutive source rows (``d0, d0 +
    1, ..``; the zero-padded groups after them repeat ``d0``), as the
    tensor-core body of kernel D reads them. Raises ``ValueError`` otherwise."""
    groups = []
    for p, row in enumerate(offsets):
        d0, n = int(row[0]), 1
        while n < len(row) and int(row[n]) == d0 + n:
            n += 1
        if any(int(d) != d0 for d in row[n:]):
            raise ValueError(f"row_resize_conv4_int8: the groups of phase {p} must read "
                             f"consecutive source rows, then pad with {d0}: got {list(row)}")
        groups.append(n)
    return groups


def row_resize_conv4_int8_plain(xq, sx, kp, sk, offsets, bias, n_resized_rows,
                                out_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`row_resize_conv4_int8`: the packed
    weights read back through :func:`unpack_k_major`, each phase's taps as
    shifted float64 matmuls of the int8 values (exact), then the kernel's f32
    epilogue."""
    b, h, w, cin = xq.shape
    q, p_num = _row_plan_periods(h, n_resized_rows, "row_resize_conv4_int8_plain")
    n_rows = n_resized_rows - 1
    max_l, cout = len(offsets[0]), kp.shape[0]
    x64 = F.pad(xq.to(torch.float64), (0, 0, 1, 2))  # column taps j-1 .. j+2
    k64 = unpack_k_major(kp, (q, max_l * 4, cin, cout)).to(torch.float64)
    sxb = sx.reshape(b, 1, 1, 1)
    out = torch.empty((b, n_rows, w, cout), dtype=out_dtype, device=xq.device)
    for p in range(q):
        n_phase = (n_rows - p + q - 1) // q
        acc = torch.zeros((b, n_phase, w, cout), dtype=torch.float64, device=xq.device)
        for l in range(max_l):
            src = p_num * torch.arange(n_phase, device=xq.device) + offsets[p][l]
            valid = (src >= 0) & (src < h)
            rows = x64.index_select(1, src.clamp(0, h - 1)) * valid.reshape(1, -1, 1, 1)
            for bc in range(4):
                acc += rows[:, :, bc:bc + w] @ k64[p, l * 4 + bc]
        val = acc.to(torch.float32) * sk[p] * sxb + bias
        out[:, p::q] = val.to(out_dtype)
    return out


def row_resize_conv4_int8(xq, sx, kp, sk, offsets, bias, n_resized_rows,
                          out_dtype=torch.bfloat16):
    """``conv4x4(pad1, resize_rows(x, n_resized_rows))`` on int8 data.

    xq: ``[B, H_src, W, Cin]`` int8 with the columns already resized (Cin a
    multiple of 4); sx: ``[B]`` or ``[B, 1]`` f32 per-sample scales; kp, sk,
    offsets: :func:`_quant_row_phases` of the Conv_1 kernel, its int8 kernel
    packed by :func:`pack_k_major` (``[Cout, Q x maxL x 4 x Cin]``); bias:
    ``[Cout]`` f32. Output row ``i = r * Q + p`` sums phase ``p``'s merged
    row groups (source row ``5 r + offsets[p][l]``), the 4 column taps
    ``j-1 .. j+2`` and every channel; taps off the source grid read zero.
    Returns ``[B, n_resized_rows - 1, W, Cout]`` in ``out_dtype`` (bf16 or
    f32); callers trim to the conv-valid ``W - 1`` columns. Only the stride-5
    plan of 35 -> 56 is supported, as in JAX.
    """
    name = "row_resize_conv4_int8"
    _require_f32(name, xq.device, sx=sx, sk=sk, bias=bias)
    if xq.ndim != 4 or xq.dtype != torch.int8:
        raise ValueError(f"{name}: xq must be [B, H, W, Cin] int8, "
                         f"got {tuple(xq.shape)} {xq.dtype}")
    b, h, w, cin = xq.shape
    q, p_num = _row_plan_periods(h, n_resized_rows, name)
    max_l = len(offsets[0]) if len(offsets) else 0
    if len(offsets) != q or any(len(row) != max_l for row in offsets):
        raise ValueError(f"{name}: offsets must be {q} rows of maxL source row offsets")
    cout = _check_packed(name, "kp", kp, q * max_l * 4, cin, xq.device)
    groups = row_phase_groups(offsets)
    if sk.shape != (q, cout) or bias.shape != (cout,) or sx.numel() != b:
        raise ValueError(f"{name}: sk must be [{q}, Cout], bias [Cout], sx [B]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bf16 or f32, got {out_dtype}")
    if xq.device.type == "cpu":
        return row_resize_conv4_int8_plain(xq, sx, kp, sk, offsets, bias, n_resized_rows,
                                           out_dtype)
    _require_cuda(xq, name)
    if cin % 4 != 0:
        raise ValueError(f"{name}: Cin={cin} must be a multiple of 4")
    if q > 8 or max_l > 4:
        raise ValueError(f"{name}: at most 8 phases of 4 groups, got {q} x {max_l}")
    dev = xq.device
    xq, kp = xq.contiguous(), kp.contiguous()
    sx, sk, bias = sx.reshape(b).contiguous(), sk.contiguous(), bias.contiguous()
    _require_aligned(name, 16, xq=xq, kp=kp)
    _require_aligned(name, 8, sk=sk, bias=bias)
    offs = (ctypes.c_int * (q * max_l))(*[int(d) for row in offsets for d in row])
    n_groups = (ctypes.c_int * q)(*groups)
    out = torch.empty((b, n_resized_rows - 1, w, cout), dtype=out_dtype, device=dev)
    on_mma = ctypes.c_int(0)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.zdc_row_resize_conv4_int8(
            xq.data_ptr(), sx.data_ptr(), kp.data_ptr(), sk.data_ptr(), bias.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w, cin, cout, q, p_num,
            max_l, n_resized_rows - 1, ctypes.cast(offs, ctypes.c_void_p),
            ctypes.cast(n_groups, ctypes.c_void_p), ctypes.addressof(on_mma), _stream(xq),
        )
    _build.check(status, name)
    row_resize_conv4_int8.launches += 1
    row_resize_conv4_int8.mma_launches += on_mma.value
    return out


row_resize_conv4_int8.launches = row_resize_conv4_int8.mma_launches = 0
