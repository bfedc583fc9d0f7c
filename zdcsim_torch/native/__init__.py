"""ctypes bindings of the port's host C++ library (counterpart of
``zdcsim/native``): the data-preparation loops of
``zdcsim_torch.data.prep`` and a threaded row gather.

The library builds at first use (``zdcsim_torch.native.build``, the host's
g++). :func:`available` says whether it loaded; where it cannot be built or
loaded, a warning is logged once and every function runs its numpy version
instead, as the JAX package's do. Host code: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

ABI_VERSION = 1
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        from zdcsim_torch.native.build import build

        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        log.warning("zdcsim_torch host library unavailable (%s); using the numpy versions", e)
        return None
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.zdc_photon_sums.argtypes = [f32p, i64, i64, f32p]
    lib.zdc_max_coords.argtypes = [f32p, i64, i64, i64, f32p]
    lib.zdc_log1p.argtypes = [f32p, i64]
    lib.zdc_group_pixel_std.argtypes = [f32p, i64, i64p, i64p, i64, f32p]
    lib.zdc_gather_rows.argtypes = [f32p, i64, i64p, i64, f32p]
    lib.zdc_native_abi_version.restype = ctypes.c_int
    if lib.zdc_native_abi_version() != ABI_VERSION:
        log.warning("zdcsim_torch host library has ABI %d, not %d; using the numpy versions",
                    lib.zdc_native_abi_version(), ABI_VERSION)
        return None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library built and loaded (building it on first call)."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def photon_sums(images: np.ndarray) -> np.ndarray:
    """``[N, ...]`` float32 -> ``[N]`` per-event pixel sums (double
    accumulation in C++; numpy's float32 sum in its version)."""
    lib = _load()
    images = np.ascontiguousarray(images, np.float32)
    n = images.shape[0]
    pixels = int(np.prod(images.shape[1:]))
    if lib is None:
        return images.reshape(n, pixels).sum(axis=1)
    out = np.empty(n, np.float32)
    lib.zdc_photon_sums(_fptr(images), n, pixels, _fptr(out))
    return out


def max_coords(images: np.ndarray) -> np.ndarray:
    """``[N, H, W]`` float32 -> ``[N, 2]`` float32 argmax (row, col), the
    first maximum in row-major order winning a tie."""
    lib = _load()
    images = np.ascontiguousarray(images, np.float32)
    n, h, w = images.shape
    if lib is None:
        flat = images.reshape(n, h * w).argmax(axis=1)
        return np.stack([flat // w, flat % w], axis=1).astype(np.float32)
    out = np.empty((n, 2), np.float32)
    lib.zdc_max_coords(_fptr(images), n, h, w, _fptr(out))
    return out


def log1p_(images: np.ndarray) -> np.ndarray:
    """``log1p`` in place on a contiguous float32 array, which it returns (a
    new array from numpy for any other input, or without the library)."""
    lib = _load()
    if lib is None or not images.flags.c_contiguous or images.dtype != np.float32:
        return np.log1p(images, dtype=np.float32)
    lib.zdc_log1p(_fptr(images), images.size)
    return images


def group_pixel_std(images: np.ndarray, group_ids: np.ndarray) -> np.ndarray:
    """Per event, its group's per-pixel population std summed over pixels
    (groups of one get 0): the diversity target before its max
    normalisation. Welford in double in C++, two-pass float64 in numpy."""
    lib = _load()
    images = np.ascontiguousarray(images, np.float32)
    n = images.shape[0]
    pixels = int(np.prod(images.shape[1:]))
    order = np.argsort(group_ids, kind="stable").astype(np.int64)
    sorted_ids = np.asarray(group_ids)[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sorted_ids)) + 1, [n]]).astype(np.int64)
    n_groups = starts.shape[0] - 1
    if lib is None:
        out = np.zeros(n, np.float64)
        flat = images.reshape(n, pixels).astype(np.float64)
        for lo, hi in zip(starts[:-1], starts[1:]):
            seg = order[lo:hi]
            if seg.size > 1:
                out[seg] = flat[seg].std(axis=0).sum()
        return out.astype(np.float32)
    out = np.empty(n, np.float32)
    lib.zdc_group_pixel_std(_fptr(images), pixels, _iptr(order), _iptr(starts), n_groups,
                            _fptr(out))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` of a float32 ``[N, ...]`` array by a threaded row copy."""
    lib = _load()
    src2 = np.ascontiguousarray(src.reshape(src.shape[0], -1), np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is None:
        return src2[idx].reshape((idx.shape[0],) + src.shape[1:])
    out = np.empty((idx.shape[0], src2.shape[1]), np.float32)
    lib.zdc_gather_rows(_fptr(src2), src2.shape[1], _iptr(idx), idx.shape[0], _fptr(out))
    return out.reshape((idx.shape[0],) + src.shape[1:])
