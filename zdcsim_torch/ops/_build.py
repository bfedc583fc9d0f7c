"""Build the port's CUDA kernels with plain ``nvcc`` and bind them with ctypes.

Every ``zdcsim_torch/csrc/*.cu`` source is compiled for ``sm_90a`` by its
own ``nvcc -c``, all started together, and one ``nvcc -shared`` links the
objects into one shared library with a plain C interface (no PyTorch
headers, no ninja, no lock file), on first use, into
``zdcsim_torch/_build/``. The library's name carries a hash of the sources,
the headers they include (``csrc/*.cuh``) and the flags, so an edited source
or header builds anew and an unchanged tree is reused.
No ``--use_fast_math``: the kernels divide, take square roots and round as
IEEE float32 does, like the kernels they replace.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = (
    "ln_leaky_rowquant.cu", "up2_conv4_int8.cu", "gn_leaky_rowquant.cu",
    "row_resize_conv4_int8.cu", "expm1_channel_sums.cu", "fused_decode.cu",
)
HEADERS = ("conv_mma.cuh",)  # the int8 tensor-core conv core of B, D, G and H
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; every entry point returns cudaGetLastError().
SIGNATURES = {
    "zdc_ln_leaky_rowquant": (_P, _I, _P, _P, _P, _P, _I, _I, _P),
    "zdc_up2_conv4_int8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "zdc_gn_leaky_rowquant": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "zdc_row_resize_conv4_int8": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    "zdc_expm1_channel_sums": (_P, _I, _P, _I, _I, _I, _P),
    "zdc_routed_expm1_channel_sums": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    "zdc_fused_decode_front": (_P, _I) + (_P,) * 12 + (_I, _P),
    "zdc_fused_decode": (_P, _I) + (_P,) * 23 + (_I, _I, _P),
    "zdc_fused_conv_int8": (_I,) + (_P,) * 6 + (_I, _P),
}

_lib = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> Tuple[str, str]:
    """Compile the kernels unless this exact build exists.

    Returns ``(library path, nvcc output)``; the output holds ptxas's
    register and shared-memory report for each kernel (empty when the
    library was already built). Raises ``RuntimeError`` with nvcc's output
    if the compiler is missing or fails.
    """
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [os.path.join(CSRC_DIR, s) for s in HEADERS]:
        with open(s, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"libzdcsim_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    try:
        for src, proc, out in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{out}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
