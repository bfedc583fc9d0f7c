"""Build the port's host C++ library (``src/prep_kernels.cpp``) with g++.

The library is built at first use into ``zdcsim_torch/_build/`` (never
beside the sources), under a name that carries a hash of the source and the
flags, so an edited source builds anew and an unchanged one is reused; the
build writes a temporary file and renames it, so processes that build at
once each see a whole library. ``python -m zdcsim_torch.native.build``
builds it and prints its path.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "prep_kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-march=native")


def lib_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libzdcsim_prep_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this exact build exists; returns its path.
    Raises ``RuntimeError`` when g++ is missing or fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


if __name__ == "__main__":
    print(build())
    sys.exit(0)
