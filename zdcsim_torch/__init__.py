"""zdcsim_torch: the PyTorch + CUDA port of ``zdcsim`` for one NVIDIA H100.

The JAX package ``zdcsim`` is the reference; every module here mirrors the
JAX module of the same name and is held against it by ``tests/test_torch_*``.
The port imports ``torch``, ``numpy``, ``scipy``, ``einops`` and the
standard library only, so it runs on a machine without JAX, Flax or PyYAML.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from zdcsim_torch.device import default_device  # noqa: F401

__version__ = "0.1.0"
