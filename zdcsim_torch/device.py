"""Device selection (counterpart of ``zdcsim/utils/platform.py``).

The port serves on the GPU. The CPU is taken only when the caller asks for
it (the tests do): a missing card is an error, never a silent fallback.
"""

from __future__ import annotations

import torch


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU"
        )
    return dev
