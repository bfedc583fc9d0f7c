"""Router network (counterpart of ``zdcsim/models/router.py:19``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from zdcsim_torch.models.layers import leaky_relu


class RouterNetwork(nn.Module):
    """cond[9] -> 128 -> 64 -> 32 -> n_experts logits, LeakyReLU(0.1) between.

    Serving routes by ``argmax(logits)``; the gates returned beside the
    logits are the deterministic ``softmax(logits / tau)`` of the JAX
    module called without a key (gumbel sampling is a training concern).
    """

    def __init__(self, n_experts: int = 3, cond_dim: int = 9,
                 widths: Sequence[int] = (128, 64, 32)):
        super().__init__()
        dims = [cond_dim, *widths, n_experts]
        for i in range(len(dims) - 1):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n_layers = len(dims) - 1

    def forward(self, cond: torch.Tensor, tau: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        x = cond
        for i in range(self.n_layers - 1):
            x = leaky_relu(getattr(self, f"Dense_{i}")(x))
        logits = getattr(self, f"Dense_{self.n_layers - 1}")(x)
        return torch.softmax(logits / tau, dim=-1), logits
