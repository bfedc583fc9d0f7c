"""Gumbel-softmax routing primitives (counterpart of ``zdcsim/ops/routing.py``).

The Gumbel noise comes from an explicit ``torch.Generator`` or is passed in:
JAX's ``jax.random.gumbel`` streams cannot be reproduced here, so the tests
hand both packages the same noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device: str | torch.device = "cpu", dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel samples ``-log(Exp(1))`` drawn from ``generator``."""
    e = torch.empty(shape, device=device, dtype=dtype).exponential_(generator=generator)
    return -torch.log(e)


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gumbel-softmax gates from logits ``[B, E]``; ``noise`` if given, else a
    draw from ``generator``."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device, logits.dtype)
    y_soft = torch.softmax((logits + noise) / tau, dim=-1)
    if hard:
        return straight_through_gates(y_soft)[0]
    return y_soft


def straight_through_gates(gates_soft: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(one_hot(argmax) + soft - soft.detach(), argmax)``: one-hot forward,
    soft backward."""
    idx = torch.argmax(gates_soft, dim=-1)
    hard = F.one_hot(idx, gates_soft.shape[-1]).to(gates_soft.dtype)
    return hard + gates_soft - gates_soft.detach(), idx


def expert_masks(idx: torch.Tensor, n_experts: int, dtype=torch.float32) -> torch.Tensor:
    """``[E, B]`` float masks from hard assignments ``[B]``."""
    experts = torch.arange(n_experts, device=idx.device)
    return (idx[None, :] == experts[:, None]).to(dtype)


def class_share(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Fraction of the batch routed to each expert, ``[E]`` float32."""
    return expert_masks(idx, n_experts).sum(dim=1) / idx.shape[0]
