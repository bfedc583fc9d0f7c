"""Router networks (counterparts of ``zdcsim/models/router.py:19`` and
``:50``) and the rule that picks one by ``model.router.version``."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from zdcsim_torch.models.layers import leaky_relu
from zdcsim_torch.ops.routing import gumbel_softmax


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


class AttentionRouterNetwork(nn.Module):
    """The condition, embedded (``Dense_0`` 9 -> 128, LeakyReLU(0.1),
    ``Dense_1`` -> ``embed_dim``, ``LayerNorm_0`` at Flax's eps 1e-6),
    scored against one learned query per expert: ``logits = h @
    expert_queries.T / sqrt(embed_dim)``. ``expert_queries`` is ``[E,
    embed_dim]``, a parameter of its own (not a Dense kernel), drawn
    N(0, 0.02) at initialisation as Flax's ``normal(stddev=0.02)``. The
    gates are ``softmax(logits / tau)``, or the Gumbel-softmax gates on
    given ``noise`` (JAX's ``key``: its draw cannot be reproduced here)."""

    def __init__(self, n_experts: int = 3, cond_dim: int = 9, embed_dim: int = 64):
        super().__init__()
        self.embed_dim = int(embed_dim)
        self.Dense_0 = nn.Linear(cond_dim, 128)
        self.Dense_1 = nn.Linear(128, self.embed_dim)
        self.LayerNorm_0 = nn.LayerNorm(self.embed_dim, eps=1e-6)
        self.expert_queries = nn.Parameter(torch.empty(n_experts, self.embed_dim))

    def forward(self, cond: torch.Tensor, tau: float = 1.0,
                noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.LayerNorm_0(self.Dense_1(leaky_relu(self.Dense_0(cond))))
        logits = (h @ self.expert_queries.T) / math.sqrt(float(self.embed_dim))
        gates = (torch.softmax(logits / tau, dim=-1) if noise is None
                 else gumbel_softmax(logits, tau, noise=noise))
        return gates, logits


ROUTERS = {"router_v1": RouterNetwork, "router_attention": AttentionRouterNetwork}


def build_router(model_cfg) -> nn.Module:
    """The router that ``model.router.version`` names (JAX's
    ``MODEL_REGISTRY``), with ``n_experts`` and ``cond_dim``; ``router_v1``
    takes ``model.router.widths``."""
    version = str(model_cfg.router.version)
    if version not in ROUTERS:
        raise ValueError(f"model.router.version must be one of {sorted(ROUTERS)}, got "
                         f"{version!r}")
    kwargs = {"n_experts": int(model_cfg.n_experts), "cond_dim": int(model_cfg.cond_dim)}
    if version == "router_v1":
        kwargs["widths"] = tuple(model_cfg.router.widths)
    return ROUTERS[version](**kwargs)


def router_version(router: nn.Module) -> str:
    """Inverse of :func:`build_router`'s choice: the version of ``router``'s
    class."""
    return next(v for v, cls in ROUTERS.items() if type(router) is cls)
