"""Tiny stand-in modules for fast tests of the training machinery (the
port's own copy of ``zdcsim/models/testing.py``).

They expose the interfaces of the proton family as the port holds them:
``generator(noise, cond) -> [B, H, W, 1]``, ``discriminator(img, cond,
stats, train) -> (score, latent, new stats)``, ``aux(img, keep) -> [B,
2]``, so the step, the masking, the optimizer gating and the EMA run at
negligible FLOPs. Production code never uses them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from zdcsim_torch.models import MoEModules
from zdcsim_torch.models.router import RouterNetwork


class TinyGenerator(nn.Module):
    def __init__(self, noise_dim: int = 10, cond_dim: int = 9,
                 image_shape: Tuple[int, int] = (8, 6)):
        super().__init__()
        self.image_shape = tuple(image_shape)
        h, w = self.image_shape
        self.Dense_0 = nn.Linear(noise_dim + cond_dim, 32)
        self.Dense_1 = nn.Linear(32, h * w)

    def forward(self, noise, cond):
        x = torch.relu(self.Dense_0(torch.cat([noise, cond], dim=1)))
        return torch.relu(self.Dense_1(x)).reshape(-1, *self.image_shape, 1)


class TinyDiscriminator(nn.Module):
    def __init__(self, cond_dim: int = 9, image_shape: Tuple[int, int] = (8, 6)):
        super().__init__()
        self.Dense_0 = nn.Linear(image_shape[0] * image_shape[1] + cond_dim, 32)
        self.Dense_1 = nn.Linear(32, 16)
        self.Dense_2 = nn.Linear(16, 1)

    def forward(self, img, cond, stats, train: bool = True):
        x = torch.cat([img.reshape(img.shape[0], -1), cond], dim=1)
        latent = torch.relu(self.Dense_1(torch.relu(self.Dense_0(x))))
        return self.Dense_2(latent), latent, {}


class TinyAuxReg(nn.Module):
    dropout_shapes = ()

    def __init__(self, image_shape: Tuple[int, int] = (8, 6), output_dim: int = 2):
        super().__init__()
        self.Dense_0 = nn.Linear(image_shape[0] * image_shape[1], 16)
        self.Dense_1 = nn.Linear(16, output_dim)

    def forward(self, img, keep=None):
        return self.Dense_1(torch.relu(self.Dense_0(img.reshape(img.shape[0], -1))))


def build_tiny_moe(cfg, image_shape: Tuple[int, int] = (8, 6)) -> MoEModules:
    """A ``MoEModules`` of tiny modules, honouring ``cfg.model.{n_experts,
    noise_dim, cond_dim}`` and the requested image geometry."""
    m = cfg.model
    with torch.device("meta"):
        modules = (TinyGenerator(m.noise_dim, m.cond_dim, image_shape),
                   TinyDiscriminator(m.cond_dim, image_shape), TinyAuxReg(image_shape),
                   RouterNetwork(n_experts=m.n_experts, cond_dim=m.cond_dim,
                                 widths=m.router.widths))
    return MoEModules(*modules, n_experts=int(m.n_experts), noise_dim=int(m.noise_dim),
                      cond_dim=int(m.cond_dim), image_shape=tuple(image_shape),
                      names={"generator": "TinyGenerator", "discriminator": "TinyDiscriminator",
                             "aux_reg": "TinyAuxReg", "router": "RouterNetwork"})
