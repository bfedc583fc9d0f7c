"""Plain reference of the proton family's generator (the reference
architecture "Generator-v5-bigkernel-res56x30" as its Flax port states it):

concat(noise, cond) -> Dense 256, LayerNorm, LeakyReLU -> Dense w(512)*18*10,
LayerNorm, LeakyReLU -> reshape 18x10 -> nearest up x2 -> Conv4x4 w(256) pad 1,
GroupNorm, LeakyReLU -> nearest resize to 56x30 -> Conv4x4 w(128) pad 1,
GroupNorm, LeakyReLU -> Conv3x3 w(64) pad 1, GroupNorm, LeakyReLU -> Conv2x2 1
pad 1 -> ReLU: log-space intensities ``[B, 56, 30]``.

Float32 throughout, the upsample and the resize materialised, each conv in
one ``conv2d``. ``bits`` rounds the inputs and kernels of Conv_0, Conv_1 and
Conv_2, the convs that the program runs in int8, to that many bits (the
control).
"""

from __future__ import annotations

from typing import Optional

import torch

from reference.common import (  # noqa: F401 (router_tree_leaves, below)
    conv, dense, group_norm, layer_norm, leaky, resize_nearest, router_tree_leaves, router_v1,
    upsample2,
)

SHAPE = (56, 30)


def width(c: int, w: float) -> int:
    return max(32, int(c * w) // 32 * 32)


def generator_leaves(cfg):
    w = float(cfg["model.generator.width"])
    c0, c1, c2, c3 = (width(c, w) for c in (512, 256, 128, 64))
    nin = int(cfg["model.noise_dim"]) + int(cfg["model.cond_dim"])
    out = []

    def dense_ln(name, i, o):
        nonlocal out
        out += [((name, "Dense_0", "kernel"), (i, o), "lecun"),
                ((name, "Dense_0", "bias"), (o,), "zeros"),
                ((name, "LayerNorm_0", "scale"), (o,), "ones"),
                ((name, "LayerNorm_0", "bias"), (o,), "zeros")]

    def conv_gn(i, k, cin, cout, gn=True):
        nonlocal out
        out += [((f"Conv_{i}", "kernel"), (k, k, cin, cout), "lecun"),
                ((f"Conv_{i}", "bias"), (cout,), "zeros")]
        if gn:
            out += [((f"GroupNorm2d_{i}", "GroupNorm_0", "scale"), (cout,), "ones"),
                    ((f"GroupNorm2d_{i}", "GroupNorm_0", "bias"), (cout,), "zeros")]

    dense_ln("MLPBlock_0", nin, 256)
    dense_ln("MLPBlock_1", 256, c0 * 18 * 10)
    conv_gn(0, 4, c0, c1)
    conv_gn(1, 4, c1, c2)
    conv_gn(2, 3, c2, c3)
    conv_gn(3, 2, c3, 1, gn=False)
    return out


# the configuration's router (model.router.version router_v1), its leaves
# router_tree_leaves: the entries read both from here
router = router_v1




def generator(p, noise, cond, stats=None, bits: Optional[int] = None, per_tensor: bool = False):
    """One expert's eval forward: ``[B, 56, 30]`` float32 log-space."""
    x = torch.cat([noise.float(), cond.float()], dim=1)
    for name in ("MLPBlock_0", "MLPBlock_1"):
        x = leaky(layer_norm(dense(x, p[name]["Dense_0"]), p[name]["LayerNorm_0"]))
    c0 = p["Conv_0"]["kernel"].shape[2]
    x = upsample2(x.reshape(-1, 18, 10, c0))  # 36x20
    x = conv(x, p["Conv_0"]["kernel"], p["Conv_0"]["bias"], (1, 1, 1, 1), bits, per_tensor)  # 35x19
    x = leaky(group_norm(x, p["GroupNorm2d_0"]["GroupNorm_0"]))
    x = resize_nearest(x, SHAPE)
    x = conv(x, p["Conv_1"]["kernel"], p["Conv_1"]["bias"], (1, 1, 1, 1), bits, per_tensor)  # 55x29
    x = leaky(group_norm(x, p["GroupNorm2d_1"]["GroupNorm_0"]))
    x = conv(x, p["Conv_2"]["kernel"], p["Conv_2"]["bias"], (1, 1, 1, 1), bits, per_tensor)  # 55x29
    x = leaky(group_norm(x, p["GroupNorm2d_2"]["GroupNorm_0"]))
    x = conv(x, p["Conv_3"]["kernel"], p["Conv_3"]["bias"], (1, 1, 1, 1))  # 56x30
    return x.clamp_min(0.0)[..., 0]

