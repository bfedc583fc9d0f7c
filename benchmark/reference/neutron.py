"""Plain reference of the neutron family's generator with BatchNorm (the
reference architecture "Generator-neutron-1-original-architecture" as its
Flax port states it), in eval:

concat(noise, cond) -> Dense 256, BatchNorm, LeakyReLU -> Dense w(128)*13*13,
BatchNorm, LeakyReLU -> reshape 13x13 -> nearest up x2 -> Conv3x3 w(256)
VALID, BatchNorm, LeakyReLU -> nearest up x2 -> Conv3x3 w(128) VALID,
BatchNorm, LeakyReLU -> Conv2x2 w(64) VALID, BatchNorm, LeakyReLU -> Conv2x2
1 VALID -> ReLU: log-space intensities ``[B, 44, 44]``. Dropout is the
identity in eval.

Each BatchNorm runs as it is written, on its running statistics, after its
layer (the program folds it into the layer before). Float32 throughout;
``bits`` rounds the inputs and kernels of Conv_0, Conv_1 and Conv_2, the
convs that the program runs in int8 (the control).
"""

from __future__ import annotations

from typing import Optional

import torch

from reference.common import (  # noqa: F401 (router_tree_leaves, below)
    batch_norm_eval, conv, dense, leaky, router_tree_leaves, router_v1, upsample2,
)
from reference.proton import width

SHAPE = (44, 44)


def generator_leaves(cfg):
    w = float(cfg["model.generator.width"])
    c0, c1, c2, c3 = (width(c, w) for c in (128, 256, 128, 64))
    nin = int(cfg["model.noise_dim"]) + int(cfg["model.cond_dim"])
    out = []
    layers = (("Dense_0", (nin, 256)), ("Dense_1", (256, c0 * 13 * 13)),
              ("Conv_0", (3, 3, c0, c1)), ("Conv_1", (3, 3, c1, c2)), ("Conv_2", (2, 2, c2, c3)))
    for i, (name, shape) in enumerate(layers):
        out += [((name, "kernel"), shape, "lecun"), ((name, "bias"), shape[-1:], "zeros"),
                ((f"MaskedBatchNorm_{i}", "scale"), shape[-1:], "affine_scale"),
                ((f"MaskedBatchNorm_{i}", "bias"), shape[-1:], "affine_bias")]
    out += [(("Conv_3", "kernel"), (2, 2, c3, 1), "lecun"), (("Conv_3", "bias"), (1,), "zeros")]
    return out


# the configuration's router (model.router.version router_v1), its leaves
# router_tree_leaves: the entries read both from here
router = router_v1



def fit_batch_stats(p, noise, cond):
    """The five BatchNorms' running statistics (``batch_stats``) as long
    training leaves them: each layer's mean and (biased) variance over
    ``noise``'s and ``cond``'s rows (and, for a conv, its positions), each
    layer normalised by its own batch statistics on the way, as in training."""
    def norm(x, bn, dims):
        mean, var = x.mean(dim=dims), x.var(dim=dims, unbiased=False)
        stats[bn] = {"mean": mean, "var": var}
        return leaky(batch_norm_eval(x, p[bn], stats[bn]))

    stats = {}
    x = torch.cat([noise.float(), cond.float()], dim=1)
    for i, name in enumerate(("Dense_0", "Dense_1")):
        x = norm(dense(x, p[name]), f"MaskedBatchNorm_{i}", (0,))
    x = x.reshape(-1, 13, 13, p["Dense_1"]["kernel"].shape[1] // 169)
    for i, (name, up) in enumerate((("Conv_0", True), ("Conv_1", True), ("Conv_2", False))):
        x = conv(upsample2(x) if up else x, p[name]["kernel"], p[name]["bias"], (0, 0, 0, 0))
        x = norm(x, f"MaskedBatchNorm_{i + 2}", (0, 1, 2))
    return stats


def generator(p, noise, cond, stats, bits: Optional[int] = None, per_tensor: bool = False):
    """One expert's eval forward: ``[B, 44, 44]`` float32 log-space."""
    x = torch.cat([noise.float(), cond.float()], dim=1)
    for i, name in enumerate(("Dense_0", "Dense_1")):
        bn = f"MaskedBatchNorm_{i}"
        x = leaky(batch_norm_eval(dense(x, p[name]), p[bn], stats[bn]))
    x = x.reshape(-1, 13, 13, p["Dense_1"]["kernel"].shape[1] // 169)
    for i, (name, up) in enumerate((("Conv_0", True), ("Conv_1", True), ("Conv_2", False))):
        bn = f"MaskedBatchNorm_{i + 2}"
        x = conv(upsample2(x) if up else x, p[name]["kernel"], p[name]["bias"], (0, 0, 0, 0), bits, per_tensor)
        x = leaky(batch_norm_eval(x, p[bn], stats[bn]))  # 24x24, 46x46, 45x45
    x = conv(x, p["Conv_3"]["kernel"], p["Conv_3"]["bias"], (0, 0, 0, 0))  # 44x44
    return x.clamp_min(0.0)[..., 0]
