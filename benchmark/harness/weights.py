"""Weights made from a seed, on the device, in a few large calls.

A tree is described by its leaves ``(path, shape, rule)``; :func:`make_tree`
draws one flat standard-normal buffer for all of them from a
``torch.Generator`` on the device and shapes each leaf from its slice by its
rule. The result is a nested dict in the Flax layout that the engine takes
(Dense kernels ``[in, out]``, conv kernels HWIO), each leaf with the
leading axes ``lead`` (the experts) in front. The same tree goes to the port
and to the plain reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def _fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[:-1])


# rule -> the leaf from its standard-normal draws ``z`` (the configuration
# files name these rules under ``assumed``)
RULES = {
    "lecun": lambda z, shape: z * _fan_in(shape) ** -0.5,  # N(0, 1 / fan_in)
    "normal": lambda z, shape: z,  # N(0, 1)
    "zeros": lambda z, shape: z.zero_(),
    "ones": lambda z, shape: z.fill_(1.0),
    "affine_scale": lambda z, shape: 1.0 + 0.1 * z,  # a norm's scale, N(1, 0.01)
    "affine_bias": lambda z, shape: 0.1 * z,  # a norm's shift, N(0, 0.01)
}


def seed_stream(seed: int, k: int) -> int:
    """The seed of the ``k``-th independent stream drawn from ``seed``
    (any whole number), within a generator's 64 bits."""
    return (int(seed) * 1_000_003 + 7919 * k) % (2 ** 63)


def make_tree(leaves: Sequence[Leaf], seed: int, device, lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    import torch

    sizes = [math.prod(lead + tuple(shape)) for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree: Dict[str, Any] = {}
    off = 0
    for (path, shape, rule), n in zip(leaves, sizes):
        z = flat[off:off + n].view(*lead, *shape)
        off += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = RULES[rule](z, tuple(shape)).contiguous()
    return tree


def balance_router(router: Dict[str, Any], logits_of, cond, sweeps: int = 30) -> None:
    """Shift the router's last Dense bias (in place) so that its argmax
    sends an equal share of ``cond``'s rows to each expert: a random draw
    alone can send nearly all of them to one. ``logits_of(router, cond)``:
    the router's logits. Each sweep sets each expert's shift so that its
    margin over the best other expert is positive on ``1/E`` of the rows."""
    import torch

    last = router[f"Dense_{len(router) - 1}"]
    logits = logits_of(router, cond).float()
    e = logits.shape[1]
    shift = torch.zeros(e, device=logits.device)
    for _ in range(sweeps):
        for k in range(e):
            z = logits + shift
            others = torch.cat([z[:, :k], z[:, k + 1:]], dim=1).amax(dim=1)
            shift[k] -= torch.quantile(z[:, k] - others, 1.0 - 1.0 / e)
    last["bias"] = last["bias"] + shift


def shares(ids, n_experts: int) -> list:
    """Each expert's share of ``ids``."""
    import torch

    counts = torch.bincount(ids.long().flatten(), minlength=n_experts).double()
    return (counts / counts.sum().clamp_min(1)).tolist()


def expert(tree: Dict[str, Any], e: int) -> Dict[str, Any]:
    """Expert ``e``'s slice of a tree stacked on its leading axis."""
    return {k: expert(v, e) if isinstance(v, dict) else v[e] for k, v in tree.items()}
