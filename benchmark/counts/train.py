"""Floating-point operations of one dense train step, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference's step
(``reference/proton_train.py``) with every tensor on the meta device: the
operations that the configuration's step needs (matmuls and convs, forward
and backward, 2 a multiply-add), whatever the program recomputes or fuses.
The dense step runs every expert on every row, so the count does not depend
on the routing."""

from __future__ import annotations

import functools
import json
from typing import Dict


def _meta_tree(leaves, lead=()):
    import torch

    tree: Dict = {}
    for path, shape, _ in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty((*lead, *shape), device="meta")
    return tree


@functools.lru_cache(maxsize=None)
def _count(settings_json: str, batch: int) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference import proton, proton_train as pt

    s = json.loads(settings_json)
    e, z, c = int(s["model.n_experts"]), int(s["model.noise_dim"]), int(s["model.cond_dim"])
    h, w = s["dataset.input_image_shape"]
    state = pt.init(_meta_tree(proton.generator_leaves(s), (e,)), _meta_tree(pt.disc_leaves(s), (e,)),
                    _meta_tree(pt.disc_stats_leaves(s), (e,)), _meta_tree(pt.aux_leaves(s), (e,)),
                    _meta_tree(proton.router_tree_leaves(s)))
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    batch_t = {"real": m(batch, h, w, 1), "cond": m(batch, c), "std": m(batch, 1),
               "intensity": m(batch, 1), "positions": m(batch, 2)}
    draws = {"gumbel": m(batch, e), "noise_1": m(batch, z), "noise_2": m(batch, z),
             "aux_keep": (m(e, batch, 128, dtype=torch.bool), m(e, batch, 64, dtype=torch.bool))}
    with FlopCounterMode(display=False) as counter:
        pt.step(state, batch_t, draws, 0, s)
    return int(counter.get_total_flops())


def dense_step_flops(settings: Dict, batch: int) -> int:
    return _count(json.dumps(settings, sort_keys=True), int(batch))
