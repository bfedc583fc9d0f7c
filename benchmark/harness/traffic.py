"""The one generator of inputs: it reads a traffic file's ``fields`` and
draws them, in the order the file lists them, from a ``torch.Generator``
on the device.

A field is ``{"dist": ..., "shape": [...], "scale": s, "grid": dtype}``:
``normal`` N(0, 1), ``abs_normal`` |N(0, 1)|, ``uniform`` U(0, 1), each
times ``scale`` (default 1), ``gumbel`` the standard Gumbel ``-log(Exp(1))``,
``keep`` a boolean kept with probability ``p`` (a dropout keep mask);
``grid`` rounds the values to a narrower floating type's grid (kept in
float32), so that a program that casts them to that type reads exactly the
values the reference reads. A shape entry that is a string names a setting
of the configuration (``model.cond_dim``; a list setting gives its entries);
``"per_expert": true`` puts ``model.n_experts`` before the rows.
"""

from __future__ import annotations

from typing import Any, Dict


def _dims(shape, settings):
    for d in shape:
        v = settings[d] if isinstance(d, str) else d
        yield from (int(x) for x in (v if isinstance(v, list) else [v]))


def draw(fields: Dict[str, Dict[str, Any]], rows: int, gen, device, settings) -> Dict[str, Any]:
    import torch

    out = {}
    for name, f in fields.items():
        lead = (int(settings["model.n_experts"]), rows) if f.get("per_expert") else (rows,)
        shape = (*lead, *_dims(f["shape"], settings))
        dist = f["dist"]
        if dist == "gumbel":
            x = -torch.empty(shape, device=device).exponential_(generator=gen).log_()
        elif dist == "keep":
            x = torch.rand(shape, generator=gen, device=device) < float(f["p"])
        elif dist in ("normal", "abs_normal"):
            x = torch.randn(shape, generator=gen, device=device)
            if dist == "abs_normal":
                x = x.abs_()
        elif dist == "uniform":
            x = torch.rand(shape, generator=gen, device=device)
        else:
            raise ValueError(f"traffic field {name!r}: unknown dist {dist!r}")
        if f.get("scale", 1) != 1:
            x = x * float(f["scale"])
        if f.get("grid"):
            x = x.to(getattr(torch, f["grid"])).to(torch.float32)
        out[name] = x
    return out
