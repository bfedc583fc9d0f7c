"""The generator classes by name, and ``build_moe``'s rule for choosing one
(``zdcsim/models/__init__.py:114-150``)."""

from __future__ import annotations

from typing import Any, Dict, Tuple, Type

import torch.nn as nn

from zdcsim_torch.models.neutron import GeneratorNeutron, GeneratorNeutronV2
from zdcsim_torch.models.proton import Generator

GENERATORS: Dict[str, Type[nn.Module]] = {
    "proton.generator": Generator,
    "neutron.generator": GeneratorNeutron,
    "neutron.generator_v2": GeneratorNeutronV2,
}


def generator_spec(architecture: str, version: str = "v1", norm: str = "batch",
                   width: float = 1.0) -> Tuple[Type[nn.Module], Dict[str, Any]]:
    """``(class, keyword arguments)`` of the generator that ``build_moe``
    builds for ``model.architecture``, ``model.generator.version``,
    ``model.norm`` and ``model.generator.width``: ``v1`` is the reference
    architecture, another version the class registered as
    ``<architecture>.generator_<version>``; ``norm`` reaches the neutron
    family only. Raises ``ValueError`` for a pair with no generator."""
    key = f"{architecture}.generator" + ("" if version == "v1" else f"_{version}")
    if key not in GENERATORS:
        raise ValueError(f"no generator version {version!r} for architecture {architecture!r}. "
                         f"Available: {sorted(GENERATORS)}")
    kwargs: Dict[str, Any] = {"width": float(width)}
    if architecture == "neutron":
        kwargs["norm"] = norm
    return GENERATORS[key], kwargs
