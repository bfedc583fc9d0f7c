"""The generator classes by name, ``build_moe``'s rule for choosing one
(``zdcsim/models/__init__.py:114-150``), and the expert-stacked MoE of
training (``MoEModules``, ``build_moe``).

Expert stacking: where JAX ``nn.vmap``s each module over a leading expert
axis, the port keeps one expert's module (on the meta device: it holds no
weights) and every parameter and stat stacked on a leading ``[E, ...]`` axis
in the train state; each expert runs through ``torch.func.functional_call``
on its slice (``torch.unbind``, whose backward stacks the slices' gradients),
and the outputs are stacked. The generator broadcasts noise and conditions to
every expert; the discriminator and the aux regressor take each expert's own
``[E, B, ...]`` slice, as JAX's ``in_axes=(0, None, None)`` and ``(0, None)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn
from torch.func import functional_call

from zdcsim_torch.models.neutron import GeneratorNeutron, GeneratorNeutronV2
from zdcsim_torch.models.proton import AuxReg, Discriminator, Generator
from zdcsim_torch.models.router import RouterNetwork

Tree = Dict[str, torch.Tensor]

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


def expert_slices(tree: Tree, n_experts: int) -> List[Tree]:
    """A stacked flat tree -> one flat tree per expert (views)."""
    if not tree:
        return [{} for _ in range(n_experts)]
    keys = list(tree)
    return [dict(zip(keys, vals)) for vals in zip(*(tree[k].unbind(0) for k in keys))]


def stack_trees(trees: Sequence[Tree]) -> Tree:
    """Inverse of :func:`expert_slices`."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@dataclass
class MoEModules:
    """One expert's generator, discriminator and aux regressor, the router,
    and the geometry (counterpart of ``zdcsim/models/__init__.py:82``). The
    modules hold no weights of their own: the train state does, stacked."""

    generator: nn.Module
    discriminator: nn.Module
    aux_reg: nn.Module
    router: nn.Module
    n_experts: int
    noise_dim: int
    cond_dim: int
    image_shape: Tuple[int, int]
    names: Dict[str, str] = field(default_factory=dict)

    def generate(self, params: Tree, noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """Every expert on the same ``noise``, ``cond``: ``[E, B, H, W, 1]``."""
        return torch.stack([self.generate_one(p, noise, cond)
                            for p in expert_slices(params, self.n_experts)])

    def discriminate(self, params: Tree, stats: Tree, img: torch.Tensor, cond: torch.Tensor,
                     train: bool = True) -> Tuple[torch.Tensor, torch.Tensor, Tree]:
        """Expert ``e`` scores ``img[e]``: ``(scores [E, B, 1], latents [E, B,
        F], new stats)``, the stats stacked as they came."""
        outs = [functional_call(self.discriminator, p, (x, cond, s, train))
                for p, s, x in zip(expert_slices(params, self.n_experts),
                                   expert_slices(stats, self.n_experts), img.unbind(0))]
        scores, latents, new = zip(*outs)
        return torch.stack(scores), torch.stack(latents), stack_trees(new) if new[0] else {}

    def regress(self, params: Tree, img: torch.Tensor,
                keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Expert ``e`` regresses ``img[e]`` with its keep masks ``keep[i][e]``
        (``None``: the eval form): ``[E, B, 2]``."""
        def keep_of(e):
            return None if keep is None else tuple(k[e] for k in keep)

        slices = zip(expert_slices(params, self.n_experts), img.unbind(0))
        return torch.stack([self.regress_one(p, x, keep_of(e)) for e, (p, x) in enumerate(slices)])

    # One expert on a chunk (``params``/``stats``: its slice, :func:`expert_slices`),
    # the handles of the switch step (JAX's ``generator_single``,
    # ``discriminator_single``, ``aux_reg_single``).

    def generate_one(self, params: Tree, noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """``[T, H, W, 1]``."""
        return functional_call(self.generator, params, (noise, cond))

    def discriminate_one(self, params: Tree, stats: Tree, img: torch.Tensor, cond: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(scores [T, 1], latents [T, F])`` with ``train=False``: spectral
        norm's ``u`` is read, not advanced."""
        scores, latents, _ = functional_call(self.discriminator, params, (img, cond, stats, False))
        return scores, latents

    def regress_one(self, params: Tree, img: torch.Tensor,
                    keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``[T, 2]`` with the chunk rows' keep masks (``None``: the eval form)."""
        return functional_call(self.aux_reg, params, (img, keep))

    def route(self, params: Tree, cond: torch.Tensor) -> torch.Tensor:
        """The router's logits ``[B, E]``."""
        return functional_call(self.router, params, (cond,))[1]


def build_moe(cfg) -> MoEModules:
    """The proton family's MoE of training from a config (``build_moe``,
    ``zdcsim/models/__init__.py:114``). The neutron family's discriminator
    and aux regressor are not ported yet."""
    m = cfg.model
    if m.architecture != "proton":
        raise NotImplementedError(
            "training the neutron family (DiscriminatorNeutron, AuxRegNeutron, MaskedBatchNorm's "
            "training form) is not ported yet: ROADMAP.md Queue 1 item 6b")
    gen_cls, kwargs = generator_spec(m.architecture, m.generator.version, m.norm,
                                     m.generator.width)
    shape = tuple(cfg.dataset.input_image_shape)
    with torch.device("meta"):
        modules = (gen_cls(noise_dim=m.noise_dim, cond_dim=m.cond_dim, **kwargs),
                   Discriminator(cond_dim=m.cond_dim, image_shape=shape), AuxReg(),
                   RouterNetwork(n_experts=m.n_experts, cond_dim=m.cond_dim,
                                 widths=m.router.widths))
    return MoEModules(*modules, n_experts=int(m.n_experts), noise_dim=int(m.noise_dim),
                      cond_dim=int(m.cond_dim), image_shape=shape,
                      names={k: type(v).__name__ for k, v in
                             zip(("generator", "discriminator", "aux_reg", "router"), modules)})


def count_parameters(params: Tree) -> int:
    """Total element count of a flat tree of tensors."""
    return sum(int(v.numel()) for v in params.values())


def model_info(modules: MoEModules, state) -> str:
    """The components and their parameter counts (``model_info``,
    ``zdcsim/models/__init__.py:207``): the stacked components as E x the
    count of one expert."""
    e = modules.n_experts
    lines = [f"MoE system: {e} expert(s), noise_dim={modules.noise_dim}, "
             f"cond_dim={modules.cond_dim}, image={modules.image_shape}"]
    for name, comp in (("generator", state.gen), ("discriminator", state.disc),
                       ("aux_reg", state.aux)):
        total = count_parameters(comp.params)
        lines.append(
            f"  {name:14s} {modules.names.get(name, '?'):28s} "
            f"{total:>12,d} params ({total // e:,d}/expert)"
        )
    r = count_parameters(state.router.params)
    lines.append(f"  {'router':14s} {modules.names.get('router', '?'):28s} {r:>12,d} params")
    return "\n".join(lines)
