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

The neutron family's generator and aux regressor have a training form
(``train_form``): dropout on given keep masks and, under ``model.norm=batch``
(``MoEModules.masked``), ``MaskedBatchNorm`` statistics over each expert's
routed sub-batch, as JAX's ``generator_masked`` / ``aux_reg_masked``. Their
stats (BatchNorm running means and variances) sit in the train state keyed
by Flax's ``batch_stats`` paths joined by ``|``, and reach the modules as
their buffers (:func:`bn_buffers`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn
from torch.func import functional_call

from zdcsim_torch.models.neutron import (
    AuxRegNeutron, DiscriminatorNeutron, GeneratorNeutron, GeneratorNeutronV2,
)
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


_BUFFERS = {"mean": "running_mean", "var": "running_var"}


def bn_buffers(stats: Optional[Tree]) -> Tree:
    """BatchNorm stats keyed by Flax path (``MaskedBatchNorm_0|mean``) -> the
    modules' buffer names (``MaskedBatchNorm_0.running_mean``)."""
    out = {}
    for k, v in (stats or {}).items():
        path, _, leaf = k.rpartition("|")
        out[f"{path.replace('|', '.')}.{_BUFFERS[leaf]}"] = v
    return out


@dataclass
class MoEModules:
    """One expert's generator, discriminator and aux regressor, the router,
    and the geometry (counterpart of ``zdcsim/models/__init__.py:82``). The
    modules hold no weights of their own: the train state does, stacked.
    ``masked``: the generator's and the aux regressor's BatchNorm take each
    expert's routing mask (neutron ``model.norm=batch``: JAX's
    ``generator_masked`` / ``aux_reg_masked``)."""

    generator: nn.Module
    discriminator: nn.Module
    aux_reg: nn.Module
    router: nn.Module
    n_experts: int
    noise_dim: int
    cond_dim: int
    image_shape: Tuple[int, int]
    names: Dict[str, str] = field(default_factory=dict)
    masked: bool = False

    def generate(self, params: Tree, noise: torch.Tensor, cond: torch.Tensor,
                 stats: Optional[Tree] = None) -> torch.Tensor:
        """Every expert on the same ``noise``, ``cond`` in eval (BatchNorm on
        the running ``stats``): ``[E, B, H, W, 1]``."""
        return torch.stack([self.generate_one(p, noise, cond, s) for p, s in
                            zip(expert_slices(params, self.n_experts),
                                expert_slices(stats or {}, self.n_experts))])

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
        (``None``: no dropout), a regressor without stats: ``[E, B, 2]``."""
        return self.regress_all(params, {}, img, keep)[0]

    def regress_all(self, params: Tree, stats: Tree, img: torch.Tensor,
                    keep: Optional[Sequence[torch.Tensor]] = None,
                    masks: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Tree]:
        """:meth:`regress` in training form with the stacked ``stats`` and
        each expert's BatchNorm routing mask ``masks[e]`` (``None``: the
        statistics of the whole batch): ``([E, B, 2], new stats stacked)``."""
        outs = [self.regress_train(p, s, x, None if keep is None else tuple(k[e] for k in keep),
                                   None if masks is None else masks[e])
                for e, (p, s, x) in enumerate(zip(expert_slices(params, self.n_experts),
                                                  expert_slices(stats, self.n_experts),
                                                  img.unbind(0)))]
        preds, new = zip(*outs)
        return torch.stack(preds), stack_trees(new) if new[0] else {}

    # One expert on a chunk (``params``/``stats``: its slice, :func:`expert_slices`),
    # the handles of the switch step (JAX's ``generator_single``,
    # ``discriminator_single``, ``aux_reg_single``).

    def generate_one(self, params: Tree, noise: torch.Tensor, cond: torch.Tensor,
                     stats: Optional[Tree] = None) -> torch.Tensor:
        """``[T, H, W, 1]`` in eval (no dropout; BatchNorm on the running
        ``stats``)."""
        return functional_call(self.generator, {**params, **bn_buffers(stats)}, (noise, cond))

    def generate_train(self, params: Tree, stats: Optional[Tree], noise: torch.Tensor,
                       cond: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None,
                       mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Tree]:
        """``([T, H, W, 1], new stats)`` in training form, with the rows'
        keep masks (``None``: no dropout) and the BatchNorm routing ``mask``
        ``[T]``; a generator without a training form runs its forward and
        returns no stats."""
        if not getattr(self.generator, "train_form", False):
            return self.generate_one(params, noise, cond), {}
        return functional_call(self.generator, {**params, **bn_buffers(stats)},
                               (noise, cond, True, keep, mask))

    def discriminate_one(self, params: Tree, stats: Tree, img: torch.Tensor, cond: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(scores [T, 1], latents [T, F])`` with ``train=False``: spectral
        norm's ``u`` is read, not advanced."""
        scores, latents, _ = functional_call(self.discriminator, params, (img, cond, stats, False))
        return scores, latents

    def regress_one(self, params: Tree, img: torch.Tensor,
                    keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``[T, 2]`` with the chunk rows' keep masks (``None``: the eval form;
        the stats-free regressors of the switch step)."""
        return self.regress_train(params, {}, img, keep)[0]

    def regress_train(self, params: Tree, stats: Optional[Tree], img: torch.Tensor,
                      keep: Optional[Sequence[torch.Tensor]] = None,
                      mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Tree]:
        """``([T, 2], new stats)`` in training form (the proton ``AuxReg``:
        its forward with ``keep``, no stats)."""
        if not getattr(self.aux_reg, "train_form", False):
            return functional_call(self.aux_reg, params, (img, keep)), {}
        return functional_call(self.aux_reg, {**params, **bn_buffers(stats)},
                               (img, keep, True, mask))

    def route(self, params: Tree, cond: torch.Tensor) -> torch.Tensor:
        """The router's logits ``[B, E]``."""
        return functional_call(self.router, params, (cond,))[1]


def build_moe(cfg) -> MoEModules:
    """The MoE of training from a config (``build_moe``,
    ``zdcsim/models/__init__.py:114``): the family's generator (``generator_spec``),
    discriminator and aux regressor, and the router. The neutron family's
    ``model.norm`` reaches its generator and aux regressor; under ``batch``
    their BatchNorm statistics are masked per expert (``masked``)."""
    m = cfg.model
    gen_cls, kwargs = generator_spec(m.architecture, m.generator.version, m.norm,
                                     m.generator.width)
    shape = tuple(cfg.dataset.input_image_shape)
    neutron = m.architecture == "neutron"
    with torch.device("meta"):
        modules = (gen_cls(noise_dim=m.noise_dim, cond_dim=m.cond_dim, **kwargs),
                   (DiscriminatorNeutron if neutron else Discriminator)(
                       cond_dim=m.cond_dim, image_shape=shape),
                   AuxRegNeutron(norm=m.norm) if neutron else AuxReg(),
                   RouterNetwork(n_experts=m.n_experts, cond_dim=m.cond_dim,
                                 widths=m.router.widths))
    return MoEModules(*modules, n_experts=int(m.n_experts), noise_dim=int(m.noise_dim),
                      cond_dim=int(m.cond_dim), image_shape=shape,
                      names={k: type(v).__name__ for k, v in
                             zip(("generator", "discriminator", "aux_reg", "router"), modules)},
                      masked=neutron and m.norm == "batch")


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
