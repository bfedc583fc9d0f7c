"""The fast-sim serving path (counterpart of ``zdcsim/inference/engine.py``).

Route each conditioning vector with the router (float32, argmax), draw or
take the noise, decode every sample with its routed expert, and invert the
log transform with ``expm1``.

Precisions (the JAX names, so one maps onto the other):

- ``"f32"`` (the default): float32 weights and activations, the float fast
  decode; its convs run with cuDNN's TF32 off, so float32 stays float32 on
  the card;
- ``"bf16"``: the float fast decode in bf16;
- ``"int8"``: bf16 weights and activations, int8 Conv_0/Conv_1/Conv_2, every
  stage plain PyTorch (the JAX XLA int8 backend); the only precision that
  takes static activation scales (``static_act_quant``);
- ``"int8_pallas_ab"``: as ``"int8"``, with the MLP's LayerNorm + quant and
  Conv_0 on the two CUDA kernels that replace Pallas kernels A and B
  (``zdcsim_torch/ops/decode_kernels.py``);
- ``"int8_pallas"``: as ``"int8_pallas_ab"``, with GroupNorm2d_0 + quant and
  the row-resize Conv_1 on the CUDA kernels that replace Pallas kernels C
  and D as well (all four decode kernels);
- ``"int8_fused_front"``: the MLP in bf16, then the LayerNorm -> Conv_0 ->
  GroupNorm_0 -> resize front on the CUDA kernel that replaces Pallas
  kernel G (``zdcsim_torch/ops/fused_decode_kernels.py``), then the plain
  int8 Conv_1 and the ``"int8"`` tail;
- ``"int8_fused"``: the MLP in bf16, then the whole decode on the CUDA
  kernel that replaces Pallas kernel H.

The two fused precisions serve full-width trees only (as in JAX); another
width raises ``ValueError`` when the engine is built.

On a CPU device the kernels' plain versions run instead.

The neutron family (``cfg.model.architecture == "neutron"``; JAX's
``engine.py:143-160``): a ``GeneratorNeutron`` tree with ``batch_stats``
(``gen_stats``) is folded once per expert at build
(``models/neutron_fast.py``), and a ``norm="none"`` student's tree is served
as it is; both decode with ``fast_neutron_apply``, ``"int8"`` on int8 convs.
Any other neutron tree (the group-norm teacher, ``GeneratorNeutronV2``)
serves the float module forward in the compute dtype, on ``"int8"`` too
(bf16, as JAX). The four kernel precisions are proton only: JAX documents
them so and runs its XLA int8 on a neutron tree, but the port refuses them
there (``ValueError``) rather than report a kernel path that launches no
kernel.

The serving paths, as in JAX:

- :meth:`FastSim.simulate` / :meth:`FastSim.throughput`: dense, every
  expert decodes every sample, then the routed gather;
- :meth:`FastSim.simulate_switch` / :meth:`FastSim.throughput_switch`:
  tiled-switch dispatch (``inference/switch_dispatch.py``), single-expert
  work; :meth:`FastSim._build_switch` sets the tile and, with
  ``dyn_dispatch``, the branchless form that decodes all ``B/T + E`` tiles
  without a host read;
- :meth:`FastSim.simulate_bulk` / :meth:`FastSim.throughput_bulk`: the
  switch dispatch over every chunk. JAX compiles it into one ``lax.scan``
  program; here, on the card with ``dyn_dispatch``, one chunk's route ->
  dispatch -> decode -> scatter is captured once per ``(batch_size, tile)``
  as a CUDA graph and replayed per chunk (otherwise the eager chunk loop);
- :meth:`FastSim.simulate_grouped` / :meth:`FastSim.simulate_stream` (and
  their ``throughput_*``): host-side buckets per expert, as JAX's
  ``decode_one``: through the generator module in the compute dtype, or
  ``fast_neutron_apply`` on a folded neutron tree.

PyTorch runs eagerly, so the JAX engine's other one-program forms are
Python loops over chunks and tiles.

On a mesh (``mesh=``, a ``zdcsim_torch.parallel.make_mesh`` of
``torch.distributed`` ranks; JAX's ``mesh`` argument) every rank holds the
weights, broadcast from rank 0, and serves the same call: the dense, switch
and bulk paths split each chunk over the data axis (every rank draws the
whole chunk's noise from its identically seeded generator and keeps its own
rows), decode their rows, and all-gather the images and expert ids over the
data axis, so every rank returns the whole result; ranks that share a data
coordinate repeat one another's work, as JAX's ``P("data")`` specs do. The
grouped and stream paths take no sharded path (nor do JAX's): every rank
decodes the whole workload. The int8 XLA path quantises activations per
tensor, so a rank's rows quantise on their own scale, as in JAX's sharded
engine; the kernel precisions quantise per sample and are unchanged.

:meth:`FastSim.from_state` serves a train state (``zdcsim_torch/train/
state.py``, the EMA generator by default) and :meth:`FastSim.from_checkpoint`
a checkpoint of one (``zdcsim_torch/train/checkpoint.py``): the state holds
the PyTorch layout, which ``convert.from_state_dict`` takes back to the Flax
layout the engine is built from, so a trained full-width state serves on
every precision, the kernel paths included.

Tracing (``zdcsim_torch/utils/profiling.py``): the spans ``serve.bulk`` (one
call of :meth:`FastSim.simulate_bulk` or :meth:`FastSim.simulate_switch`),
``serve.chunk`` (each chunk), ``serve.route`` (:meth:`FastSim._route`) and
``serve.replay`` (the dyn form's graph replay), around the dispatch's own
``serve.table`` and ``serve.decode``; recorded only under a profiler.
``FastSim.simulate_switch.showers`` counts the real rows the switch and
bulk paths return (on a mesh, those of this rank's share of each chunk,
the rows it decoded). A captured graph carries the counts of the work it
holds: the kernel launches and the dispatch's lanes counted during its
capture are taken back and added again at each replay.
"""

from __future__ import annotations

import functools
import gc
import math
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from zdcsim_torch.config import Config, load_config
from zdcsim_torch.convert import (
    expert, from_jax_params, from_state_dict, stats_from_jax, stats_to_jax, to_state_dict,
    tree_to_torch,
)
from zdcsim_torch.device import default_device
from zdcsim_torch.inference.switch_dispatch import tiled_switch_decode
from zdcsim_torch.models import generator_spec
from zdcsim_torch.models.neutron import GeneratorNeutron
from zdcsim_torch.models.neutron_fast import (
    fast_neutron_apply, fold_neutron_params, is_foldable, is_prefolded, quantize_neutron_weights,
)
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.models.proton_fast import fast_generator_apply, quantize_weights
from zdcsim_torch.models.router import build_router, router_version
from zdcsim_torch.ops import COUNTERS, kernel_wrappers
from zdcsim_torch.parallel.mesh import (
    DATA_AXIS, batch_sharding, gather_rows, gather_state, place_tree, replicated,
)
from zdcsim_torch.utils.artifact import _unflatten
from zdcsim_torch.utils.profiling import add_counts, read_counts, span, take_counts

# precision -> int8 backend of fast_generator_apply (None: the float decode)
_BACKENDS = {"f32": None, "bf16": None, "int8": "xla", "int8_pallas_ab": "pallas_ab",
             "int8_pallas": "pallas", "int8_fused_front": "fused_front", "int8_fused": "fused"}


def _stack(trees: List[Any]) -> Any:
    """Per-expert trees -> one tree with every tensor stacked on a leading
    ``[E, ...]`` axis; other leaves (the row-phase offsets) must agree."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(xs)) for xs in zip(*trees))
    if any(t != first for t in trees):
        raise ValueError(f"per-expert leaves differ: {trees}")
    return first


# The generator forwards of one expert, ``fwd(params, qweights, scales, z, c,
# amax_out=None) -> [T, H, W, 1]`` in the compute dtype; the engine binds
# their leading arguments with functools.partial.

def _proton_forward(dtype: torch.dtype, int8_backend: Optional[str], params, qweights, scales,
                    z: torch.Tensor, c: torch.Tensor, amax_out=None) -> torch.Tensor:
    """``fast_generator_apply`` (``int8_backend`` ``None``: the float decode)."""
    return fast_generator_apply(
        params, z, c.to(dtype), int8=int8_backend is not None,
        int8_backend=int8_backend or "xla", qweights=qweights, act_scales=scales,
        amax_out=amax_out,
    )


def _neutron_forward(dtype: torch.dtype, int8: bool, params, qweights, scales,
                     z: torch.Tensor, c: torch.Tensor, amax_out=None) -> torch.Tensor:
    """``fast_neutron_apply`` on a folded (or prefolded) tree."""
    return fast_neutron_apply(params, z, c.to(dtype), int8=int8, qweights=qweights,
                              act_scales=scales, amax_out=amax_out)


def _module_forward(module: torch.nn.Module, dtype: torch.dtype, state, qweights, scales,
                    z: torch.Tensor, c: torch.Tensor, amax_out=None) -> torch.Tensor:
    """The generator module's eval forward on ``state`` (its ``state_dict``
    in the compute dtype) through ``torch.func.functional_call``: one module
    serves every expert's weights. ``module`` is built on the meta device,
    so a parameter missing from ``state`` fails instead of serving
    stand-in weights."""
    return torch.func.functional_call(module, state, (z, c.to(dtype)))


def _decode(fwd, params, qweights, scales, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One expert's decode of ``[T]`` samples by ``fwd``, then ``expm1`` in
    f32: ``[T, H, W]``."""
    # cuDNN runs float32 convs in TF32 unless told not to (a bf16 conv is
    # unaffected); the context restores the caller's flags
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        img = fwd(params, qweights, scales, z, c)
    return torch.expm1(img[..., 0].to(torch.float32))


def _decode_dyn(fwd, stacked, e_k: torch.Tensor, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """:func:`_decode` on the weights of expert ``e_k`` (a 0-d device tensor)
    gathered from the :func:`_stack` tree ``stacked``."""
    return _decode(fwd, *_take(stacked, e_k), z, c)


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``n`` rows."""
    return t if t.shape[0] == n else torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])


def _take(tree: Any, e: torch.Tensor) -> Any:
    """Expert ``e``'s slice (``e`` a 0-d device tensor) of a :func:`_stack`
    tree, each tensor gathered into a fresh contiguous one."""
    if torch.is_tensor(tree):
        return tree.index_select(0, e.reshape(1))[0]
    if isinstance(tree, dict):
        return {k: _take(v, e) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(v, e) for v in tree)
    return tree


class FastSim:
    """Fast-simulation engine of the proton and neutron families.

    Args:
        gen_params / router_params: numpy Flax trees as
            ``zdcsim_torch.utils.artifact.load_serving_artifact`` returns
            them (generator experts stacked on the leading axis).
        batch_size: the chunk size inputs are split into and padded to.
            ``None``: 8192 for the switch, bulk, grouped and stream paths and
            ``DENSE_SAFE_BATCH`` for the dense all-expert path; a given size
            applies to every path.
        precision: ``"f32"``, ``"bf16"``, ``"int8"``, ``"int8_pallas_ab"``,
            ``"int8_pallas"``, ``"int8_fused_front"`` or ``"int8_fused"`` (see
            the module doc); the last four take the proton family only.
        device: ``None`` for CUDA (raises without a card), or ``"cpu"``.
        cfg: model geometry and family (``model.architecture``,
            ``model.generator.version``, ``model.norm``, widths, the image
            shape, the router's ``model.router.version``); defaults to
            ``load_config()``.
        scaler_cond: optional ``zdcsim_torch.data.scalers.StandardScaler`` of
            the raw kinematics (:meth:`standardize`).
        static_act_quant: on ``"int8"``, quantise activations with static
            per-expert scales calibrated once at build time
            (:meth:`_calibrate_act_scales`) instead of one max per call;
            values beyond a scale's range clip at +-127. The kernel
            precisions quantise per sample inside their kernels, so they
            refuse it (``ValueError``); the float precisions, and a neutron
            tree served by its module, ignore it (as JAX).
        gen_stats: the generator's ``{"batch_stats": ...}`` collection
            (a ``norm="batch"`` neutron tree's running statistics), or
            ``None``.
        mesh: a ``zdcsim_torch.parallel.Mesh``, or ``None`` (one device).
            Every rank of the mesh builds the engine and makes every serving
            call, in the same order (they are collective); the engine runs
            on the mesh's device, and ``device`` must be ``None`` or of its
            type. The batch sizes must be multiples of the data axis's
            size (``ValueError`` at the call, as JAX).

    Attributes (JAX's): ``uses_fast_path``, the proton family's fast decode;
    ``fast_neutron``, a folded or prefolded neutron tree on
    ``fast_neutron_apply``. With neither, the generator module serves.
    """

    DENSE_SAFE_BATCH = 2048
    # Static-quant calibration: max-abs over CAL_BATCH standard-normal
    # samples, inflated by ACT_SCALE_MARGIN to cover serving-batch tails.
    CAL_BATCH = 1024
    ACT_SCALE_MARGIN = 1.25

    def __init__(self, gen_params: Any, router_params: Any, batch_size: Optional[int] = None,
                 precision: str = "f32", device=None, cfg: Optional[Config] = None,
                 scaler_cond=None, static_act_quant: bool = False, gen_stats: Any = None,
                 mesh=None):
        if precision not in _BACKENDS:
            raise ValueError(
                f"precision must be one of {sorted(_BACKENDS)} in this port, got {precision!r}"
            )
        if static_act_quant and _BACKENDS[precision] not in (None, "xla"):
            # the kernels quantise per sample and ignore the scales, so a
            # calibration would apply to only part of the decode
            raise ValueError(
                "static_act_quant requires the XLA int8 backend "
                f"(precision='int8'), got backend {_BACKENDS[precision]!r}"
            )
        cfg = cfg or load_config()
        m = cfg.model
        if m.architecture == "neutron" and _BACKENDS[precision] not in (None, "xla"):
            raise ValueError(
                f"precision {precision!r} runs the proton decode kernels: proton only (the "
                "neutron family serves on 'f32', 'bf16' or 'int8')"
            )
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} is not the mesh's {mesh.device}")
            device = mesh.device
        self._mesh = mesh
        self.device = default_device(device)
        self.batch_size = int(batch_size) if batch_size is not None else 8192
        self.dense_batch_size = (int(batch_size) if batch_size is not None
                                 else min(self.DENSE_SAFE_BATCH, self.batch_size))
        self.scaler_cond = scaler_cond
        self.noise_dim = int(m.noise_dim)
        self.cond_dim = int(m.cond_dim)
        self.n_experts = int(m.n_experts)
        self.image_shape = tuple(cfg.dataset.input_image_shape)
        self.precision = precision
        self._dtype = torch.float32 if precision == "f32" else torch.bfloat16
        self._gen_spec = generator_spec(m.architecture, m.generator.version, m.norm,
                                        m.generator.width)

        gen, router_sd = from_jax_params(gen_params, router_params)
        stats = stats_from_jax(gen_stats)
        n_stacked = gen["Conv_0"]["kernel"].shape[0]
        if n_stacked != self.n_experts:
            raise ValueError(f"weights hold {n_stacked} experts, config says {self.n_experts}")
        trees = [expert(gen, e) for e in range(self.n_experts)]
        self.uses_fast_path = self._gen_spec[0] is Generator
        # JAX's _fast_neutron rule: fold a batch-norm tree that has its
        # statistics, serve a prefolded student as it is
        self.fast_neutron = False
        if self._gen_spec[0] is GeneratorNeutron:
            if stats and is_foldable(trees[0]):
                trees = [fold_neutron_params(t, expert(stats, e)) for e, t in enumerate(trees)]
                stats = {}
                self.fast_neutron = True
            elif is_prefolded(trees[0]):
                self.fast_neutron = True
            elif is_foldable(trees[0]):
                raise ValueError("a norm='batch' neutron tree needs its running statistics "
                                 "(gen_stats)")
        self._int8_backend = _BACKENDS[precision] if self.uses_fast_path else None
        self._int8 = (self._int8_backend is not None
                      or (self.fast_neutron and precision == "int8"))
        if self.uses_fast_path:
            self._fwd = functools.partial(_proton_forward, self._dtype, self._int8_backend)
        elif self.fast_neutron:
            self._fwd = functools.partial(_neutron_forward, self._dtype, self._int8)
        else:
            self._fwd = self._module_fwd()
            trees = [to_state_dict(t, expert(stats, e) if stats else None)
                     for e, t in enumerate(trees)]
        self._experts = [tree_to_torch(t, dtype=self._dtype, device=self.device) for t in trees]
        if mesh is not None:
            # serving replicates the weights (JAX's device_put to replicated)
            self._experts = [place_tree(replicated(mesh), t) for t in self._experts]
        if not self._int8:
            self._qweights = [None] * self.n_experts
        elif self.uses_fast_path:
            self._qweights = [quantize_weights(p, self._int8_backend) for p in self._experts]
        else:
            self._qweights = [quantize_neutron_weights(p) for p in self._experts]
        # The router stays float32: routing logits are cheap and precision-sensitive.
        self.router = build_router(m).to(self.device)  # model.router.version's
        if mesh is not None:
            router_sd = place_tree(replicated(mesh), router_sd)
        self.router.load_state_dict(router_sd)
        self.router.eval()

        # Static activation scales: per expert {site: f32 scalar}, or None.
        self._act_scales: Optional[List[Dict[str, torch.Tensor]]] = None
        # min over sites and experts of (margined calibration amax) /
        # (validation amax): above 1, no clipping seen at 4x the batch
        self.act_scale_headroom: Optional[float] = None
        if static_act_quant and self._int8:
            self._act_scales = self._calibrate_act_scales()
        self._build_switch()

    def _module_fwd(self):
        """:func:`_module_forward` bound to one generator module (on the meta
        device: every weight comes from the expert's state)."""
        cls, kwargs = self._gen_spec
        with torch.device("meta"):
            module = cls(self.noise_dim, self.cond_dim, **kwargs).eval()
        return functools.partial(_module_forward, module, self._dtype)

    # -- the decode of one expert ------------------------------------------

    def _expert_args(self, e: int):
        scales = self._act_scales[e] if self._act_scales is not None else None
        return self._experts[e], self._qweights[e], scales

    def _calibrate_act_scales(self) -> List[Dict[str, torch.Tensor]]:
        """Per-expert static int8 activation scales (JAX's
        ``_calibrate_act_scales``): each expert's ``"int8"`` forward on a
        standard-normal batch of ``CAL_BATCH`` captures each quant site's
        max|x| (``amax_out``); its scale is ``max(amax * ACT_SCALE_MARGIN,
        1e-12) / 127``. A validation batch of ``4 * CAL_BATCH`` sets
        :attr:`act_scale_headroom`. Conditions enter the engine standardised,
        so N(0, 1) is the representative calibration distribution.

        The batches come from CPU ``torch.Generator``s seeded 0 and 1 (noise,
        then conditions), so the card and the CPU calibrate on the same
        numbers. They are not JAX's ``jax.random`` draws, which torch cannot
        reproduce: the two packages' scales agree in distribution, not bit
        for bit."""
        def amax(n: int, seed: int) -> List[Dict[str, torch.Tensor]]:
            gen = torch.Generator().manual_seed(seed)
            z = torch.randn((n, self.noise_dim), generator=gen)
            c = torch.randn((n, self.cond_dim), generator=gen)
            z, c = (t.to(self.device, self._dtype) for t in (z, c))
            out = []
            with torch.no_grad():
                for p, q in zip(self._experts, self._qweights):
                    d: Dict[str, torch.Tensor] = {}
                    self._fwd(p, q, None, z, c, amax_out=d)
                    out.append(d)
            return out

        m = float(self.ACT_SCALE_MARGIN)
        cal, val = amax(self.CAL_BATCH, 0), amax(4 * self.CAL_BATCH, 1)
        ratios = [(a[k] * m) / torch.clamp(v[k], min=1e-12)
                  for a, v in zip(cal, val) for k in a]
        self.act_scale_headroom = float(torch.stack(ratios).min())
        return [{k: torch.clamp(a_k * m, min=1e-12) / 127.0 for k, a_k in a.items()} for a in cal]

    # -- switch dispatch -------------------------------------------------------

    def _build_switch(self, tile: int = 128, dyn_dispatch: bool = False) -> None:
        """Set the dispatch tile of the switch and bulk paths (JAX default
        128) and their form.

        ``dyn_dispatch=True`` decodes each tile branchlessly: the tile's
        expert weights (parameters, the kernel precisions' packed int8
        weights and the static scales, stacked on a leading ``[E, ...]`` axis
        once here) are gathered by the tile's expert index on the device and
        run through one decode body, for all ``B/T + E`` tiles; nothing is
        read to the host, and on the card :meth:`simulate_bulk` replays it as
        a CUDA graph. Value-identical to the per-expert form. A rebuild drops
        the captured graphs, which hold the previous form.
        """
        self._tile = int(tile)
        self._dyn = bool(dyn_dispatch)
        self._graphs: Dict[Tuple[int, int], Any] = {}
        # partials of module-level functions, not closures over self: an
        # engine must leave no reference cycle, or the garbage collector may
        # free it (and destroy its graphs) in the middle of another capture
        self._decoders = [functools.partial(_decode, self._fwd, *self._expert_args(e))
                          for e in range(self.n_experts)]
        # the stacked [E, ...] weights the dyn decoder gathers from
        self._stacked = None
        self._decode_dyn = None
        if self._dyn:
            self._stacked = _stack([list(self._expert_args(e)) for e in range(self.n_experts)])
            self._decode_dyn = functools.partial(_decode_dyn, self._fwd, self._stacked)

    @torch.no_grad()
    def _route(self, cond: torch.Tensor) -> torch.Tensor:
        with span("serve.route"):
            return torch.argmax(self.router(cond)[1], dim=-1)

    @torch.no_grad()
    def _sim_switch(self, cond: torch.Tensor, noise: torch.Tensor):
        idx = self._route(cond)
        # the tile must divide the batch: fall back to their largest common divisor
        tile = math.gcd(cond.shape[0], self._tile)
        imgs = tiled_switch_decode(self._decoders, idx, cond, noise, self.image_shape,
                                   tile=tile, decode_dyn=self._decode_dyn)
        return imgs, idx

    def _sharded(self, sim, cond: torch.Tensor, noise: torch.Tensor):
        """``sim(cond, noise) -> (images, ids)`` of one chunk; on a mesh, of
        this rank's rows of it, the rows all-gathered back over the data
        axis (JAX's ``P("data")`` in and out). Raises JAX's ``ValueError``
        where the data axis does not divide the chunk."""
        if self._mesh is None:
            return sim(cond, noise)
        self._check_batch(cond.shape[0])
        rows = batch_sharding(self._mesh)
        imgs, idx = sim(rows.place(cond), rows.place(noise))
        return gather_rows(self._mesh, imgs), gather_rows(self._mesh, idx)

    def _count_showers(self, bs: int, m: int) -> None:
        """Count the ``m`` real rows of a chunk of ``bs``; on a mesh, those
        among this rank's rows of it."""
        if self._mesh is not None:
            rows = bs // self._mesh.shape[DATA_AXIS]
            i = self._mesh.coords[self._mesh.axis_names.index(DATA_AXIS)]
            m = min(max(m - i * rows, 0), rows)
        FastSim.simulate_switch.showers += m

    def _check_batch(self, batch: int) -> None:
        n_data = self._mesh.shape[DATA_AXIS]
        if batch % n_data != 0:
            raise ValueError(
                f"batch_size {batch} must be divisible by the '{DATA_AXIS}' mesh axis size "
                f"{n_data} for sharded serving; pick batch_size = k * mesh.shape['data']"
            )

    def _inputs(self, cond, noise):
        """cond as f32 and noise (where given) in the compute dtype, on the
        engine's device."""
        cond = self._as_tensor(cond, torch.float32)
        if noise is not None:
            noise = self._as_tensor(noise, self._dtype)
            if noise.shape != (cond.shape[0], self.noise_dim):
                raise ValueError(f"noise must be [{cond.shape[0]}, {self.noise_dim}]")
        return cond, noise

    def _chunks(self, cond, noise, generator, bs: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
        """``(cond [bs, C], noise [bs, Z], m)`` per chunk of ``bs`` rows, the
        last padded with zero rows (``m`` real): the given noise's rows, or
        ``[bs, Z]`` drawn in the compute dtype from ``generator``."""
        cond, noise = self._inputs(cond, noise)
        for start in range(0, cond.shape[0], bs):
            c = _pad(cond[start:start + bs], bs)
            if noise is None:
                z = self._draw((bs, self.noise_dim), generator)
            else:
                z = _pad(noise[start:start + bs], bs)
            yield c, z, min(bs, cond.shape[0] - start)

    def simulate_switch(self, cond, noise=None, generator: Optional[torch.Generator] = None,
                        return_experts: bool = False):
        """Routed generation, ``batch_size`` samples per chunk.

        cond: ``[N, cond_dim]`` (array or tensor). noise: ``[N, noise_dim]``
        to decode with, or ``None`` to draw it per chunk in the compute dtype
        from ``generator`` (a ``torch.Generator`` on the engine's device;
        ``None`` uses the default one). Returns ``[N, H, W]`` float32 images
        (and the ``[N]`` expert ids with ``return_experts``).
        """
        with span("serve.bulk"):
            outs, idxs = [], []
            for c, z, m in self._chunks(cond, noise, generator, self.batch_size):
                with span("serve.chunk"):
                    imgs, idx = self._sharded(self._sim_switch, c, z)
                    outs.append(imgs[:m])
                    idxs.append(idx[:m])
                self._count_showers(self.batch_size, m)
            images = torch.cat(outs)
        return (images, torch.cat(idxs)) if return_experts else images

    def _bulk_graph(self):
        """The CUDA graph of one chunk of :meth:`_sim_switch` at
        ``(batch_size, tile)``, with its static input and output tensors,
        captured after one eager warm-up on a side stream. On a mesh it
        holds the decode of this rank's rows alone: a collective in the
        capture would break it, so the rows are gathered after each
        replay. The counts of the capture are stored with the graph
        (:func:`~zdcsim_torch.utils.profiling.take_counts`)."""
        key = (self.batch_size, self._tile)
        if key not in self._graphs:
            rows = self.batch_size
            if self._mesh is not None:
                self._check_batch(rows)
                rows //= self._mesh.shape[DATA_AXIS]
            cond = torch.zeros((rows, self.cond_dim), device=self.device)
            noise = torch.zeros((rows, self.noise_dim), device=self.device, dtype=self._dtype)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._sim_switch(cond, noise)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # No collection during the capture: freeing a garbage engine's
            # graph or memory there is a CUDA call the capture forbids, and
            # it invalidates the capture.
            gc.collect()
            enabled = gc.isenabled()
            gc.disable()
            before = read_counts([*kernel_wrappers().values(), tiled_switch_decode],
                                 (*COUNTERS, "lanes"))
            try:
                with torch.cuda.graph(graph):
                    imgs, idx = self._sim_switch(cond, noise)
            finally:
                if enabled:
                    gc.enable()
            self._graphs[key] = (graph, cond, noise, imgs, idx, take_counts(before))
        return self._graphs[key]

    def simulate_bulk(self, cond, noise=None, generator: Optional[torch.Generator] = None,
                      return_experts: bool = False):
        """Bulk serving (arguments and results as :meth:`simulate_switch`).

        On the card with ``dyn_dispatch`` each chunk replays one CUDA graph
        (:meth:`_bulk_graph`, JAX's one ``lax.scan`` program): its conditions
        and noise (drawn eagerly from ``generator`` as the eager loop draws
        them) are copied into the graph's inputs, and its outputs out of the
        graph's buffers, so the result equals :meth:`simulate_switch`'s.
        Otherwise it is :meth:`simulate_switch`'s chunk loop. Each replay
        adds the counts of its graph's capture to the counters. On a mesh
        each rank replays the decode of its rows, then the rows are
        all-gathered."""
        if not (self._dyn and self.device.type == "cuda"):
            return self.simulate_switch(cond, noise, generator, return_experts)
        with span("serve.bulk"):
            graph, g_cond, g_noise, g_imgs, g_idx, counts = self._bulk_graph()
            rows = None if self._mesh is None else batch_sharding(self._mesh)
            outs, idxs = [], []
            for c, z, m in self._chunks(cond, noise, generator, self.batch_size):
                with span("serve.chunk"):
                    g_cond.copy_(c if rows is None else rows.place(c))
                    g_noise.copy_(z if rows is None else rows.place(z))
                    with span("serve.replay"):
                        graph.replay()
                    imgs, idx = g_imgs, g_idx
                    if rows is not None:  # after the replay, outside the graph
                        imgs, idx = gather_rows(self._mesh, imgs), gather_rows(self._mesh, idx)
                    outs.append(imgs[:m].clone())
                    idxs.append(idx[:m].clone())
                add_counts(counts)
                self._count_showers(self.batch_size, m)
            images = torch.cat(outs)
        return (images, torch.cat(idxs)) if return_experts else images

    def throughput_bulk(self, n_showers: int = 65536, warmup: bool = True,
                        generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Steady-state bulk-serving rate on random conditions, timed on the
        host clock around work that ends in a device synchronise (the
        warm-up captures the graph)."""
        cond = torch.randn((n_showers, self.cond_dim), generator=generator, device=self.device)
        if warmup:
            self.simulate_bulk(cond, generator=generator)
            self._sync()
        t0 = time.perf_counter()
        out = self.simulate_bulk(cond, generator=generator)
        self._sync()
        dt = time.perf_counter() - t0
        del out
        return self._rate(n_showers, dt, self.batch_size)

    def throughput_switch(self, n_batches: int = 20, warmup: int = 3,
                          generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Steady-state tiled-switch rate, one scalar read back a batch in a
        depth-2 pipeline: batch i+1 is queued before batch i's sum is read,
        so the read hides behind the card's work."""
        bs = self.batch_size
        cond = torch.randn((bs, self.cond_dim), generator=generator, device=self.device)
        for _ in range(max(warmup, 1)):
            out, _ = self._sharded(self._sim_switch, cond,
                                   self._draw((bs, self.noise_dim), generator))
        float(out.sum())
        t0 = time.perf_counter()
        prev = None
        for _ in range(n_batches):
            out, _ = self._sharded(self._sim_switch, cond,
                                   self._draw((bs, self.noise_dim), generator))
            if prev is not None:
                float(prev.sum())
            prev = out
        float(prev.sum())
        return self._rate(n_batches * bs, time.perf_counter() - t0, bs)

    # -- dense all-expert path ---------------------------------------------------

    @torch.no_grad()
    def _sim_dense(self, cond: torch.Tensor, noise: torch.Tensor):
        """Every expert decodes every sample with the same noise, and each
        sample takes its routed expert's image (JAX's ``sim``, which applies
        ``expm1`` after the gather: the same values)."""
        idx = self._route(cond)
        imgs = torch.stack([decode(noise, cond) for decode in self._decoders])  # [E, B, H, W]
        return imgs[idx, torch.arange(cond.shape[0], device=cond.device)], idx

    def simulate(self, cond, noise=None, generator: Optional[torch.Generator] = None,
                 return_experts: bool = False):
        """Dense all-expert generation, ``dense_batch_size`` samples per chunk
        (arguments and results as :meth:`simulate_switch`). E times the
        decode work of the switch path; on ``"int8"`` its per-tensor scales
        span every sample of the chunk, so its outputs differ from the
        switch path's, whose scales span a tile."""
        outs, idxs = [], []
        for c, z, m in self._chunks(cond, noise, generator, self.dense_batch_size):
            imgs, idx = self._sharded(self._sim_dense, c, z)
            outs.append(imgs[:m])
            idxs.append(idx[:m])
        images = torch.cat(outs)
        return (images, torch.cat(idxs)) if return_experts else images

    def throughput(self, n_batches: int = 20, warmup: int = 3,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Steady-state dense rate, one scalar read back a batch."""
        bs = self.dense_batch_size
        cond = torch.randn((bs, self.cond_dim), generator=generator, device=self.device)
        for _ in range(max(warmup, 1)):
            out, _ = self._sharded(self._sim_dense, cond,
                                   self._draw((bs, self.noise_dim), generator))
        float(out.sum())
        t0 = time.perf_counter()
        for _ in range(n_batches):
            out, _ = self._sharded(self._sim_dense, cond,
                                   self._draw((bs, self.noise_dim), generator))
            float(out.sum())
        return self._rate(n_batches * bs, time.perf_counter() - t0, bs)

    # -- grouped and stream dispatch (host-side buckets) ---------------------

    def _build_grouped(self) -> None:
        """Per-expert decoders of the buckets, JAX's ``decode_one``: on a
        folded neutron tree ``fast_neutron_apply`` (without static scales,
        as JAX), else the generator module in the compute dtype (the proton
        family serves its buckets through ``Generator``, not its fast decode,
        on every precision)."""
        if self.uses_fast_path:
            args = [(to_state_dict(p), None, None) for p in self._experts]
            fwd = self._module_fwd()
        else:
            args = [(p, q, None) for p, q in zip(self._experts, self._qweights)]
            fwd = self._fwd
        self._grouped = [functools.partial(_decode, fwd, *a) for a in args]

    @torch.no_grad()
    def _decode_one(self, e: int, cond: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "_grouped"):
            self._build_grouped()
        return self._grouped[e](noise, cond)

    @staticmethod
    def _bucket_size(n: int, minimum: int = 256) -> int:
        size = minimum
        while size < n:
            size *= 2
        return size

    def _bucket(self, cond, noise, sel: np.ndarray, size: int, generator):
        """Rows ``sel`` of cond and of the per-sample noise padded with zero
        rows to ``size``, or ``[size, Z]`` noise drawn from ``generator`` of
        which the first ``len(sel)`` rows serve."""
        rows = torch.as_tensor(sel, device=self.device)
        c = cond.new_zeros((size, self.cond_dim))
        c[:sel.size] = cond[rows]
        if noise is None:
            return c, self._draw((size, self.noise_dim), generator)
        z = noise.new_zeros((size, self.noise_dim))
        z[:sel.size] = noise[rows]
        return c, z

    def simulate_grouped(self, cond, noise=None, generator: Optional[torch.Generator] = None,
                         return_experts: bool = False):
        """Grouped-dispatch generation: route on the card, one host read of
        the ids, then each expert's samples in one bucket padded to a power
        of two (:meth:`_bucket_size`) through its module alone.

        noise: ``[N, noise_dim]`` per sample, or ``None`` to draw ``[size,
        Z]`` per bucket from ``generator`` (JAX draws ``fold_in(key, e)``).
        Returns ``[N, H, W]`` float32 on the host, as JAX's numpy (and the
        ``[N]`` ids with ``return_experts``). On a mesh every rank decodes
        every bucket (JAX's grouped path has no sharded form)."""
        cond, noise = self._inputs(cond, noise)
        idx = self._route(cond).cpu().numpy()  # host sync
        out = torch.empty((cond.shape[0], *self.image_shape), dtype=torch.float32)
        for e in range(self.n_experts):
            sel = np.flatnonzero(idx == e)
            if sel.size == 0:
                continue
            c, z = self._bucket(cond, noise, sel, self._bucket_size(sel.size), generator)
            out[torch.from_numpy(sel)] = self._decode_one(e, c, z)[:sel.size].cpu()
        return (out, torch.from_numpy(idx)) if return_experts else out

    def simulate_stream(self, cond, noise=None, generator: Optional[torch.Generator] = None,
                        readback: bool = True, return_experts: bool = False):
        """Grouped generation for large workloads: route the whole workload
        in ``batch_size`` chunks (one host read of the ids), cut each
        expert's samples into chunks of ``batch_size`` (the last padded to a
        power of two) and queue every chunk's decode before reading any.

        noise: as :meth:`simulate_grouped`; ``None`` draws per chunk (JAX
        draws ``fold_in(key, e * 100003 + start)``). ``readback=False``
        returns the queued ``[(rows, images on the device)]``; otherwise
        ``[N, H, W]`` float32 on the host (and the ids with
        ``return_experts``). On a mesh every rank decodes every chunk, as
        :meth:`simulate_grouped`."""
        cond, noise = self._inputs(cond, noise)
        bs = self.batch_size
        idx = torch.cat([self._route(_pad(cond[s:s + bs], bs))[:bs]
                         for s in range(0, cond.shape[0], bs)])
        idx = idx[:cond.shape[0]].cpu().numpy()  # one host sync
        pending = []
        for e in range(self.n_experts):
            sel = np.flatnonzero(idx == e)
            for start in range(0, sel.size, bs):
                part = sel[start:start + bs]
                size = part.size if part.size == bs else self._bucket_size(part.size)
                c, z = self._bucket(cond, noise, part, size, generator)
                pending.append((part, self._decode_one(e, c, z)))
        if not readback:
            return pending
        out = torch.empty((cond.shape[0], *self.image_shape), dtype=torch.float32)
        for part, imgs in pending:
            out[torch.from_numpy(part)] = imgs[:part.size].cpu()
        return (out, torch.from_numpy(idx)) if return_experts else out

    def throughput_stream(self, n_showers: int = 65536, warmup: bool = True,
                          generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Steady-state streaming-grouped rate: one scalar read back a
        chunk, no image copied to the host."""
        cond = torch.randn((n_showers, self.cond_dim), generator=generator, device=self.device)
        if warmup:
            self.simulate_stream(cond[:self.batch_size * self.n_experts], generator=generator)
        t0 = time.perf_counter()
        pending = self.simulate_stream(cond, generator=generator, readback=False)
        total = sum(float(imgs.sum()) for _, imgs in pending)
        if total != total:
            raise FloatingPointError("throughput_stream: the served showers hold NaN")
        return self._rate(n_showers, time.perf_counter() - t0, self.batch_size)

    def throughput_grouped(self, n_batches: int = 20, warmup: int = 3,
                           generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Steady-state grouped-dispatch rate on one random batch."""
        bs = self.batch_size
        cond = torch.randn((bs, self.cond_dim), generator=generator, device=self.device)
        for _ in range(warmup):
            self.simulate_grouped(cond, generator=generator)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            self.simulate_grouped(cond, generator=generator)
        return self._rate(n_batches * bs, time.perf_counter() - t0, bs)

    # -- from a train state ------------------------------------------------------

    @classmethod
    def from_state(cls, modules, state, use_ema: bool = True, **kwargs) -> "FastSim":
        """An engine serving ``state``'s generator (its EMA unless ``use_ema``
        is off) behind its router, with the state's generator statistics
        (a ``norm="batch"`` neutron generator's running averages: folded, as
        JAX's ``from_state``). ``modules`` is the ``MoEModules`` the state
        was trained with, of a generator class ``build_moe`` builds (the
        tiny test stand-ins are not served); ``kwargs`` go to the
        constructor, whose ``cfg`` defaults to ``load_config()`` with the
        modules' geometry and router, for the proton generator (the neutron family's
        needs the run's ``cfg``). With ``mesh=``, ``state`` may be this
        rank's piece from ``zdcsim_torch.parallel.shard_state``: its
        expert-stacked leaves are gathered once here (``gather_state``,
        collective), then the weights replicate."""
        from zdcsim_torch.models import MODEL_REGISTRY

        if not any(".generator" in name and type(modules.generator) is cls
                   for name, cls in MODEL_REGISTRY.items()):
            raise ValueError(f"FastSim serves the generators of build_moe, not "
                             f"{modules.names.get('generator', type(modules.generator).__name__)}")
        if "cfg" not in kwargs and not isinstance(modules.generator, Generator):
            raise ValueError("FastSim.from_state of a neutron generator needs the run's cfg "
                             "(its norm and width)")
        if "cfg" not in kwargs:
            h, w = modules.image_shape
            kwargs["cfg"] = load_config([
                f"model.n_experts={modules.n_experts}", f"model.noise_dim={modules.noise_dim}",
                f"model.cond_dim={modules.cond_dim}", f"dataset.input_image_shape=[{h}, {w}]",
                f"model.router.version={router_version(modules.router)}"])
        if kwargs.get("mesh") is not None:
            state = gather_state(kwargs["mesh"], state, modules.n_experts)
        gen = state.ema_gen_params if use_ema else state.gen.params
        return cls(from_state_dict(gen, stacked=True), from_state_dict(state.router.params),
                   gen_stats=stats_to_jax(_unflatten(state.gen.stats)), **kwargs)

    @classmethod
    def from_checkpoint(cls, cfg: Config, dir_models: str, epoch: int, **kwargs) -> "FastSim":
        """An engine serving the checkpoint of ``epoch`` under ``dir_models``
        (``<experiment_dir>/models/``) of a run of ``cfg``'s model, through
        :meth:`from_state`; the state is restored on ``kwargs["device"]``."""
        from zdcsim_torch.models import build_moe
        from zdcsim_torch.train.checkpoint import checkpoint_file, restore_checkpoint
        from zdcsim_torch.train.state import init_state

        checkpoint_file(dir_models, epoch)  # a missing or foreign checkpoint, before the template
        if kwargs.get("mesh") is not None and kwargs.get("device") is None:
            kwargs["device"] = kwargs["mesh"].device
        modules = build_moe(cfg)
        state = restore_checkpoint(dir_models, epoch,
                                   init_state(modules, cfg, None, kwargs.get("device")))
        return cls.from_state(modules, state, cfg=cfg, **kwargs)

    # -- helpers -----------------------------------------------------------------

    def standardize(self, cond_raw) -> np.ndarray:
        """Raw kinematics -> the standardised conditions the router takes
        (``scaler_cond.transform``; unchanged float32 without a scaler)."""
        if self.scaler_cond is None:
            return np.asarray(cond_raw, np.float32)
        return self.scaler_cond.transform(cond_raw)

    def _draw(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device, dtype=self._dtype)

    @staticmethod
    def _rate(n: int, dt: float, batch: int) -> Dict[str, float]:
        return {"showers_per_sec": n / dt, "batch_size": float(batch), "seconds": dt,
                "n_showers": float(n)}

    def _as_tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


FastSim.simulate_switch.showers = 0
