"""The fast-sim serving path (counterpart of ``zdcsim/inference/engine.py``).

Route each conditioning vector with the router (float32, argmax), draw or
take the noise, decode every sample with its routed expert through the
tiled-switch dispatch and the fast proton decode (float or int8), and
invert the log transform with ``expm1``.

Precisions (the JAX names, so one maps onto the other):

- ``"f32"`` (the default): float32 weights and activations, the float fast
  decode; its convs run with cuDNN's TF32 off, so float32 stays float32 on
  the card;
- ``"bf16"``: the float fast decode in bf16;
- ``"int8"``: bf16 weights and activations, int8 Conv_0/Conv_1/Conv_2, every
  stage plain PyTorch (the JAX XLA int8 backend);
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

PyTorch runs eagerly, so the JAX engine's one-program forms become Python
loops over batch chunks and dispatch tiles; capturing them as CUDA graphs
is later work.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from zdcsim_torch.config import Config, load_config
from zdcsim_torch.convert import expert, from_jax_params, tree_to_torch
from zdcsim_torch.device import default_device
from zdcsim_torch.inference.switch_dispatch import tiled_switch_decode
from zdcsim_torch.models.proton_fast import fast_generator_apply, quantize_weights
from zdcsim_torch.models.router import RouterNetwork

# precision -> int8 backend of fast_generator_apply (None: the float decode)
_BACKENDS = {"f32": None, "bf16": None, "int8": "xla", "int8_pallas_ab": "pallas_ab",
             "int8_pallas": "pallas", "int8_fused_front": "fused_front", "int8_fused": "fused"}


class FastSim:
    """Proton fast-simulation engine.

    Args:
        gen_params / router_params: numpy Flax trees as
            ``zdcsim_torch.utils.artifact.load_serving_artifact`` returns
            them (generator experts stacked on the leading axis).
        batch_size: the chunk size inputs are split into and padded to.
        precision: ``"f32"``, ``"bf16"``, ``"int8"``, ``"int8_pallas_ab"``,
            ``"int8_pallas"``, ``"int8_fused_front"`` or ``"int8_fused"`` (see
            the module doc).
        device: ``None`` for CUDA (raises without a card), or ``"cpu"``.
        cfg: model geometry; defaults to ``load_config()``.
    """

    def __init__(self, gen_params: Any, router_params: Any, batch_size: Optional[int] = None,
                 precision: str = "f32", device=None, cfg: Optional[Config] = None):
        if precision not in _BACKENDS:
            raise ValueError(
                f"precision must be one of {sorted(_BACKENDS)} in this port, got {precision!r}"
            )
        cfg = cfg or load_config()
        self.device = default_device(device)
        self.batch_size = int(batch_size) if batch_size is not None else 8192
        self.noise_dim = int(cfg.model.noise_dim)
        self.cond_dim = int(cfg.model.cond_dim)
        self.n_experts = int(cfg.model.n_experts)
        self.image_shape = tuple(cfg.dataset.input_image_shape)
        self.precision = precision
        self._dtype = torch.float32 if precision == "f32" else torch.bfloat16
        self._int8_backend = _BACKENDS[precision]
        # Set by a static-activation-quant calibration, which this port does
        # not have yet; kept so callers can read it unconditionally.
        self.act_scale_headroom = None

        gen, router_sd = from_jax_params(gen_params, router_params)
        n_stacked = gen["Conv_0"]["kernel"].shape[0]
        if n_stacked != self.n_experts:
            raise ValueError(f"weights hold {n_stacked} experts, config says {self.n_experts}")
        self._experts = [
            tree_to_torch(expert(gen, e), dtype=self._dtype, device=self.device)
            for e in range(self.n_experts)
        ]
        self._qweights = [
            quantize_weights(p, self._int8_backend) if self._int8_backend else None
            for p in self._experts
        ]
        # The router stays float32: routing logits are cheap and precision-sensitive.
        self.router = RouterNetwork(
            self.n_experts, self.cond_dim, cfg.model.router.widths
        ).to(self.device)
        self.router.load_state_dict(router_sd)
        self.router.eval()
        self._decoders = [self._decoder(e) for e in range(self.n_experts)]
        self._tile = 128

    def _build_switch(self, tile: int = 128) -> None:
        """Set the dispatch tile of :meth:`simulate_switch` (JAX default 128)."""
        self._tile = int(tile)

    def _decoder(self, e: int):
        params, q = self._experts[e], self._qweights[e]
        int8 = self._int8_backend is not None

        def decode(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
            # cuDNN runs float32 convs in TF32 unless told not to (a bf16
            # conv is unaffected); the context restores the caller's flags
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                img = fast_generator_apply(
                    params, z, c.to(self._dtype), int8=int8,
                    int8_backend=self._int8_backend or "xla", qweights=q,
                )
            return torch.expm1(img[..., 0].to(torch.float32))

        return decode

    @torch.no_grad()
    def _sim_switch(self, cond: torch.Tensor, noise: torch.Tensor):
        _, logits = self.router(cond)
        idx = torch.argmax(logits, dim=-1)
        # the tile must divide the batch: fall back to their largest common divisor
        tile = math.gcd(cond.shape[0], self._tile)
        imgs = tiled_switch_decode(self._decoders, idx, cond, noise, self.image_shape, tile=tile)
        return imgs, idx

    def simulate_switch(self, cond, noise=None, generator: Optional[torch.Generator] = None,
                        return_experts: bool = False):
        """Routed generation, ``batch_size`` samples per chunk.

        cond: ``[N, cond_dim]`` (array or tensor). noise: ``[N, noise_dim]``
        to decode with, or ``None`` to draw it per chunk in the compute dtype
        from ``generator`` (a ``torch.Generator`` on the engine's device;
        ``None`` uses the default one). Returns ``[N, H, W]`` float32 images
        (and the ``[N]`` expert ids with ``return_experts``).
        """
        cond = self._as_tensor(cond, torch.float32)
        if noise is not None:
            noise = self._as_tensor(noise, self._dtype)
            if noise.shape != (cond.shape[0], self.noise_dim):
                raise ValueError(f"noise must be [{cond.shape[0]}, {self.noise_dim}]")
        n, bs = cond.shape[0], self.batch_size
        outs, idxs = [], []
        for start in range(0, n, bs):
            chunk = cond[start:start + bs]
            m = chunk.shape[0]
            if noise is None:
                z = torch.randn((bs, self.noise_dim), generator=generator,
                                device=self.device, dtype=self._dtype)
            else:
                z = noise[start:start + bs]
            if m < bs:
                chunk = torch.cat([chunk, chunk.new_zeros((bs - m, chunk.shape[1]))])
                z = torch.cat([z, z.new_zeros((bs - m, z.shape[1]))])
            imgs, idx = self._sim_switch(chunk, z)
            outs.append(imgs[:m])
            idxs.append(idx[:m])
        images = torch.cat(outs)
        return (images, torch.cat(idxs)) if return_experts else images

    def simulate_bulk(self, cond, noise=None, generator: Optional[torch.Generator] = None,
                      return_experts: bool = False):
        """Bulk serving. In JAX this is one ``lax.scan`` program over the
        chunks; here it runs the same chunk loop as :meth:`simulate_switch`
        (arguments and results as there)."""
        return self.simulate_switch(cond, noise, generator, return_experts)

    def throughput_bulk(self, n_showers: int = 65536, warmup: bool = True,
                        generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Steady-state bulk-serving rate on random conditions, timed on the
        host clock around work that ends in a device synchronise."""
        cond = torch.randn((n_showers, self.cond_dim), generator=generator, device=self.device)
        if warmup:
            self.simulate_bulk(cond, generator=generator)
            self._sync()
        t0 = time.perf_counter()
        out = self.simulate_bulk(cond, generator=generator)
        self._sync()
        dt = time.perf_counter() - t0
        del out
        return {
            "showers_per_sec": n_showers / dt,
            "batch_size": float(self.batch_size),
            "seconds": dt,
            "n_showers": float(n_showers),
        }

    def _as_tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
