"""The port's configuration: plain dataclasses, no YAML.

The defaults are copied from the keys of ``zdcsim/config/default.yaml`` that
the serving path, the fidelity gate's data split, the train step, the
training loop, its evaluator and callbacks, and the CLI read
(``tests/test_torch_artifact.py`` and ``tests/test_torch_loop.py`` hold them
equal to ``zdcsim.config.load_config()``). The router's hidden widths are not a key
of that file: they are fixed in ``zdcsim/models/router.py`` and copied here.
The neutron preset of ``zdcsim/config/neutron.yaml`` is
:data:`NEUTRON_OVERRIDES`, which a caller puts before its own overrides.
PyYAML is not assumed: overrides use the same ``a.b=c`` dotlist syntax as
``zdcsim.config.apply_overrides`` with a small scalar parser, and a key that
does not exist raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional, Tuple


@dataclass
class GeneratorConfig:
    version: str = "v1"  # v1: the reference architecture; neutron also has v2
    width: float = 1.0
    lr_g: float = 1.0e-4
    di_strength: float = 1.0e-1  # SDI-GAN diversity term
    in_strength: float = 1.0e-3  # photon-sum intensity term
    sdi_pairwise_quirk: bool = False  # the reference's [B, B] broadcast of the SDI term


@dataclass
class DiscriminatorConfig:
    lr_d: float = 1.0e-5


@dataclass
class AuxRegConfig:
    lr_a: float = 1.0e-4
    strength: float = 1.0e-3  # aux coordinate loss weight on the generator


@dataclass
class RouterConfig:
    widths: Tuple[int, ...] = (128, 64, 32)
    lr_r: float = 1.0e-4
    ed_strength: float = 0.0
    gan_strength: float = 1.0e-1
    diff_strength: float = 1.0e-6
    util_strength: float = 0.0
    alb_strength: float = 1.0e-5
    stop_router_training_epoch: Optional[int] = 40  # None: never frozen
    alpha: int = 60  # epochs of the ALB weight's ramp
    min_weight: float = 0.2
    tau_start: float = 1.2
    tau_min: float = 0.8
    tau_decay: float = 0.985
    differentiable_gan_term: bool = True  # False: the reference's constant GAN term


@dataclass
class ModelConfig:
    architecture: str = "proton"
    n_experts: int = 3
    noise_dim: int = 10
    cond_dim: int = 9
    norm: str = "batch"  # the neutron family's normalisation: batch, group or none
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    aux_reg: AuxRegConfig = field(default_factory=AuxRegConfig)
    router: RouterConfig = field(default_factory=RouterConfig)


@dataclass
class DatasetConfig:
    zdc_type: str = "proton"
    input_image_shape: Tuple[int, int] = (56, 30)
    MIN_INTENSITY_THRESHOLD: Optional[float] = 1  # photon-sum filter; None disables
    MAX_INTENSITY_THRESHOLD: Optional[float] = None
    read_n_samples: Optional[int] = None  # stratified subsample size; None keeps all
    shuffle_train_test_split: bool = True
    test_size: float = 0.2
    synthetic: bool = False
    synthetic_n_samples: int = 8192


@dataclass
class RunConfig:
    """The ``config`` section: the run's name, and the experiment directory
    and date that ``zdcsim_torch.utils.io.append_experiment_dir_to_cfg``
    stamps on it (``None`` until then)."""

    run_name: str = "zdcsim_train_run"
    experiment_dir: Optional[str] = None
    date: Optional[str] = None


@dataclass
class WandbConfig:
    log_experiments: bool = False  # a wandb run (a no-op where wandb is not installed)
    plot_images: bool = False  # the eval figures (not ported: ROADMAP.md Queue 1 item 7)
    run_name: Optional[str] = None  # stamped with the experiment directory


@dataclass
class TrainConfig:
    batch_size: int = 512
    seed: int = 42
    save_experiment_data: bool = False  # the scales and split indices, and checkpoints
    checkpoint_experiment_dir: Optional[str] = None  # resume from this experiment ...
    epoch_to_load: Optional[int] = None  # ... at this epoch (both or neither)
    epochs: int = 250
    eval_every: int = 1  # evaluate every N epochs (and the last); 0: never
    ws_threshold_model_save: float = 3  # checkpoint where ws_mean is below it
    checkpoint_keep_best: Optional[int] = None  # keep the k lowest-ws checkpoints; None: all
    async_checkpointing: bool = False  # write checkpoints in a background thread
    save_experiments_dir: Optional[str] = "experiments/"
    save_eval_plots: bool = False  # the eval figures (not ported: ROADMAP.md Queue 1 item 7)
    profile_epoch: Optional[int] = None  # epoch to trace with torch.profiler
    profile_dir: Optional[str] = None  # None: <experiment_dir>/traces
    ema_decay: float = 0.99
    precision: str = "f32"  # f32 | bf16
    remat: bool = False
    fast_generator: bool = False
    dispatch: str = "dense"  # dense | switch
    dispatch_tile: int = 128
    dispatch_remat: bool = True  # checkpoint each chunk's forward of the switch step
    stratified_batches: bool = False


@dataclass
class EvalConfig:
    chunk_size: int = 1024  # test showers generated per chunk
    bulk: bool = True  # JAX: one XLA program against per-chunk dispatch; one eager path here
    sample_routing: bool = False  # Gumbel-perturbed routing, as the reference
    fused_epilogue: bool = False  # kernel E for expm1 + channel sums


@dataclass
class ParallelConfig:
    n_devices: Optional[int] = None  # None: one card here (multi-GPU: ROADMAP.md Queue 1 item 8)
    expert_parallel: int = 1


@dataclass
class Config:
    config: RunConfig = field(default_factory=RunConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


# zdcsim/config/neutron.yaml as overrides (its data paths are not read here)
NEUTRON_OVERRIDES = (
    "model.architecture=neutron", "model.norm=group", "dataset.zdc_type=neutron",
    "dataset.input_image_shape=[44, 44]",
)


def _parse_value(raw: str) -> Any:
    """YAML-like scalar: null/None, true/false, int, float, ``[a, b]`` lists,
    else the string itself."""
    s = raw.strip()
    if s in ("null", "None", "~", ""):
        return None
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_parse_value(x) for x in inner.split(",")] if inner else []
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    return s


def apply_overrides(cfg: Config, overrides: Optional[Iterable[str]]) -> Config:
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"Override must look like key=value, got: '{item}'")
        key, _, raw = item.partition("=")
        parts = key.strip().split(".")
        node = cfg
        for part in parts[:-1]:
            if not dataclasses.is_dataclass(node) or not hasattr(node, part):
                raise KeyError(f"Config path not found: '{key}'")
            node = getattr(node, part)
        if not hasattr(node, parts[-1]) or dataclasses.is_dataclass(getattr(node, parts[-1])):
            raise KeyError(f"Config path not found: '{key}'")
        value = _parse_value(raw)
        if isinstance(value, list):
            value = tuple(value)
        setattr(node, parts[-1], value)
    return cfg


def load_config(overrides: Optional[List[str]] = None) -> Config:
    """Defaults, then ``a.b=c`` overrides (the neutron preset is
    ``[*NEUTRON_OVERRIDES, ...]``), then the checks of the JAX loader that
    concern the keys held here, the norm, and ``build_moe``'s generator rule."""
    from zdcsim_torch.models import generator_spec

    cfg = apply_overrides(Config(), overrides)
    if cfg.model.architecture not in ("proton", "neutron"):
        raise ValueError(f"model.architecture must be proton|neutron, got {cfg.model.architecture}")
    if int(cfg.model.n_experts) < 1:
        raise ValueError("model.n_experts must be >= 1")
    if len(tuple(cfg.dataset.input_image_shape)) != 2:
        raise ValueError("dataset.input_image_shape must be [H, W]")
    if cfg.model.norm not in ("batch", "group", "none"):
        raise ValueError(f"model.norm must be batch|group|none, got {cfg.model.norm}")
    if (cfg.train.checkpoint_experiment_dir is None) != (cfg.train.epoch_to_load is None):
        raise ValueError("train.checkpoint_experiment_dir and train.epoch_to_load must be set "
                         "together (resume) or both left null")
    m = cfg.model
    # raises on an (architecture, version) pair that has no generator
    generator_spec(m.architecture, m.generator.version, m.norm, m.generator.width)
    return cfg
