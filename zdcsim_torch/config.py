"""The port's configuration: plain dataclasses.

The defaults are copied from every key of ``zdcsim/config/default.yaml``
(``tests/test_torch_config_yaml.py`` holds them equal to
``zdcsim.config.load_config()``, key for key). The router's hidden widths
are not a key of that file: they are fixed in ``zdcsim/models/router.py``
and copied here. A YAML config (``--config``, JAX's ``load_config(path)``)
merges over the defaults through :func:`read_yaml`, a reader of the subset
of YAML that the configs use (no PyYAML: the GPU machine has none); then
``a.b=c`` overrides, the dotlist syntax of ``zdcsim.config.apply_overrides``
with a small scalar parser. A key that does not exist raises, and so does a
``model.router.version`` other than ``router_v1`` or ``router_attention``
(JAX's registry). The neutron preset of
``zdcsim/config/neutron.yaml`` is also :data:`NEUTRON_OVERRIDES`, which a
caller puts before its own overrides.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple


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
    version: str = "router_v1"  # or router_attention
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
    # the reference's pickles (read with synthetic=false, zdcsim_torch/data/pickles.py)
    DATA_IMAGES_PATH: str = "data/data_proton_photonsum_proton_1_2312.pkl"
    DATA_COND_PATH: str = "data/data_cond_photonsum_proton_1_2312.pkl"
    DATA_POSITIONS_PATH: str = "data/data_coord_photonsum_proton_1_2312.pkl"
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
    plot_images: bool = False  # the eval figures, logged to wandb (needs matplotlib)
    run_name: Optional[str] = None  # stamped with the experiment directory
    api_key: str = ""


@dataclass
class TrainConfig:
    batch_size: int = 512
    batch_size_aggregate: Optional[int] = None  # JAX keeps it for the config surface; unread
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
    save_eval_plots: bool = False  # the eval figures under <experiment_dir>/plots (matplotlib)
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
    data_axis: str = "data"  # the mesh's data axis
    # None: the initialized torch.distributed world's size, else one card; > 1
    # trains on a (data, expert) mesh of that many ranks, started by torchrun
    n_devices: Optional[int] = None
    expert_parallel: int = 1  # ranks along the mesh's expert axis; divides n_experts


@dataclass
class Config:
    config: RunConfig = field(default_factory=RunConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    limit_samples: Optional[int] = None  # a key the reference reads and never declares


# zdcsim/config/neutron.yaml as overrides (its data paths are read only from the file)
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


def _set(cfg: Config, key: str, value: Any) -> None:
    """Set the dotted ``key``; a path that does not exist, or that names a
    section, raises ``KeyError``."""
    parts = key.strip().split(".")
    node = cfg
    for part in parts[:-1]:
        if not dataclasses.is_dataclass(node) or not hasattr(node, part):
            raise KeyError(f"Config path not found: '{key}'")
        node = getattr(node, part)
    if (not dataclasses.is_dataclass(node) or not hasattr(node, parts[-1])
            or dataclasses.is_dataclass(getattr(node, parts[-1]))):
        raise KeyError(f"Config path not found: '{key}'")
    setattr(node, parts[-1], tuple(value) if isinstance(value, list) else value)


def apply_overrides(cfg: Config, overrides: Optional[Iterable[str]]) -> Config:
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"Override must look like key=value, got: '{item}'")
        key, _, raw = item.partition("=")
        _set(cfg, key, _parse_value(raw))
    return cfg


def apply_tree(cfg: Config, tree: Dict[str, Any], prefix: str = "") -> Config:
    """Merge a nested mapping (a YAML config) over ``cfg``, key by key."""
    for k, v in tree.items():
        if isinstance(v, dict):
            apply_tree(cfg, v, f"{prefix}{k}.")
        else:
            _set(cfg, f"{prefix}{k}", v)
    return cfg


# -- the YAML subset of the configs ------------------------------------------

# PyYAML's YAML 1.1 resolvers (yaml/resolver.py), for the forms a config holds
_YAML_NULL = {"", "~", "null", "Null", "NULL"}
_YAML_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On",
                                   "ON")},
              **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                    "OFF")}}
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_YAML_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                       "+.inf": float("inf"), "-.inf": float("-inf"), "-.Inf": float("-inf"),
                       "-.INF": float("-inf"), ".nan": float("nan"), ".NaN": float("nan"),
                       ".NAN": float("nan")}


def _yaml_error(path: str, lineno: int, msg: str) -> ValueError:
    return ValueError(f"{path}:{lineno}: {msg} (the port reads nested maps of scalars, "
                      "quoted strings and flow lists)")


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(inner: str, where) -> List[str]:
    """The items of a flow list's inside, split at top-level commas."""
    items, quote, start = [], None, 0
    for i, ch in enumerate(inner):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[]{}":
            raise where("nested flow collections")
        elif ch == ",":
            items.append(inner[start:i])
            start = i + 1
    items.append(inner[start:])
    if items and not items[-1].strip():  # a trailing comma
        items.pop()
    return items


def _yaml_scalar(text: str, where) -> Any:
    """One plain, quoted or flow-list value, resolved as PyYAML resolves it."""
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise where(f"unclosed flow list {s!r}")
        return [_yaml_scalar(x, where) for x in _split_flow(s[1:-1], where)]
    if s and s[0] in "\"'":
        if len(s) < 2 or s[-1] != s[0]:
            raise where(f"unclosed quoted string {s!r}")
        body = s[1:-1]
        if s[0] == "'":
            return body.replace("''", "'")

        def unescape(m):
            if m.group(1) not in "\"\\":
                raise where(f"escape sequences other than \\\" and \\\\ in {s!r}")
            return m.group(1)

        return re.sub(r"\\(.)", unescape, body)
    if s and (s[0] in "{&*!|>%@`" or s.startswith("- ")):
        raise where(f"unsupported YAML {s!r}")
    if s in _YAML_NULL:
        return None
    if s in _YAML_BOOL:
        return _YAML_BOOL[s]
    if _YAML_INT.match(s):
        return int(s.replace("_", ""))
    if _YAML_FLOAT.match(s):
        return float(s.replace("_", ""))
    if s in _YAML_SPECIAL_FLOAT:
        return _YAML_SPECIAL_FLOAT[s]
    return s


def read_yaml(path: str) -> Dict[str, Any]:
    """The nested mapping of the YAML file ``path``, as ``yaml.safe_load``
    reads it, for the subset that the configs use: block mappings indented
    by spaces, plain and quoted scalars (YAML 1.1's null, bool, int and
    float forms), flow lists of scalars and ``#`` comments. Anything else
    (block lists, anchors, multi-line scalars, tabs, a document marker)
    raises ``ValueError`` naming the line."""
    root: Dict[str, Any] = {}
    # open mappings: (indent of their keys, None until the first key), the mapping
    stack: List[List[Any]] = [[0, root]]
    empty: List[Tuple[Dict[str, Any], str]] = []  # keys with no value of their own
    opened = False  # the previous key opened a nested mapping
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            where = lambda msg, n=lineno: _yaml_error(path, n, msg)  # noqa: E731
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip():
                continue
            body = line.lstrip(" ")
            indent = len(line) - len(body)
            if body[0] == "\t" or line.startswith(("---", "...")) and indent == 0:
                raise where("tabs or document markers")
            if opened:
                if indent <= stack[-2][0]:  # the key opened nothing: YAML's null
                    stack.pop()
                else:
                    stack[-1][0] = indent
                opened = False
            while indent < stack[-1][0]:
                stack.pop()
            if indent != stack[-1][0]:
                raise where(f"indentation {indent} matches no open mapping")
            node = stack[-1][1]
            m = re.match(r"^(\"[^\"]*\"|'[^']*'|[^\"'#:\s][^:]*?)\s*:(?:\s+(.*))?$", body)
            if not m:
                raise where(f"not a 'key: value' line: {body!r}")
            key = _yaml_scalar(m.group(1), where) if m.group(1)[0] in "\"'" else m.group(1)
            if key in node:
                raise where(f"duplicate key {key!r}")
            if m.group(2) is None or not m.group(2).strip():
                node[key] = {}
                empty.append((node, key))
                stack.append([None, node[key]])
                opened = True
            else:
                node[key] = _yaml_scalar(m.group(2), where)
    for node, key in empty:
        if node[key] == {}:
            node[key] = None
    return root


def load_config(overrides: Optional[List[str]] = None,
                config_path: Optional[str] = None) -> Config:
    """Defaults, then the YAML file ``config_path`` merged over them
    (:func:`read_yaml`), then ``a.b=c`` overrides (the neutron preset is
    also ``[*NEUTRON_OVERRIDES, ...]``), then the checks of the JAX loader
    that concern the keys held here, the norm, the router's version and
    ``build_moe``'s generator rule."""
    from zdcsim_torch.models import generator_spec

    cfg = Config()
    if config_path is not None:
        apply_tree(cfg, read_yaml(config_path) or {})
    cfg = apply_overrides(cfg, overrides)
    if cfg.model.architecture not in ("proton", "neutron"):
        raise ValueError(f"model.architecture must be proton|neutron, got {cfg.model.architecture}")
    if cfg.dataset.zdc_type not in ("proton", "neutron"):
        raise ValueError(f"dataset.zdc_type must be proton|neutron, got {cfg.dataset.zdc_type}")
    if int(cfg.model.n_experts) < 1:
        raise ValueError("model.n_experts must be >= 1")
    if len(tuple(cfg.dataset.input_image_shape)) != 2:
        raise ValueError("dataset.input_image_shape must be [H, W]")
    if cfg.model.norm not in ("batch", "group", "none"):
        raise ValueError(f"model.norm must be batch|group|none, got {cfg.model.norm}")
    if cfg.model.router.version not in ("router_v1", "router_attention"):
        raise ValueError(f"model.router.version must be router_v1|router_attention, got "
                         f"{cfg.model.router.version!r}")
    if (cfg.train.checkpoint_experiment_dir is None) != (cfg.train.epoch_to_load is None):
        raise ValueError("train.checkpoint_experiment_dir and train.epoch_to_load must be set "
                         "together (resume) or both left null")
    m = cfg.model
    # raises on an (architecture, version) pair that has no generator
    generator_spec(m.architecture, m.generator.version, m.norm, m.generator.width)
    return cfg
