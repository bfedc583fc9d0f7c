"""The port's configuration: plain dataclasses.

The defaults are copied from every key of ``zdcsim/config/default.yaml``
(``tests/test_torch_config_yaml.py`` holds them equal to
``zdcsim.config.load_config()``, key for key). The router's hidden widths
are not a key of that file: they are fixed in ``zdcsim/models/router.py``
and copied here. A YAML config (``--config``, JAX's ``load_config(path)``)
merges over the defaults through :func:`read_yaml`, a reader of YAML 1.1
values on single lines (no PyYAML: the GPU machine has none); then ``a.b=c``
overrides, the dotlist syntax of ``zdcsim.config.apply_overrides``, each
value read by the same YAML rules with JAX's float fallback
(:func:`parse_override_value`); then the reference's router strengths
written as strings become floats (:func:`normalize_legacy_values`). A key
that the defaults lack is kept, as JAX keeps it: attribute access returns
it, a mapping under it is a ``SimpleNamespace``, and :func:`to_dict` lists
it (``dataclasses.asdict`` does not). A ``model.router.version`` other than
``router_v1`` or ``router_attention`` (JAX's registry) raises. The neutron
preset of ``zdcsim/config/neutron.yaml`` is also :data:`NEUTRON_OVERRIDES`,
which a caller puts before its own overrides.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import re
from dataclasses import dataclass, field
from types import SimpleNamespace
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


def _is_section(v: Any) -> bool:
    return dataclasses.is_dataclass(v) or isinstance(v, SimpleNamespace)


def _new_section(tree: Dict[str, Any]) -> SimpleNamespace:
    """A mapping under a key that the defaults lack, as a section of its own."""
    return SimpleNamespace(**{k: _new_section(v) if isinstance(v, dict) else v
                              for k, v in tree.items()})


def _typed(node: Any, name: str) -> bool:
    """Whether ``name`` is a field of the dataclass ``node`` (not an extra key)."""
    return dataclasses.is_dataclass(node) and name in {f.name for f in dataclasses.fields(node)}


def _child(node: Any, name: str, key: str) -> Any:
    """The section ``name`` of ``node``, made (or put in place of an extra
    key's value) where it is missing, as JAX's ``update_dotted`` does; a
    typed key that holds a value raises ``KeyError``."""
    child = getattr(node, name, None)
    if _is_section(child):
        return child
    if _typed(node, name):
        raise KeyError(f"Config path not found: '{key}' ({name!r} holds a value, not keys)")
    setattr(node, name, SimpleNamespace())
    return getattr(node, name)


def _set(cfg: Config, key: str, value: Any) -> None:
    """Set the dotted ``key``. A key that the defaults lack is made, with the
    sections on its path (JAX's ``ConfigNode.update_dotted``), and holds
    ``value`` as given (a mapping as a section). A typed key takes no
    mapping, and a section of the defaults takes no value: both raise
    ``KeyError``."""
    parts = key.strip().split(".")
    node = cfg
    for part in parts[:-1]:
        node = _child(node, part, key)
    leaf = parts[-1]
    if not _typed(node, leaf):
        setattr(node, leaf, _new_section(value) if isinstance(value, dict) else value)
    elif _is_section(getattr(node, leaf)) or isinstance(value, dict):
        raise KeyError(f"Config path not found: '{key}' (a section of the defaults and a value, "
                       "or a typed key and a mapping)")
    else:
        setattr(node, leaf, tuple(value) if isinstance(value, list) else value)


def parse_override_value(raw: str) -> Any:
    """An override's value as ``zdcsim.config._parse_override_value`` reads
    it: ``None`` for ``None``; else the YAML 1.1 value that :func:`read_yaml`
    reads (``off`` is ``False``, ``0x10`` 16, ``{a: 1}`` a mapping); text
    that is not YAML as it was given; and a string that Python reads as a
    float as that float (YAML 1.1 reads ``5e-5`` as a string). YAML that the
    port does not read (anchors, tags, block collections) raises
    ``ValueError``."""
    if raw == "None":
        return None

    def where(msg):
        return ValueError(f"override value {raw!r}: {msg} (the port reads YAML 1.1 scalars, "
                          "quoted strings and flow collections; quote the value)")

    try:
        val = _yaml_value(raw, where)
    except _NotYaml:
        return raw
    if isinstance(val, str):
        try:
            return float(val)
        except ValueError:
            return val
    return val


def apply_overrides(cfg: Config, overrides: Optional[Iterable[str]]) -> Config:
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"Override must look like key=value, got: '{item}'")
        key, _, raw = item.partition("=")
        _set(cfg, key.strip(), parse_override_value(raw.strip()))
    return cfg


def apply_tree(cfg: Config, tree: Dict[str, Any], prefix: str = "") -> Config:
    """Merge a nested mapping (a YAML config) over ``cfg``, key by key, as
    JAX's ``ConfigNode.merge``: a mapping merges into the section of its key
    (made where missing), anything else replaces the key's value."""
    for k, v in tree.items():
        if isinstance(v, dict):
            node = cfg
            for part in f"{prefix}{k}".split("."):
                node = _child(node, part, f"{prefix}{k}")
            apply_tree(cfg, v, f"{prefix}{k}.")
        else:
            _set(cfg, f"{prefix}{k}", v)
    return cfg


_LEGACY_STRENGTHS = ("ed_strength", "gan_strength", "diff_strength", "util_strength",
                     "alb_strength")


def normalize_legacy_values(cfg: Config) -> Config:
    """The reference config's strengths written as strings, as floats
    (``zdcsim.config.normalize_legacy_values``): its ``diff_strength: 1-6``
    is ``1e-6``, a string such as ``1e-5`` its float; another string raises
    ``ValueError``."""
    router = cfg.model.router
    for key in _LEGACY_STRENGTHS:
        val = getattr(router, key)
        if isinstance(val, str):
            fixed = val.replace("-", "e-") if "e" not in val.lower() else val
            try:
                setattr(router, key, float(fixed))
            except ValueError:
                raise ValueError(f"Cannot interpret router.{key}={val!r} as a float") from None
    return cfg


def to_dict(cfg: Any) -> Dict[str, Any]:
    """The config as nested dicts, the keys that the defaults lack included
    (``dataclasses.asdict`` drops them): JAX's ``ConfigNode.to_dict``."""
    return {k: to_dict(v) if _is_section(v) else copy.deepcopy(v) for k, v in vars(cfg).items()}


# -- YAML 1.1 values ----------------------------------------------------------

# PyYAML's YAML 1.1 resolvers (yaml/resolver.py), tried in its order
_YAML_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On",
                                   "ON")},
              **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                    "OFF")}}
_YAML_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                            |\.[0-9_]+(?:[eE][-+][0-9]+)?
                            |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                            |[-+]?\.(?:inf|Inf|INF)
                            |\.(?:nan|NaN|NAN))$""", re.X)
_YAML_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                          |[-+]?0[0-7_]+
                          |[-+]?(?:0|[1-9][0-9_]*)
                          |[-+]?0x[0-9a-fA-F_]+
                          |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_YAML_NULL = {"", "~", "null", "Null", "NULL"}
_YAML_TIMESTAMP = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_YAML_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")


class _NotYaml(ValueError):
    """Text that PyYAML itself refuses (an override keeps it as given)."""


def _sexagesimal(value: str, part) -> Any:
    total = part(0)
    for digits in value.split(":"):
        total = total * 60 + part(digits)
    return total


def _yaml_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == "0":
        return 0
    if value.startswith(("0b", "0x")):
        return sign * int(value[2:], 2 if value[1] == "b" else 16)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * (_sexagesimal(value, int) if ":" in value else int(value))


def _yaml_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * (_sexagesimal(value, float) if ":" in value else float(value))


def _yaml_timestamp(m: re.Match, where) -> Any:
    """PyYAML's ``construct_yaml_timestamp``: a date, or a datetime (aware
    where it names a zone)."""
    try:
        if m["hour"] is None:
            return datetime.date(int(m["year"]), int(m["month"]), int(m["day"]))
        fraction = int((m["fraction"] or "")[:6].ljust(6, "0"))
        tz = None
        if m["tz_sign"]:
            delta = datetime.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
            tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
        elif m["tz"]:
            tz = datetime.timezone.utc
        return datetime.datetime(int(m["year"]), int(m["month"]), int(m["day"]), int(m["hour"]),
                                 int(m["minute"]), int(m["second"]), fraction, tzinfo=tz)
    except ValueError as e:  # safe_load raises it too: not a YAMLError
        raise where(f"{m.string!r}: {e}") from None


def _yaml_plain(s: str, where) -> Any:
    """A plain scalar resolved as PyYAML resolves it."""
    if s in _YAML_BOOL:
        return _YAML_BOOL[s]
    if _YAML_FLOAT.match(s):
        return _yaml_float(s)
    if _YAML_INT.match(s):
        return _yaml_int(s)
    if s == "<<":  # YAML's merge key
        raise where("merge keys")
    if s == "=":  # YAML's value key: safe_load constructs none
        raise _NotYaml(str(where(f"{s!r} is a YAML key of its own")))
    if s in _YAML_NULL:
        return None
    m = _YAML_TIMESTAMP.match(s)
    if m and (m["hour"] is not None or _YAML_DATE.match(s)):
        return _yaml_timestamp(m, where)
    return s


class _ValueReader:
    """One value on one line as PyYAML reads it: a plain or quoted scalar,
    or a flow list or mapping of them (nested), then a ``#`` comment. YAML
    that PyYAML refuses raises :class:`_NotYaml`; YAML that this reader does
    not read (anchors, tags, block collections and scalars, escapes other
    than ``\\"`` and ``\\\\``) raises ``where``'s ``ValueError``."""

    def __init__(self, text: str, where):
        self.s, self.i, self.where = text, 0, where

    def not_yaml(self, msg: str):
        raise _NotYaml(str(self.where(msg)))

    def unread(self, msg: str):
        raise self.where(msg)

    def peek(self, k: int = 0) -> str:
        return self.s[self.i + k] if self.i + k < len(self.s) else ""

    def skip(self) -> None:
        while self.peek() == " ":
            self.i += 1

    def value(self) -> Any:
        if "\n" in self.s or "\r" in self.s:
            self.unread("a value of more than one line")
        if "\t" in self.s:
            self.not_yaml("a tab")
        self.skip()
        if self.peek() in ("", "#"):  # nothing, or a comment alone
            return None
        v = self.node(flow=False)
        self.skip()  # a plain scalar stops at " #", a quote or a bracket before any "#"
        if self.peek() == ":":
            self.unread(f"a block mapping in {self.s!r}")
        if self.peek() and self.peek() != "#":
            self.not_yaml(f"{self.s[self.i:]!r} after the value")
        return v

    def node(self, flow: bool) -> Any:
        ch = self.peek()
        if ch == "[":
            return self.collection("]", flow)
        if ch == "{":
            return self.collection("}", flow)
        if ch in "'\"":
            return self.quoted()
        return self.plain(flow)

    def collection(self, close: str, flow: bool) -> Any:
        mapping = close == "}"
        out: Any = {} if mapping else []
        self.i += 1
        while True:
            self.skip()
            ch = self.peek()
            if not ch:
                self.not_yaml(f"unclosed flow collection {self.s!r}")
            if ch == close:
                self.i += 1
                return out
            if ch in ",]}#" or ch == ":" and not mapping:
                self.not_yaml(f"{ch!r} where an entry starts in {self.s!r}")
            if ch in "?:":
                self.unread("explicit and empty keys")
            item = self.node(flow=True)
            self.skip()
            if mapping:
                if isinstance(item, (list, dict)):
                    self.unread("a flow collection as a key")
                if item in out:
                    self.unread(f"duplicate key {item!r}")
                out[item] = None
                if self.peek() == ":":
                    self.i += 1
                    self.skip()
                    if self.peek() not in (",", "}"):
                        out[item] = self.node(flow=True)
                        self.skip()
            else:
                if self.peek() == ":":
                    self.unread("a mapping inside a flow list")
                out.append(item)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() == "?":
                self.unread("explicit keys")
            elif self.peek() != close:
                self.not_yaml(f"{self.s[self.i:]!r} in the flow collection {self.s!r}")

    def quoted(self) -> str:
        q, start = self.peek(), self.i
        self.i += 1
        body = []
        while True:
            ch = self.peek()
            if not ch:
                self.not_yaml(f"unclosed quoted string {self.s[start:]!r}")
            self.i += 1
            if ch == q:
                if q == "'" and self.peek() == "'":
                    body.append("'")
                    self.i += 1
                    continue
                return "".join(body)
            if q == '"' and ch == "\\":
                if self.peek() not in ('"', "\\"):
                    self.unread(f"escape sequences other than \\\" and \\\\ in "
                                f"{self.s[start:]!r}")
                ch = self.peek()
                self.i += 1
            body.append(ch)

    def plain(self, flow: bool) -> Any:
        ch, nxt = self.peek(), self.peek(1)
        if ch in "&!|>" or flow and ch == "?":
            self.unread(f"anchors, tags, block scalars and explicit keys in {self.s!r}")
        if flow and ch == "-" and nxt in ("", " "):
            self.not_yaml(f"a block list inside a flow collection in {self.s!r}")
        if ch in "-?:" and nxt in ("", " ") or self.i == 0 and self.s.startswith("---"):
            self.unread(f"block collections and documents in {self.s!r}")
        if ch and ch in "@`%*,]}" or self.i == 0 and self.s.startswith("..."):
            self.not_yaml(f"{ch!r} cannot start a value in {self.s!r}")
        start = self.i
        while self.peek():
            ch, nxt = self.peek(), self.peek(1)
            if ch == " ":
                self.skip()
                if self.peek() in ("", "#"):
                    break
                continue
            if ch == ":" and (nxt in ("", " ") or flow and nxt in ",[]{}"):
                if not flow:
                    self.unread(f"a block mapping in {self.s!r}")
                break
            if flow and ch in ",[]{}?":
                break
            self.i += 1
        return _yaml_plain(self.s[start:self.i].rstrip(" "), self.where)


def _yaml_value(text: str, where) -> Any:
    return _ValueReader(text, where).value()


# -- the YAML subset of the configs ------------------------------------------


def _yaml_error(path: str, lineno: int, msg: str) -> ValueError:
    return ValueError(f"{path}:{lineno}: {msg} (the port reads nested maps of scalars, "
                      "quoted strings and flow collections)")


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " [{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(path: str) -> Dict[str, Any]:
    """The nested mapping of the YAML file ``path``, as ``yaml.safe_load``
    reads it, for the subset that the configs use: block mappings indented
    by spaces whose values are plain and quoted scalars (YAML 1.1's null,
    bool, int, float and timestamp forms) or flow lists and mappings of them
    on one line (:class:`_ValueReader`), and ``#`` comments. Anything else
    (block lists, anchors, tags, multi-line values, tabs, a document marker)
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
            key = _yaml_value(m.group(1), where) if m.group(1)[0] in "\"'" else m.group(1)
            if key in node:
                raise where(f"duplicate key {key!r}")
            if m.group(2) is None or not m.group(2).strip():
                node[key] = {}
                empty.append((node, key))
                stack.append([None, node[key]])
                opened = True
            else:
                node[key] = _yaml_value(m.group(2), where)
    for node, key in empty:
        if node[key] == {}:
            node[key] = None
    return root


def load_config(overrides: Optional[List[str]] = None,
                config_path: Optional[str] = None) -> Config:
    """Defaults, then the YAML file ``config_path`` merged over them
    (:func:`read_yaml`), then ``a.b=c`` overrides (the neutron preset is
    also ``[*NEUTRON_OVERRIDES, ...]``), then the router strengths written
    as strings made floats (:func:`normalize_legacy_values`), then the checks of the JAX loader
    that concern the keys held here, the norm, the router's version and
    ``build_moe``'s generator rule."""
    from zdcsim_torch.models import generator_spec

    cfg = Config()
    if config_path is not None:
        apply_tree(cfg, read_yaml(config_path) or {})
    cfg = normalize_legacy_values(apply_overrides(cfg, overrides))
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
