"""Checkpoints of the train state (counterpart of
``zdcsim/train/checkpoint.py``).

A checkpoint is the whole :class:`MoETrainState` (parameters, EMA,
optimizer moments and counts, spectral-norm stats, step), written by
``torch.save`` from a host copy as one flat dict of tensors keyed by the
state's paths, in ``<dir_models>/state_epoch_<n>/state.pt`` (JAX's
directory names). A flat dict of tensors loads with
``torch.load(weights_only=True)``. :func:`restore_checkpoint` puts it
back into the structure of a template state, on the template's device,
refusing a missing or extra leaf or another shape or dtype.

A run on a ``(data, expert)`` mesh writes the same format: every rank
gathers its expert-sharded state (``parallel.gather_state``) and rank 0
writes it (``train.loop``), so one process restores and serves it; a
resume onto a mesh restores the whole state on every rank, then shards it.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from zdcsim_torch.train.state import MoETrainState

CKPT_PREFIX = "state_epoch_"
STATE_FILE = "state.pt"


def checkpoint_dir(dir_models: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(dir_models), f"{CKPT_PREFIX}{epoch}")


def _flatten(x: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The state's tensors keyed by ``/``-joined field and tree names."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    items = (x.items() if isinstance(x, dict)
             else ((f.name, getattr(x, f.name)) for f in dataclasses.fields(x)))
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(template: Any, flat: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``template``'s structure with each tensor taken from ``flat``."""
    if isinstance(template, torch.Tensor):
        t = flat[prefix]
        if t.shape != template.shape or t.dtype != template.dtype:
            raise ValueError(f"checkpoint leaf {prefix!r} is {tuple(t.shape)} {t.dtype}, the "
                             f"template's {tuple(template.shape)} {template.dtype}")
        return t.to(template.device)
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    return dataclasses.replace(template, **{
        f.name: _rebuild(getattr(template, f.name), flat,
                         f"{prefix}/{f.name}" if prefix else f.name)
        for f in dataclasses.fields(template)})


def host_copy(state: MoETrainState) -> Dict[str, torch.Tensor]:
    """The state's tensors copied to host memory (a copy on the CPU too),
    flat; the caller may then drop or overwrite the state."""
    return {k: v.detach().to("cpu", copy=True) for k, v in _flatten(state).items()}


def _write(path: str, flat: Dict[str, torch.Tensor]) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(flat, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # a reader never sees half a file
    return path


def save_checkpoint(dir_models: str, epoch: int, state: MoETrainState) -> str:
    return _write(checkpoint_dir(dir_models, epoch), host_copy(state))


class AsyncSaver:
    """Saves whose disk write runs in a background thread: ``save`` returns
    once the host copy is made, so the loop may go on with the state; one
    write is in flight at a time (``save`` waits for the last one first)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, dir_models: str, epoch: int, state: MoETrainState) -> str:
        path = checkpoint_dir(dir_models, epoch)
        self.wait()
        flat = host_copy(state)

        def run():
            try:
                _write(path, flat)
            except Exception as e:  # noqa: BLE001 — raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"checkpoint-{epoch}", daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def delete_checkpoint(dir_models: str, epoch: int) -> None:
    path = checkpoint_dir(dir_models, epoch)
    if os.path.isdir(path):
        shutil.rmtree(path)


def checkpoint_file(dir_models: str, epoch: int) -> str:
    """The state file of ``epoch``'s checkpoint. Raises ``FileNotFoundError``
    without one, naming the JAX package's Orbax format where the directory
    holds that instead: the port reads only its own checkpoints."""
    ckpt = checkpoint_dir(dir_models, epoch)
    path = os.path.join(ckpt, STATE_FILE)
    if os.path.isdir(ckpt) and not os.path.exists(path):
        raise FileNotFoundError(
            f"{ckpt} holds no {STATE_FILE}: a checkpoint in another format (the JAX package "
            "writes Orbax checkpoints, which the port does not read); the port reads only the "
            "checkpoints of zdcsim_torch.train.checkpoint")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint of epoch {epoch} under {dir_models} ({path})")
    return path


def restore_checkpoint(dir_models: str, epoch: int, template: MoETrainState) -> MoETrainState:
    """The checkpoint of ``epoch`` in ``template``'s structure, shapes and
    dtypes (``count`` and ``step`` int32), on its device."""
    path = checkpoint_file(dir_models, epoch)
    # mapped, not read: a leaf's bytes are read where it is moved or first
    # touched (private pages: writing to a restored CPU leaf never reaches the file)
    flat = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    want = _flatten(template)
    if set(flat) != set(want):
        raise ValueError(f"checkpoint {path} does not fit the template: missing "
                         f"{sorted(set(want) - set(flat))}, extra {sorted(set(flat) - set(want))}")
    return _rebuild(template, flat)


def latest_epoch(dir_models: str) -> Optional[int]:
    if not os.path.isdir(dir_models):
        return None
    epochs = [
        int(d[len(CKPT_PREFIX):])
        for d in os.listdir(dir_models)
        if d.startswith(CKPT_PREFIX) and d[len(CKPT_PREFIX):].isdigit()
    ]
    return max(epochs) if epochs else None
