"""``zdcsim_torch.inference.engine.FastSim`` and device selection on a
narrow random generator (width 1/16), on the CPU."""

import numpy as np
import pytest
import torch

from zdcsim_torch.convert import from_state_dict
from zdcsim_torch.device import default_device
from zdcsim_torch.inference.engine import FastSim
from zdcsim_torch.models.proton import Generator
from zdcsim_torch.models.router import RouterNetwork
from zdcsim_torch.utils.artifact import _flatten, _unflatten


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module: the suite runs six workers
    beside gloo worlds and the rehearsal's subprocesses, and a worker on
    every core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    trees = [_flatten(from_state_dict(Generator(width=1 / 16).state_dict())) for _ in range(3)]
    gen = _unflatten({k: np.stack([t[k] for t in trees]) for k in trees[0]})
    return gen, from_state_dict(RouterNetwork(3).state_dict())


def test_default_device_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")


def test_fastsim_rejects_unported_precision(weights):
    # a name neither package has: every JAX precision is ported now
    with pytest.raises(ValueError, match="precision"):
        FastSim(*weights, precision="int4", device="cpu")


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8", "int8_pallas_ab", "int8_pallas"])
def test_fastsim_chunks_pad_and_reproduce(weights, precision):
    eng = FastSim(*weights, batch_size=8, precision=precision, device="cpu")
    eng._build_switch(tile=4)
    assert eng.act_scale_headroom is None
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((13, 9), dtype=np.float32)  # 2 chunks, the last padded
    noise = rng.standard_normal((13, 10), dtype=np.float32)
    imgs, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
    assert imgs.shape == (13, 56, 30) and imgs.dtype == torch.float32 and ids.shape == (13,)
    assert torch.isfinite(imgs).all() and imgs.min() >= 0
    _, logits = eng.router(torch.from_numpy(cond))
    assert torch.equal(ids, logits.argmax(-1))
    bulk = eng.simulate_bulk(cond, noise=noise)
    assert torch.equal(bulk, imgs)
    # noise drawn from a seeded generator reproduces
    a = eng.simulate_switch(cond, generator=torch.Generator().manual_seed(3))
    b = eng.simulate_switch(cond, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_fastsim_checks_noise_and_expert_count(weights):
    eng = FastSim(*weights, batch_size=4, precision="int8", device="cpu")
    with pytest.raises(ValueError, match="noise"):
        eng.simulate_switch(np.zeros((4, 9), np.float32), noise=np.zeros((4, 7), np.float32))
    from zdcsim_torch.config import load_config

    with pytest.raises(ValueError, match="experts"):
        FastSim(*weights, precision="int8", device="cpu", cfg=load_config(["model.n_experts=2"]))
