"""The port runs where JAX, Flax, PyYAML, pandas, scikit-learn and
matplotlib are absent (the GPU machine has none of them).

A subprocess installs an import hook that refuses those packages, optax and
the JAX package ``zdcsim`` (not ``zdcsim_torch``), then imports every module
of ``zdcsim_torch``, ``fidelity_torch.py``, ``bench_torch.py`` and
``distill_torch.py`` and rehearses ``chip_smoke.py`` on
the CPU: the kernel checks of A-D (B and D at the teacher's widths and at a
narrow one), ``_conv_i8``, G and H and of G's and H's three int8 convs, the
serves of ``int8``, ``int8_pallas_ab``,
``int8_pallas``, ``int8_fused_front`` and ``int8_fused``, the gate's split
with kernel E, the all-expert path with kernel F, the ``f32`` and ``bf16``
serves, the student's fidelity gate on part of the split, and the engine
API of phase 15 (``dyn_dispatch``, the dense path, static activation quant,
grouped and stream dispatch, ``bench_torch.py``'s first rung), and the
neutron family of phase 16 (the teacher's module and both students through
the dyn tile loop, a folded ``norm="batch"`` tree, kernel E at 44x44, a
student's gate), the proton family's dense train step of phase 17 (two
steps at width 0.125, E=2, batch 4, with their checks, and the first step
held against itself by the card-against-CPU comparison, the first step run
twice and held equal), the training loop of phase 18 (2 epochs with evals,
keep_best, the restore, a resume, serves from the checkpoint and the CLI's
``--eval``), the train step's options of phase 19 (one switch step,
held against itself by its comparisons), and phase 21 (the attention
router's serve, a neutron student distilled and its artifact's round
trip, phase 18's run directory gated), and phase 23 (the sharded serve on
a gloo world of one) and phase 24 (the dense and switch train steps on that
world's mesh against the meshless ones, ``train()`` on it, its checkpoint
restored and served with no mesh) and phase 25 (every ``MODEL_REGISTRY``
name built by ``build_model``, the student's router and ``Generator`` from it
against the engine's float path, ``ExpertDense`` against a per-expert
matmul). The rehearsal runs in three parts, each
in a subprocess of its own under the guard and ``timeout 120``.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yaml", "pandas", "sklearn", "matplotlib",
             "zdcsim")

_GUARD = f"""
import importlib.abc, sys
FORBIDDEN = {FORBIDDEN!r}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"import of {{name!r}} refused: not on the GPU machine")
        return None
loaded = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not loaded, loaded
sys.meta_path.insert(0, Refuse())
"""


def _run(code, timeout):
    return subprocess.run(
        [sys.executable, "-c", _GUARD + code], cwd=REPO, capture_output=True, text=True,
        timeout=timeout,
    )


def test_every_port_module_imports_without_forbidden_packages():
    code = """
import importlib, pkgutil
import zdcsim_torch
names = [m.name for m in pkgutil.walk_packages(zdcsim_torch.__path__, "zdcsim_torch.")]
assert "zdcsim_torch.ops.fused_decode_kernels" in names, names
for n in names:
    importlib.import_module(n)
import fidelity_torch
import bench_torch
import distill_torch
assert "zdcsim_torch.inference.distill" in names, names
bad = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
assert not bad, bad
print(len(names), "modules")
"""
    proc = _run(code, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 14


# the phase lines each part of the rehearsal must print
PART_LINES = {
    "serve": ("[4 kernel B]", "narrow [4, 5, 3, 36]", "[5 kernel C]", "[6 kernel D]",
              "narrow [4, 35, 30, 32]", "row phases: real groups [3, 3, 3, 3, 3, 3, 3, 2]",
              "up2_conv4_int8 on conv_mma", "[7 conv_i8]", "[7b kernels G, H] t",
              "[7b conv stages] t", "conv0 Conv_0 (4 parity phases)", "conv1 Conv_1",
              "conv2 Conv_2",
              "int8_pallas_ab main path", "int8_pallas main path",
              "int8_fused_front main path", "int8_fused main path",
              "[10 kernel E]", "[11 kernel F]",
              "[12 float serves] t", "f32:", "bf16:", "[13 gate]",
              '"metric": "fastsim_fidelity"', "int8_pallas dyn_dispatch",
              "int8_fused dense simulate",
              "static_act_quant on int8", "simulate_stream vs simulate_grouped",
              "bench_torch first rung", " 15 engine API ",
              "[16 neutron]", "teacher bf16 (the module", "student_w0.25 int8 vs the f32 serve",
              "random norm=batch tree, full width int8 (fast_neutron_apply, folded at build",
              "kernel E [8, 44, 44] float32", "gate of the neutron student_w0.125 int8",
              '"family": "neutron"', " 16 neutron "),
    "train": ("[17 train]", "step 2 (epoch 1)", "kernel launches none of A-H",
              "against the CPU (no card: the first step against itself)", '{"train": ',
              " 17 train ",
              "[18 loop]", "epoch 1 eval:", "torch.equal to the evaluated state True",
              "resumed from epoch", "int8_pallas from the checkpoint vs its int8 serve",
              "--eval --checkpoint-epoch", '{"loop": ', " 18 loop ",
              "run twice from one state: torch.equal leaf by leaf True",
              "[19 options]", "switch f32 against itself (no card)",
              "one switch step at width 0.125", '{"options": ',
              " 19 options ",
              "[21 distill]", "int8 serve behind a seeded AttentionRouterNetwork",
              "neutron distillation into a w=0.125 student", "torch.equal True",
              "the neutron student read back vs the in-memory student: routing identical True",
              "run_gate(", '{"distill": ', " 21 distill "),
    "mesh": ("[23 mesh]", "Mesh(data=1, expert=1, rank=0, device=cpu) on gloo",
             "torch.equal to the meshless engine True",
             "torch.equal to the meshless engine and to the switch serve True",
             "int8 with INT8_CONV0_IMPL=naive vs the default forms",
             "int8 with DEQUANT_DTYPE=bfloat16 vs the default forms",
             "host C++ group_pixel_std on 512 images", '{"mesh": ', " 23 mesh ",
             "[24 mesh train]", "dense f32 step of the proton MoE width 0.125",
             "switch bf16 step of the proton MoE width 0.125",
             "torch.equal to the meshless step leaf by leaf True",
             "the switch bf16 step on the mesh run twice from one state: torch.equal leaf by "
             "leaf True", "train() on the mesh: 1 epoch",
             "the checkpoint of the gathered state restored with no mesh: torch.equal to the "
             "state the run returned True",
             "FastSim.from_checkpoint of the mesh run on int8_pallas with no mesh",
             '{"mesh_train": ', " 24 mesh train ",
             "[25 api]", "build_model of the 9 registry names on cpu",
             "routing torch.equal to the engine's True",
             "experts' showers torch.equal to the engine's float Generator path True",
             "ExpertDense [3, 512, 256] x [3, 256, 128] on cpu",
             "kernel launches none of A-H", '{"api": ', " 25 api "),
}


@pytest.mark.parametrize("part", list(PART_LINES))
def test_chip_smoke_rehearses_on_cpu_without_forbidden_packages(part):
    """One part of ``chip_smoke.py``'s CPU rehearsal (``--rehearse-part``:
    serve = phases 3-16, train = 17-22, mesh = 23-25: the training on the
    mesh of a gloo world of one, then the public API) in a subprocess of its own under the
    guard, each part recomputing from the seed what it needs of another."""
    code = f"""
import runpy
sys.argv = ["chip_smoke.py", "--rehearse-part", {part!r}]
runpy.run_path("chip_smoke.py", run_name="__main__")
"""
    # two threads: the suite runs this beside other test workers
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        ["timeout", "120", sys.executable, "-c", _GUARD + code], cwd=REPO,
        capture_output=True, text=True, timeout=150, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == '{"rehearsal": true}'
    for phase in PART_LINES[part]:
        assert phase in proc.stdout, phase
