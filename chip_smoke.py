#!/usr/bin/env python3
"""Smoke run of the zdcsim_torch port on one CUDA card.

    python3 chip_smoke.py                 # on a machine with an NVIDIA H100
    python3 chip_smoke.py --rehearse-cpu  # phases 3-13 and 15-25 on the CPU at small sizes
    python3 chip_smoke.py --rehearse-part mesh  # one part of them: serve, train or mesh
    python3 chip_smoke.py --profile       # adds a profile of each kernel path's serve

Phases, each printing lines with the elapsed seconds:

1. the card: name, device count and ``nvidia-smi`` name / power limit;
2. the build of the CUDA kernels (seconds, ptxas register/smem report), and
   from ``cuobjdump -sass`` of the built library, where the toolkit has it,
   the count of int8 tensor-core (``IMMA``, ``IGMMA``) and ``IDP4A``
   instructions in each instantiation of the shared conv kernel
   (``conv_mma.cuh``: two in G's and H's source, four each in B's and D's,
   f32 and bf16 epilogues) and in B's and D's ``__dp4a`` bodies: it fails
   unless every ``conv_mma_kernel`` has ``IGMMA`` and no ``IMMA`` or
   ``IDP4A``;
3. kernel A (LN + leaky + int8) against its plain version at [256, 92160]
   and at the w=0.125 student's [256, 11520] (from a seeded stream of its
   own), each launched twice: the rerun bit-identical, both launches in
   thread-block clusters of the launch plan's k (``cluster_launches``);
   and bit for bit equal to an IEEE float32 numpy reference at [64, 92160]
   on inputs whose sums are exact in any order (pairs of small integers
   +v, -v), which holds its quantise pass's division to IEEE's;
4. kernel B (up2 + conv4 int8) against its plain version, bit for bit in f32
   and bf16, at [64, 18, 10, 512] -> 256 with the teacher's Conv_0 weights
   (on the int8 tensor cores) and at a narrow [4, 5, 3, 36] -> 70 (its
   ``__dp4a`` body);
5. kernel C (GN + leaky + int8) against its plain version at [64, 35, 19, 256]
   with the teacher's GroupNorm2d_0 parameters and at the student's
   [64, 35, 19, 32] (a stream of its own), checked as A is, and bit for
   bit on small-integer inputs at [64, 35, 19, 256];
6. kernel D (row-resize conv4 int8) against its plain version, bit for bit
   in f32 and bf16, at [64, 35, 30, 256] -> 128 with the teacher's Conv_1
   weights (on the tensor cores) and at a narrow [4, 35, 30, 32] -> 32;
7. the plain int8 conv (``_conv_i8``, int32 sums) against an int64 direct
   sum at Conv_1's and Conv_2's shapes;
7b. kernels G (fused decode front) and H (whole fused decode) against their
   plain versions at [64, 92160]: the Dense_1 output of the teacher's
   expert 1 (bf16, as the engine holds it) on seeded noise and conditions,
   with that expert's weights; H also with ``apply_expm1``; each run twice
   and ``torch.equal``, every launch with each norm stage in clusters of its
   plan's k with its plan's body (``cluster_launches``); then each of
   the three int8 convs that G and H launch (``fused_conv_int8``: Conv_0's
   parity phases, Conv_1, Conv_2) on that path's own activations, equal to
   its plain version bit for bit; then each of the four norm stages
   (``fused_norm_stage``: 1 LN-quant, 3 GN_0-quant through the resize, 5
   GN_1-quant, 7 GN_2 + Conv_3) on that path's own input against its plain
   version at A's and C's bounds (s within rtol 1e-5, |q - q_plain| <= 1,
   flips under 1%; stage 7 within H's int8 bound), run twice bit-identical,
   both launches in clusters of the plan's k;
8. serving the full-width proton teacher's generator
   (artifacts/gate/gate_serving_weights.npz): 16384 showers through
   ``FastSim(precision="int8")`` (the yardstick), then through each kernel
   path, ``"int8_pallas_ab"`` (kernels A, B), ``"int8_pallas"`` (A, B, C,
   D), ``"int8_fused_front"`` (G) and ``"int8_fused"`` (H): launch counts of
   each path's kernels (set to 0 just before the path runs, read just after;
   each must be > 0, every launch of B and D on the tensor cores, and
   every launch of A and C in clusters of its plan's k),
   output checks, agreement with ``"int8"``, rate and peak memory of every
   path. The teacher's router sends every condition to
   expert 1, so the serve routes with a router drawn from ``--seed`` and
   fails unless every expert decodes showers;
9. kernel times with CUDA events at the serving tile (64 rows); A and C
   replayed in a CUDA graph (they take less time on the card than one
   launch through the host), beside the host loop's time, and at
   each cluster size k of 1, 2, 4, 8 and 1, 7 and 64 rows, beside
   ``cudaOccupancyMaxActiveClusters`` (the sweep that chose the plan); B and D
   beside, as a yardstick the port never calls, ``torch._int_mm`` on pre-built
   [M, K] x [K, N] matrices of the same GEMM shapes (no im2col); beside G
   and H, the ported chains that compute the same functions: kernels A -> B
   (f32 out) -> C -> the resize gather, and the ``int8_pallas`` decode after
   the MLP; each of G's and H's three convs beside its int8 bound and
   ``torch._int_mm`` likewise; each norm stage of G and H alone, replayed in
   a CUDA graph at 64 and 256 rows beside its byte floor and its plan's k,
   GN_0 and GN_1 also at k = 2 (streamed), 4 and 8 (kept), the sweep that
   chose their plans; G and H replayed in a CUDA graph at 64 and 256 rows,
   beside the host loop's time;
10. the fidelity gate's test split (25600 synthetic events, seed 7, numpy),
    and kernel E (expm1 + channel sums) against its plain version (rtol
    1e-5) on its 5120 real showers [5120, 56, 30] in f32 and in bf16 and on
    a [37, 44, 44] f32 batch, each launch on the bulk ring
    (``bulk_launches``);
11. kernel F (routed expm1 + channel sums) on the teacher's all-expert
    log-space decode of 4096 showers [3, 4096, 56, 30], routed by phase 8's
    seeded router (launches counted over this path): against its plain
    version (rtol 1e-5), bit-equal to kernel E on the routed rows, both on
    the bulk ring;
12. ``f32`` and ``bf16`` serves of 4096 teacher showers against ``int8`` on
    the same inputs (routing identical, per-shower log1p sums within rtol
    0.15), with rate and peak memory;
13. the fidelity gate (``fidelity_torch.run_gate``, three noise draws) on
    the teacher at ``int8``, ``int8_pallas`` and ``int8_fused`` and on the
    w=0.125 student at ``int8``: each record, its kernel launches (counts set to 0 just
    before each gate), and a failure unless its value is finite,
    ``vs_baseline >= 1.0`` and every launch of E on the bulk ring; the
    floor is printed beside the CPU tests' anchor;
14. kernels E and F at [16384, 56, 30] in f32 and bf16 (E also at the
    gate's 5120 showers): replayed in a CUDA graph, beside the host loop's
    time, the direct body (one warp a shower reading device memory itself)
    forced on the same input (``_direct_body``, graph replayed), their
    plain versions, PyTorch's ``expm1`` then the channel-basis matmul, and
    the bound; each graph's replays, the ``GRAPH_WARM`` untimed ones first,
    and E at f32 timed again after the other cases;
15. the engine API on the teacher behind phase 8's router: 8192 showers
    (chunks of 4096, tile 64) on ``int8_pallas`` and ``int8_fused`` through
    ``dyn_dispatch``, ``torch.equal`` to the switch path on the same noise
    and launching the path's kernels; then ``simulate_bulk`` replayed as a
    CUDA graph, ``torch.equal`` to the eager dyn loop on the same
    generator seed, both timed, beside the per-tile weight gather's device
    time in a replayed chunk; the dense ``simulate`` of 4096 showers on
    ``int8`` and ``int8_fused`` (kernel H) and its ``throughput``;
    ``static_act_quant`` on ``int8`` (its headroom and scales; within rel
    0.15 of the dynamic serve; x ``dyn_dispatch`` equal to x switch);
    ``simulate_grouped`` and ``simulate_stream``; each serve routed as the
    ``int8`` switch serve and within rtol 0.15 of its per-shower log1p
    sums; and ``bench_torch.py``'s first rung at ``BENCH_SHOWERS``;
16. the neutron family behind a router drawn from ``--seed`` that reads
    every expert (``NEUTRON_SERVE``): the neutron teacher on its module in
    ``bf16`` (16384 showers, chunks of 4096, tile 64) and both neutron
    students on ``int8`` (65536, chunks of 32768, tile 128) through the
    CUDA graph of the dyn tile loop, ``torch.equal`` to the eager dyn loop;
    a random full-width ``norm="batch"`` tree folded on the card and served
    on ``int8`` (eager switch); each serve reading every expert, finite and
    of shape [n, 44, 44], routed as an ``f32`` serve with per-shower log1p
    sums within rtol 0.15 of it (the students: per expert, the
    ``INT8_QUANTILE`` quantile of the relative differences within 0.15 and
    every one within ``INT8_CAP``, ``int8_rule``), launching no decode
    kernel, with the
    median, spread, routing and peak memory of 3 ``throughput_bulk`` runs;
    then the neutron gate's split (5120 real showers [5120, 44, 44]),
    kernel E on it against its plain version (rtol 1e-5) on the bulk ring,
    and the gates of both students (teacher-relative: each must reach
    ``vs_baseline >= 1.0``) and of the teacher (informational), each
    launching E once; E at that shape is timed as in phase 14 and joins
    its record's ``cases``;
17. training (``zdcsim_torch.train``): the full-width proton MoE (E=3,
    batch 512, f32 with TF32 off, ``TRAIN``) from ``init_state`` on the card
    steps 4 times through the dense step on the gate split's train side
    (``DeviceLoader``; 2 steps at epoch 0, 2 at epoch 1), failing unless
    every metric is finite, every active expert's kernels and spectral-norm
    ``u`` moved and every inactive one's leaves stayed, the EMA is ``0.99
    ema + 0.01 params`` and each ``u`` has unit norm; each step's losses,
    routing and CUDA-synchronised time, the median of steps 2 onwards, the
    peak memory and the kernel launches (none: the step runs no
    hand-written kernel) are printed; the first step runs twice from its
    state and must be ``torch.equal`` leaf by leaf (the step's
    ``deterministic()`` context); then one step at width 0.125, E=3,
    batch 16 (``TRAIN_CHECK``) runs on the card and on the CPU from one
    state and one set of draws, in float32 and in float64: in float64 every
    check must hold at the CPU tests' tolerances (``step_agreement``), in
    float32 all but Adam's moments (``AGREE_F32``), printed beside what 1e-6
    of noise does to the CPU's own step; the card's float32 step runs twice
    and must be ``torch.equal``; a ``{"train": ...}`` line records the
    phase;
18. the training loop (``zdcsim_torch.train.loop.train``): the full-width
    proton MoE (``LOOP``: E=3, batch 512, f32) for 2 epochs on a synthetic
    split of its own (2560 events, seed 7: 2048 train, 512 test), an eval
    every epoch with ``eval.fused_epilogue`` (kernel E), the split and the
    checkpoints saved (threshold 1e30, ``keep_best`` 1, async) under a
    temporary directory removed at the end. Each eval of the loop is
    followed by the same evaluation with the plain epilogue on the same
    state and a replay of its draws (``checked_evaluator`` stands in for
    the loop's ``build_evaluator``): it fails unless each eval launched E,
    every launch on the bulk ring, and agrees with the plain one (ws_mean
    within rel 1e-4, routing identical); unless ``keep_best`` left only the
    checkpoint of the lower ``ws_mean``, which restores ``torch.equal`` to
    the state it saved; unless a resume from it trains from its epoch with
    finite losses; unless ``FastSim.from_checkpoint`` serves 4096 showers on
    ``int8``, ``int8_pallas`` (launching A-D) and ``int8_fused`` (H) behind
    a router drawn from ``--seed``, each agreeing with ``int8`` (routing
    identical, per-shower log1p sums within rtol 0.15); and unless the CLI
    twin's ``--eval --checkpoint-epoch`` (in-process) prints the
    evaluator's keys. Printed: each epoch's seconds of steps, metrics sync,
    eval and callbacks (the loop's ``time split`` log records), one
    synchronous checkpoint write, the peak memory; a ``{"loop": ...}`` line
    records the phase;
19. the train step's options (``SWITCH``: full width, E=3, batch 512, the
    constant router GAN term) from the state after one dense float32 step
    on the gate split's first train batch: the switch step (float32,
    tile 128, ``dispatch_remat``), the dense float32 step, the dense and
    the switch bf16 steps and the dense ``fast_generator`` step, each run
    once warm and ``STEP_RUNS`` times timed (median, peak memory, FLOPs by
    ``torch.utils.flop_counter``), failing unless its last two runs are
    ``torch.equal`` leaf by leaf, the switch step agrees with the dense one
    (``switch_against_dense``: metrics at JAX's rtol 2e-4 / atol 1e-5,
    ``tests/test_train_step.py:237``, the shares equal, at most
    ``SWITCH_BEYOND_SHARE`` of the parameters' elements outside JAX's
    rtol 2e-3 / atol 2e-5, each within 2 lr, and Adam's first moments
    leaf by leaf within ``SWITCH_MU_RTOL`` of relative norm),
    each bf16 step's
    ``disc_loss`` is within rtol 0.1 / atol 0.05 of its float32 step's,
    and none of A-H is launched; then the switch step at
    ``TRAIN_CHECK`` (tile 4) on the card against the CPU, as phase 17
    holds the dense one; a ``{"options": ...}`` line records the phase;
20. the neutron family's training (``NEUTRON_TRAIN``: the preset
    ``zdcsim/config/neutron.yaml``, ``GeneratorNeutron`` v1 with
    ``norm=group``, ``DiscriminatorNeutron``, ``AuxRegNeutron``, width 1,
    E=3, batch 512, the constant router GAN term) on a synthetic neutron
    split of its own (``NEUTRON_LOOP`` events, seed 7), from the state after
    one dense float32 step: the dense float32 step, the switch float32 step
    (tile 128, ``dispatch_remat``), the dense bf16 step, and the dense
    float32 step under ``norm=batch`` (masked BatchNorm statistics) from a
    state of its own, each run once warm and ``NEUTRON_STEP_RUNS`` times
    timed (median, peak memory, FLOPs), failing unless its last two runs
    are ``torch.equal``, every metric is finite, every active expert's
    kernels and spectral-norm ``u`` (and under ``norm=batch`` its running
    statistics) moved and every inactive one's stayed, the switch step
    agrees with the dense one on draws that make them one computation
    (phase 19's limits), bf16's ``disc_loss`` is within rtol 0.1 / atol
    0.05 of float32's, and none of A-H is launched; then the dense
    ``group``, dense ``batch`` and switch ``group`` steps at
    ``TRAIN_CHECK`` on the card against the CPU as phase 17 holds the
    proton step; then one epoch of ``train()`` on the preset with
    ``eval.fused_epilogue``: its eval must launch kernel E on 44x44
    showers, every launch on the bulk ring, and agree with the plain
    epilogue (``checked_evaluator``), its checkpoint must be written and
    served by ``FastSim.from_checkpoint`` on ``f32`` behind a router that
    reads every expert; E's launches there join E's record; a
    ``{"neutron_train": ...}`` line records the phase;
21. distillation, the attention router and a run directory's gate: (a) the
    full-width teacher served on ``int8`` behind a seeded
    ``AttentionRouterNetwork`` (``ROUTER_SERVE``), its routing equal to the
    router's argmax on the CPU (a difference allowed only at a near tie),
    and one dense float32 step with that router at ``TRAIN_CHECK`` on the
    card against the CPU at phase 17's limits; (b) the committed proton
    teacher (the bf16 ``fast_generator_apply``) and neutron teacher
    (``GeneratorNeutron(norm="group")`` in bf16) each distilled into a
    w=0.125 student (``DISTILL``: batch 512, 25 updates a call, the
    scripts' cosine-decayed Adam) for two calls from one state, failing
    unless they are ``torch.equal``, every metric finite and the loss on
    the call's first draw lower after the call; the median call time, the
    peak memory, the student's parameters; then one call of
    ``DISTILL_CHECK`` on the card against the CPU (float32 teacher) within
    ``distill_agreement``'s limits; (c) each student written by
    ``save_serving_artifact`` into a temporary directory, read back and served
    on ``int8`` behind a seeded router, routing identical to the
    in-memory student and per-shower log1p sums within rtol 0.15; (d)
    phase 18's run directory (kept until here) gated by
    ``fidelity_torch.run_gate`` on the first ``RUNDIR_GATE`` conditions of
    the gate's split with one draw on ``int8_pallas`` and ``int8_fused``:
    the value finite, ``fidelity.py``'s record keys with the warning, E on
    the bulk ring and A-D or H launched, their launches joining the
    kernels line; a ``{"distill": ...}`` line records the phase;
22. the reference-format fixtures (``tests/fixtures/real_pickles``: 24
    proton events pickled by pandas 3 with pyarrow) read by
    ``zdcsim_torch.data.pickles`` with no pandas, split by ``get_dataset``
    and ``transform_data_for_training`` (``train.seed=7``) and held against
    ``expected.npz`` at rtol / atol 1e-6 (22 events, the photon-sum
    range), and their ``dataset_analysis_report`` printed; then
    ``cli_torch.py``'s main on the default config (``dataset.synthetic``
    false) pointed at them: the full-width proton MoE (E=3) for one epoch
    at batch 16 (one step), an eval on kernel E, the split and a checkpoint
    saved under a temporary directory; then resumed from that checkpoint,
    failing unless both exit 0, the resumed run reads the saved split back
    and E is launched, every launch on the bulk ring, E's launches joining
    the kernels line; then the eval figures: without matplotlib (the card's
    machine) ``train.save_eval_plots=true`` must raise before the first
    step, with it the PNGs must be written; the device half of
    ``generate_eval_figures`` on the checkpoint (18 showers) must route as
    the CPU's and match its showers (photon sums within rel 1e-4, pixels
    within rtol / atol 1e-4); a ``{"real_data": ...}`` line records the
    phase;
23. the mesh (``zdcsim_torch.parallel``), item 3's int8 forms and the host
    C++ prep library: (a) an NCCL world of one (a ``file://`` store in a
    temporary directory) and ``make_mesh(1)``; the teacher served through
    ``FastSim(mesh=...)`` on ``int8_pallas`` and ``int8_fused``
    (``MESH_SERVE``: 4096 showers at batch 1024, tile 64), ``simulate_switch``
    and ``simulate_bulk`` (the dyn form's CUDA graph, the gather after each
    replay), each ``torch.equal`` to the meshless engine on the same
    generator seed; the counts set to 0 just before the meshed
    ``simulate_switch`` and read just after must show the path's kernels
    (A-D, H), B and D on the tensor cores, A and C in clusters, and join
    the kernels line; (b) each of ``proton_fast``'s int8 switch settings
    (``INT8_CONV0_IMPL="naive"``, ``INT8_CONV1_IMPL="phase"``,
    ``INT8_CONV2=False``, ``DEQUANT_DTYPE=bfloat16``) on the teacher's
    ``int8`` serve (``FORMS_SERVE``) against the default forms by JAX's
    rule (routing identical, per-shower log1p sums within rtol 0.1); (c)
    the host C++ prep library built with this host's g++ (the phase fails
    if it does not) and held against numpy on 4096 random 56x30 images
    (sums of photon counts, coordinates and the row gather equal, ``log1p``
    within two ulp, the group std within 1e-5), each timed beside numpy;
    (d) a ``{"mesh": ...}`` line records the phase's times;
24. training on the ``(data, expert)`` mesh (item 8b) of a second NCCL
    world of one: (a) one dense f32 step and one switch bf16 step (tile
    128, ``dispatch_remat``) of the full-width proton MoE (E=3, batch 512;
    ``MESH_TRAIN``) through ``build_train_step(mesh=...)`` from one seeded
    state, batch and set of draws, each ``torch.equal`` leaf by leaf to the
    meshless step (a mesh of one makes every collective the identity), the
    switch step on the mesh run twice ``torch.equal``; (b) ``train()`` on
    the mesh (``MESH_LOOP``: switch bf16, 2 steps, 1 epoch, 1280 synthetic
    events, an eval on kernel E, a checkpoint of the gathered state), the
    checkpoint restored with no mesh ``torch.equal`` to the state the run
    returned and served by ``FastSim.from_checkpoint`` on ``int8_pallas``
    and ``int8_fused`` (2048 showers), E's and A-D's and H's launches
    joining the kernels line; a ``{"mesh_train": ...}`` line records the
    phase;
25. the public API: (a) every name of ``MODEL_REGISTRY`` built by
    ``build_model`` at its default specs on the card (parameters counted,
    every one on the card); (b) the teacher's generator and router loaded
    into modules from ``build_model``, ``API_ROWS`` (64) conditions routed
    by that router ``torch.equal`` to the engine's (``FastSim``, ``f32``)
    and served by each expert through that ``Generator`` (``expm1`` of its
    output, cuDNN's TF32 off) ``torch.equal`` to the engine's float
    ``Generator`` path (the decode of ``simulate_grouped``'s buckets); (c)
    ``ExpertDense`` at ``EXPERT_DENSE`` (E=3, B=512, I=256, O=128) on the
    card against its CPU result and a per-expert float64 matmul at rtol
    1e-5 (TF32 off), timed; the phase fails if any of A-H launches; a
    ``{"api": ...}`` line records it.

``--profile`` adds a ``torch.profiler`` trace of one serve of 16384 showers
on each kernel path (printed as a table, not written to disk): device time
of the 15 costliest kernels and of every kernel of the port below them,
and the device's idle share of the serve's wall time; and in phase 15 the
same of the eager dyn serve and the graph-replayed one on ``int8_pallas``
and ``int8_fused`` (with the share of ``index_select``, the weight
gather), and of one chunk of ``bench_torch.py``'s first rung, eager and
replayed; in phase 16 of one chunk of the neutron w=0.125 student,
eager and replayed; in phase 17 of one more full-width train step; in
phase 19 of one more dense bf16 and switch bf16 step; and in phase 20 of
one more neutron dense f32 and dense bf16 step.

The line before the last is the kernels' JSON record, with the launches of
the ``int8_pallas`` serve (the path that runs A-D), of the teacher's
``int8`` gate (E), of the all-expert path (F) and of the ``int8_fused_front``
(G) and ``int8_fused`` (H) serves (E's with the neutron loop's eval of
phase 20 and phase 22's evals added, A-E's and H's with phase 21's
gates of the run directory, A-D's and H's with phase 23's serves on
the mesh, and E's, A-D's and H's with phase 24's loop on the mesh and its
checkpoint's serves), A's and C's ``k_sweep`` and
``eager_ms`` (the host loop's time), B's and D's
``int_mm_ms``, G's and H's ``cluster_launches`` (the launches with every
norm stage in clusters of its plan's k; the script fails unless they are
all of G's and H's launches), ``eager_ms``, ``ms_256_rows``, ``conv_ms``
(their convs' times) and ``stage_ms`` (their norm stages' times), and E's and
F's ``body``, ``bulk_launches``, ``graph_ms``, ``old_body_ms`` and
``cases`` (every shape and dtype of phase 14; ``ms`` is ``graph_ms``); the
last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line is printed. Without a CUDA device the script exits with code 2
and prints no result. ``--rehearse-cpu`` runs at the sizes of
``REHEARSE_*`` below, each cut to what its phase needs to check what it
checks: D at 2 rows, G and H at [1, 92160], a serve of 7 showers in one
batch of 8 at tile 2 (the router drawn after their conditions sends them
to every expert; at 6 it leaves one out), the gate's split of 2560
synthetic events with E at [8, 56, 30], F's all-expert decode of 7
showers (the first count at which that router reads every expert), float
serves of 2 showers, the student's gate on the first 128 test conditions
in one chunk with one draw, and phase 15 on one shower an expert at batch
3, tile 1 (``int8_pallas``'s dyn check, grouped and stream dispatch on
the w=0.125 student; no ``int8_fused`` dyn check, which
``tests/test_torch_engine_api.py`` holds on the CPU; a dense serve of 1
shower; a calibration of 1 + 4 rows; one grouped bucket;
``bench_torch.py``'s first rung at 2 showers), and phase 16 at
``REHEARSE_NEUTRON`` (one shower an expert, batch 3, tile 1; the neutron
split of 2560 events, E on 8 of its showers, the w=0.125 neutron
student's gate on 128 conditions with one draw), and phase 17 at
``REHEARSE_TRAIN`` (2 steps at width 0.125, E=2, batch 4; with no card,
the first step is held against itself by the comparison), and phase 18 at
``REHEARSE_LOOP`` (width 0.125, E=2, batch 4 on 9 events: 1 step an
epoch, evals of 2 showers; serves of 6 showers on ``int8`` and
``int8_pallas``, the fused precision taking full width only; no timed
write), and phase 19 at ``REHEARSE_SWITCH`` (width 0.125, E=2, batch 4,
tile 2; one switch f32 step without remat from ``init_state``, held
against itself by both comparisons), and phase 20 at
``REHEARSE_NEUTRON_TRAIN`` (width 0.125, E=3, batch 4; one dense step
under ``norm=batch`` from ``init_state``; no switch-against-dense or
card-against-CPU comparison, which phases 17 and 19 rehearse; the loop
on ``REHEARSE_NEUTRON_LOOP`` events, its checkpoint served on 6
showers), and phase 21 at ``REHEARSE_*`` (the attention router's serve of
6 showers without its train step, which phase 17's comparison rehearses;
the neutron family alone distilled at batch 2, one update a call, with no
card-against-CPU call, its artifact's round trip on 6 showers; the run
directory's gate on 16 conditions on ``int8_pallas``), and phase 22 at
``REHEARSE_REAL_DATA`` (width 0.125, E=2, batch 16, ``--cpu``; the
rehearsal's proton steps take two experts, two thirds of three's work, so
that the train part stays under 20 s at two threads), and phase 23 at
``REHEARSE_*`` (a gloo world of one in-process; the w=0.125 student on
``int8_pallas`` alone, 8 showers at batch 8, tile 2, the fused precisions
taking full width only; its int8 forms on 8 showers; the host library on
512 images), and phase 24 at ``REHEARSE_MESH_TRAIN`` (a gloo world of one;
width 0.125, E=3, batch 4, tile 2, no ``dispatch_remat``, whose
``torch.utils.checkpoint`` imports ``torch._dynamo``, which looks for
pandas; the loop on 12 events, its checkpoint served on ``int8_pallas``
alone), and phase 25 on the CPU at its own sizes with the w=0.125 student
in the teacher's place. Phase 21's rehearsal serves the w=0.125 student behind the
attention router. ``--rehearse-part`` runs one part of the rehearsal
(``REHEARSE_PARTS``: serve = phases 3-16, train = 17-22, mesh = 23-25),
each recomputing from ``--seed`` what it needs of another: the train part
the gate's split (phase 10), the mesh part phase 8's router
(``phase8_router`` replays the seed's stream); only the serve part loads
the teacher. Both modes print each phase's seconds on one line before the
last; the rehearsal ends with ``{"rehearsal": true}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TEACHER = os.path.join(HERE, "artifacts", "gate", "gate_serving_weights.npz")
STUDENT = os.path.join(HERE, "artifacts", "gate", "student_w0.125_serving_weights.npz")
FLOOR_ANCHOR = 457.4265  # the floor of the full split on the CPU (tests/test_torch_data.py)
N_SHOWERS = 16384
F_SHOWERS = FLOAT_SHOWERS = 4096
EF_TIME_ROWS = 16384
GRAPH_WARM = 5  # untimed replays of a timed graph: at least so many
GRAPH_WARM_MS = 100  # and at least so much card time
# --rehearse-cpu sizes (see the module doc)
REHEARSE_SERVE = (7, 8, 2)  # showers, batch, tile
REHEARSE_SPLIT = 2560  # synthetic events of the gate's split: 512 test showers
REHEARSE_F = 7
REHEARSE_FLOAT = (2, 2, 2)
REHEARSE_GATE = 128  # test conditions, one chunk
REHEARSE_ENGINE = (None, 3, 1)  # phase 15: one shower an expert, batch 3, tile 1
REHEARSE_DENSE = (1, 1)  # phase 15's dense showers and batch
REHEARSE_BENCH = {"batch_size": 2, "tile": 2, "n_showers": 2}
REHEARSE_NEUTRON = (None, 3, 1)  # phase 16: one shower an expert, batch 3, tile 1
REHEARSE_TRAIN = (0.125, 2, 4, 2)  # phase 17: width, experts, batch, steps
ENGINE_SERVE = (8192, 4096, 64)  # phase 15: showers, batch, tile
ENGINE_DENSE = (4096, 2048)  # phase 15's dense showers and batch (DENSE_SAFE_BATCH)
BENCH_SHOWERS = 32768  # phase 15: bench_torch.py's first rung, cut from 262144 (guard 3)
NEUTRON = {name: os.path.join(HERE, "artifacts", "gate", f"neutron_{name}_serving_weights.npz")
           for name in ("teacher", "student_w0.125", "student_w0.25")}
# phase 16: showers, batch, tile (the teacher and the random norm=batch tree; the students)
NEUTRON_SERVE = {"teacher": (16384, 4096, 64), "student": (65536, 32768, 128)}
SERVE_BATCH, SERVE_TILE = 4096, 64  # bench.py's teacher ladder tile
TRAIN = (1.0, 3, 512, 4)  # phase 17: width, experts, batch, steps (half at epoch 0, half at 1)
TRAIN_CHECK = (0.125, 3, 16)  # phase 17's card-against-CPU step: width, experts, batch
LOOP = (1.0, 3, 512, 2560)  # phase 18: width, experts, batch, synthetic events (2048 / 512)
REHEARSE_LOOP = (0.125, 2, 4, 9)  # 1 step an epoch (7 train events), an eval of 2 showers
SWITCH = (1.0, 3, 512, 128)  # phase 19: width, experts, batch, tile
REHEARSE_SWITCH = (0.125, 2, 4, 2)
CHECK_TILE = 4  # phase 19's switch step at TRAIN_CHECK
STEP_RUNS = 2  # phase 19's timed runs of each variant after a warm one (none in the rehearsal)
NEUTRON_TRAIN = (1.0, 3, 512, 128)  # phase 20: width, experts, batch, switch tile (the preset)
REHEARSE_NEUTRON_TRAIN = (0.125, 3, 4, 2)
NEUTRON_STEP_RUNS = 1  # phase 20's timed runs of each full-width step after a warm one (guard 3)
NEUTRON_LOOP = 1280  # phase 20's synthetic events: 1024 train (2 steps of 512), 256 test
REHEARSE_NEUTRON_LOOP = 9  # 7 train (1 step of 4), 2 test
NEUTRON_LOOP_SERVE = (2048, 2048, 64)  # showers, batch, tile of the checkpoint's f32 serve
REHEARSE_NEUTRON_LOOP_SERVE = (6, 8, 2)
LOOP_SERVE = (4096, 4096, 64)  # phase 18's serves from the checkpoint: showers, batch, tile
REHEARSE_LOOP_SERVE = (6, 8, 2)
DISTILL = (0.125, 512, 25)  # phase 21: the students' width, batch, inner steps of a call
REHEARSE_DISTILL = (0.125, 2, 1)
DISTILL_LR = (2e-3, 3000)  # the experiment scripts' Adam: lr, cosine decay steps
DISTILL_CHECK = (TRAIN_CHECK[2], 1)  # the card-against-CPU call: batch, inner steps
ROUTER_SERVE = (4096, 4096, 64)  # phase 21: the attention router's serve: showers, batch, tile
REHEARSE_ROUTER_SERVE = (6, 8, 2)
RUNDIR_GATE = 2048  # phase 21: the run directory's gate on the first test conditions
REHEARSE_RUNDIR_GATE = 16
# phase 16's int8-against-f32 rule for the neutron students (int8_rule): expert
# 0's int8 tail crosses 0.15 on the largest shower for JAX's own serve too
INT8_QUANTILE = 0.999
INT8_CAP = 0.25
FIXTURES = os.path.join(HERE, "tests", "fixtures", "real_pickles")
REAL_DATA = (1.0, 3, 16)  # phase 22: width, experts, batch (18 train events: one step)
REHEARSE_REAL_DATA = (0.125, 2, 16)
MESH_SERVE = (4096, 1024, 64)  # phase 23 (a): showers, batch, tile
REHEARSE_MESH = (8, 8, 2)
FORMS_SERVE = (1024, 1024, 64)  # phase 23 (b): showers, batch, tile of each int8 form
REHEARSE_FORMS = (8, 8, 2)
NATIVE_IMAGES = 4096  # phase 23 (c): random 56x30 images
REHEARSE_NATIVE = 512
MESH_TRAIN = (1.0, 3, 512, 128)  # phase 24's steps: width, experts, batch, switch tile
REHEARSE_MESH_TRAIN = (0.125, 3, 4, 2)
MESH_LOOP = (1.0, 3, 512, 1280)  # phase 24's loop: width, experts, batch, events (2 steps, 1 epoch)
REHEARSE_MESH_LOOP = (0.125, 3, 4, 12)  # 2 steps of 4, an eval of 2 showers
MESH_LOOP_SERVE = (2048, 2048, 64)  # showers, batch, tile of the checkpoint's serves
REHEARSE_MESH_LOOP_SERVE = (6, 8, 2)
API_ROWS = 64  # phase 25: conditions routed and served through build_model's modules
EXPERT_DENSE = (3, 512, 256, 128)  # phase 25: ExpertDense's experts, rows, inputs, outputs
REHEARSE_PARTS = {"serve": "3-16", "train": "17-22", "mesh": "23-25"}  # --rehearse-part
NEAR_TIE = 1e-5  # a routing difference is allowed only where the top two logits are this close
# the evaluator's keys (zdcsim/train/evaluate.py:472-481): the CLI's --eval prints them
EVAL_KEYS = {"ws_mean", "ws_std", "ws_mean_exp", "ws_std_exp", "ws_mean_rel", "ws_real_floor",
             "eval_expert_counts", "epoch"}
A_ROWS, B_ROWS, C_ROWS, D_ROWS, GH_ROWS, TIME_ROWS = 256, 64, 64, 64, 64, 64
STUDENT_F, STUDENT_C = 11520, 32  # the w=0.125 student's Dense_1 and GroupNorm2d_0 widths
SWEEP_ROWS = (1, 7, 64)  # phase 9's cluster-size sweep of A and C
KERNEL_PATHS = {  # precision -> the kernels its decode launches
    "int8_pallas_ab": ("ln_leaky_rowquant", "up2_conv4_int8"),
    "int8_pallas": ("ln_leaky_rowquant", "up2_conv4_int8", "gn_leaky_rowquant",
                    "row_resize_conv4_int8"),
    "int8_fused_front": ("fused_decode_front",),
    "int8_fused": ("fused_decode",),
}
# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores, as train_bench_torch.py takes it

T0 = time.perf_counter()
PHASE_S = {}  # phase -> seconds, printed on one line at the end


def timed(phase: str, fn, *args, **kwargs):
    """Run one phase, adding its wall time to :data:`PHASE_S`."""
    t = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[phase] = PHASE_S.get(phase, 0.0) + time.perf_counter() - t


def log_phase_times() -> None:
    log("phase times", ", ".join(f"{k} {v:.2f}s" for k, v in PHASE_S.items())
        + f"; wall {time.perf_counter() - T0:.2f}s")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] t={time.perf_counter() - T0:.2f}s {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line(query: str = "name,power.limit") -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        fail("nvidia-smi printed no card")
    return out.splitlines()[0].strip()


def kernel_wrappers():
    """Every kernel wrapper of the port by name; each counts its launches."""
    from zdcsim_torch.ops import kernel_wrappers as wrappers

    return wrappers()


SUB_COUNTS = {"mma_launches": "on conv_mma", "cluster_launches": "on clusters",
              "bulk_launches": "on the bulk ring"}


def reset_counts(wrappers):
    """Set every launch count to 0 (B's and D's tensor-core counts, A's and
    C's cluster counts and E's and F's bulk-ring counts too)."""
    from zdcsim_torch.ops import COUNTERS

    for w in wrappers.values():
        for attr in COUNTERS:
            if hasattr(w, attr):
                setattr(w, attr, 0)


def read_counts(wrappers):
    """``{name: launches}``, with ``{name + " on conv_mma": n}`` for B and D,
    ``{name + " on clusters": n}`` for A and C (launches in clusters of the
    plan's k) and ``{name + " on the bulk ring": n}`` for E and F."""
    counts = {name: w.launches for name, w in wrappers.items()}
    for attr, label in SUB_COUNTS.items():
        counts.update({f"{name} {label}": getattr(w, attr) for name, w in wrappers.items()
                       if hasattr(w, attr)})
    return counts


def check_conv_equal(phase, what, fn, plain, args, dev, mma):
    """Kernel B or D (``fn``) against its plain version on ``args``, bit for
    bit in f32 and bf16, and on the tensor cores exactly when ``mma``.
    Returns the largest absolute difference (0)."""
    import torch

    n0 = fn.mma_launches
    errs, same = [], True
    for dt in (torch.float32, torch.bfloat16):
        out, ref = fn(*args, out_dtype=dt), plain(*args, out_dtype=dt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = same and out.shape == ref.shape and torch.equal(out, ref)
        errs.append((out.float() - ref.float()).abs().max().item())
    on_mma = dev.type == "cuda" and fn.mma_launches == n0 + 2
    body = "int8 tensor cores" if mma else "__dp4a body"
    ran = body if dev.type == "cuda" else f"plain version on the CPU; the card runs the {body}"
    log(phase, f"{what} -> {tuple(out.shape)} ({ran}): equal to its plain version {same} "
        f"(max abs err f32 {errs[0]:.3e}, bf16 {errs[1]:.3e})")
    if not same:
        fail(f"{what} disagrees with its plain version")
    if dev.type == "cuda" and on_mma != mma:
        fail(f"{what} ran on the {'__dp4a body' if mma else 'tensor cores'}, not the {body}")
    return max(errs)


def narrow_conv_inputs(rng, rows, h, w, cin, cout, dev):
    """Seeded int8 activations, a random 4x4 kernel (f32), sx and bias at a
    narrow width (a student's, on the ``__dp4a`` bodies)."""
    import torch

    xq = torch.as_tensor(rng.integers(-127, 128, (rows, h, w, cin), dtype="int8")).to(dev)
    kernel = torch.as_tensor(rng.standard_normal((4, 4, cin, cout), dtype="float32") * 0.1).to(dev)
    sx = torch.as_tensor((abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")).to(dev)
    bias = torch.as_tensor(rng.standard_normal(cout, dtype="float32")).to(dev)
    return xq, kernel, sx, bias


def norm_sample(x):
    """``(kind, sample)`` of :func:`norm_quant_plan` for kernel A's ``[B, F]``
    or kernel C's ``[B, H, W, C]`` input."""
    if x.ndim == 2:
        return "ln", (x.shape[1],)
    return "gn", (x.shape[1] * x.shape[2], x.shape[3])


def check_norm_quant(phase, what, fn, plain, args, s_rtol, dev):
    """Kernel A or C (``fn``) against its plain version on ``args``: s within
    ``s_rtol``, |q - q_plain| <= 1 with flips under 1%; a second launch
    bit-identical to the first; on the card, both launches in clusters of
    the plan's k. Returns the largest |q - q_plain|."""
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    n0, c0 = fn.launches, fn.cluster_launches
    q, s = fn(*args)
    q2, s2 = fn(*args)
    qp, sp = plain(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    s_rel = ((s - sp).abs() / sp).max().item()
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    q_max, flips = diff.max().item(), (diff != 0).float().mean().item()
    rerun = torch.equal(q, q2) and torch.equal(s, s2)
    n, nc = fn.launches - n0, fn.cluster_launches - c0
    x = args[0]
    kind, sample = norm_sample(x)
    plan = dk.norm_quant_plan(kind, x.shape[0], sample, x.element_size())
    log(phase, f"{what} {str(x.dtype)[6:]}: max s rel err {s_rel:.3e} (rtol {s_rtol:g}), "
        f"max |q - q_plain| {q_max} (<= 1), flips {flips:.3e} (< 1%); rerun bit-identical "
        f"{rerun}; {nc} of {n} launches in clusters of the plan's k={plan.k} ({plan.threads} "
        f"threads, {plan.smem} B shared, share {'kept' if plan.kept else 'streamed'})")
    if not (s_rel <= s_rtol and q_max <= 1 and flips < 0.01 and rerun):
        fail(f"{fn.__name__} {what} disagrees with its plain version or with its rerun")
    if dev.type == "cuda" and (n != 2 or nc != 2):
        fail(f"{fn.__name__} {what}: {nc} of {n} launches in clusters of the plan's k")
    return float(q_max)


def exact_sum_inputs(rng, shape, dev):
    """bf16 small integers, each row of A's ``[B, F]`` made of pairs +v, -v:
    every sum of A's and C's statistics is exact in any order."""
    import numpy as np
    import torch

    if len(shape) == 2:
        half = rng.integers(-8, 9, size=(shape[0], shape[1] // 2))
        vals = rng.permuted(np.concatenate([half, -half], axis=1), axis=1)
    else:
        vals = rng.integers(-8, 9, size=shape)
    return torch.as_tensor(vals.astype(np.float32)).to(dev, torch.bfloat16)


def ieee_norm_quant(kind, x, scale, bias, groups=32):
    """Kernel A's or C's function in numpy float32, each operation rounded
    once as IEEE says (numpy's ``sqrt`` and ``/`` are; torch's CPU ``sqrt``
    is not always): the reference on exact-sum inputs."""
    import numpy as np

    x = x.float().cpu().numpy()
    scale, bias = scale.cpu().numpy(), bias.cpu().numpy()
    b = x.shape[0]
    if kind == "ln":
        n = np.float32(x.shape[1])
        d = x - x.sum(1, keepdims=True, dtype=np.float32) / n
        rstd = np.float32(1) / np.sqrt((d * d).sum(1, keepdims=True, dtype=np.float32) / n
                                       + np.float32(1e-6))
        z = d * rstd * scale + bias
    else:
        _, h, w, c = x.shape
        xg = x.reshape(b, h * w, groups, c // groups)
        n = np.float32(h * w * (c // groups))
        mu = xg.sum((1, 3), dtype=np.float32) / n
        var = np.maximum((xg * xg).sum((1, 3), dtype=np.float32) / n - mu * mu, np.float32(0))
        rstd = np.float32(1) / np.sqrt(var + np.float32(1e-6))
        z = ((xg - mu[:, None, :, None]) * rstd[:, None, :, None]).reshape(x.shape) * scale + bias
    z = np.where(z >= 0, z, np.float32(0.1) * z).reshape(b, -1)
    s = np.maximum(np.abs(z).max(1, keepdims=True) / np.float32(127), np.float32(1e-12))
    return np.clip(np.round(z / s), -127, 127).astype(np.int8), s


def check_exact(phase, fn, args):
    """Kernel A or C on exact-sum inputs against :func:`ieee_norm_quant`: q
    and s bit for bit, which holds every rounding step, the quantise pass's
    division among them, to IEEE's."""
    import numpy as np

    x = args[0]
    q, s = fn(*args)
    q_ref, s_ref = ieee_norm_quant("ln" if x.ndim == 2 else "gn", *args)
    same = (np.array_equal(q.cpu().numpy().reshape(q_ref.shape), q_ref)
            and np.array_equal(s.cpu().numpy(), s_ref))
    log(phase, f"exact-sum {list(x.shape)} {str(x.dtype)[6:]}: equal to the IEEE float32 "
        f"reference bit for bit {same}")
    if not same:
        fail(f"{fn.__name__} differs from the IEEE float32 reference on exact-sum inputs")


def check_kernel_a(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    # as the engine holds them: bf16 weights, cast to f32 by quantize_weights
    ln = gp["MLPBlock_1"]["LayerNorm_0"]
    scale = torch.as_tensor(ln["scale"][0]).to(dev, torch.bfloat16).float()
    bias = torch.as_tensor(ln["bias"][0]).to(dev, torch.bfloat16).float()
    f = scale.shape[0]
    y = torch.as_tensor(rng.standard_normal((rows, f), dtype="float32") * 3.0).to(dev, torch.bfloat16)
    q_max = check_norm_quant("3 kernel A", f"[{rows}, {f}]", dk.ln_leaky_rowquant,
                             dk.ln_leaky_rowquant_plain, (y, scale, bias), 1e-6, dev)
    # the w=0.125 student's width, from a stream of its own, so that the
    # serve's conditions and router do not change
    srng = np.random.default_rng([seed, 3])
    sf = STUDENT_F
    ys = torch.as_tensor(srng.standard_normal((rows, sf), dtype="float32") * 3.0).to(dev, torch.bfloat16)
    ss = torch.as_tensor(srng.standard_normal(sf, dtype="float32") * 0.5 + 1.0).to(dev)
    bs = torch.as_tensor(srng.standard_normal(sf, dtype="float32") * 0.2).to(dev)
    check_norm_quant("3 kernel A", f"student [{rows}, {sf}]", dk.ln_leaky_rowquant,
                     dk.ln_leaky_rowquant_plain, (ys, ss, bs), 1e-6, dev)
    check_exact("3 kernel A", dk.ln_leaky_rowquant,
                (exact_sum_inputs(srng, (min(rows, TIME_ROWS), f), dev), scale, bias))
    return y, scale, bias, q_max


def check_kernel_b(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    conv = gp["Conv_0"]
    kernel = torch.as_tensor(conv["kernel"][0]).to(dev, torch.bfloat16)
    bias = torch.as_tensor(conv["bias"][0]).to(dev, torch.bfloat16).float()
    kq, sk = dk._quant_phases(kernel)
    kp = dk.pack_k_major(kq)
    cin = kernel.shape[2]
    xq = torch.as_tensor(rng.integers(-127, 128, (rows, 18, 10, cin), dtype="int8")).to(dev)
    sx = torch.as_tensor(
        (abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")
    ).to(dev)
    err = check_conv_equal("4 kernel B", f"[{rows}, 18, 10, {cin}]", dk.up2_conv4_int8,
                           dk.up2_conv4_int8_plain, (xq, sx, kp, sk, bias), dev, True)
    # a narrow width from a stream of its own, so that the serve's data do not change
    nx, nk, nsx, nb = narrow_conv_inputs(np.random.default_rng([seed, 4]), 4, 5, 3, 36, 70, dev)
    nkq, nsk = dk._quant_phases(nk)
    check_conv_equal("4 kernel B", "narrow [4, 5, 3, 36]", dk.up2_conv4_int8,
                     dk.up2_conv4_int8_plain, (nx, nsx, dk.pack_k_major(nkq), nsk, nb), dev, False)
    return xq[:TIME_ROWS], sx[:TIME_ROWS], kp, sk, bias, err


def check_kernel_c(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    gn = gp["GroupNorm2d_0"]["GroupNorm_0"]
    scale = torch.as_tensor(gn["scale"][0]).to(dev, torch.bfloat16).float()
    bias = torch.as_tensor(gn["bias"][0]).to(dev, torch.bfloat16).float()
    c = scale.shape[0]
    x = torch.as_tensor(rng.standard_normal((rows, 35, 19, c), dtype="float32") * 2.0
                        + 0.5).to(dev, torch.bfloat16)
    q_max = check_norm_quant("5 kernel C", f"[{rows}, 35, 19, {c}]", dk.gn_leaky_rowquant,
                             dk.gn_leaky_rowquant_plain, (x, scale, bias), 1e-5, dev)
    # the w=0.125 student's GroupNorm width, from a stream of its own
    srng = np.random.default_rng([seed, 5])
    sc_ = STUDENT_C
    xs = torch.as_tensor(srng.standard_normal((rows, 35, 19, sc_), dtype="float32") * 2.0
                         + 0.5).to(dev, torch.bfloat16)
    ss = torch.as_tensor(np.abs(srng.standard_normal(sc_, dtype="float32")) + 0.5).to(dev)
    bs = torch.as_tensor(srng.standard_normal(sc_, dtype="float32") * 0.3).to(dev)
    check_norm_quant("5 kernel C", f"student [{rows}, 35, 19, {sc_}]", dk.gn_leaky_rowquant,
                     dk.gn_leaky_rowquant_plain, (xs, ss, bs), 1e-5, dev)
    check_exact("5 kernel C", dk.gn_leaky_rowquant,
                (exact_sum_inputs(srng, (rows, 35, 19, c), dev), scale, bias))
    return x[:TIME_ROWS], scale, bias, q_max


def check_kernel_d(gp, rng, dev, rows, seed):
    import numpy as np
    import torch

    from zdcsim_torch.models.proton_fast import _row_phase_plan
    from zdcsim_torch.ops import decode_kernels as dk

    conv = gp["Conv_1"]
    kernel = torch.as_tensor(conv["kernel"][0]).to(dev, torch.bfloat16)
    bias = torch.as_tensor(conv["bias"][0]).to(dev, torch.bfloat16).float()
    plans = _row_phase_plan(35, 56, 4, 1)[2]
    kq, sk, offsets = dk._quant_row_phases(kernel, plans)
    kp = dk.pack_k_major(kq)
    cin = kernel.shape[2]
    xq = torch.as_tensor(rng.integers(-127, 128, (rows, 35, 30, cin), dtype="int8")).to(dev)
    sx = torch.as_tensor(
        (abs(rng.standard_normal(rows)) * 0.01 + 1e-3).astype("float32")
    ).to(dev)
    log("6 kernel D", f"row phases: real groups {dk.row_phase_groups(offsets)}, offsets {offsets}")
    err = check_conv_equal("6 kernel D", f"[{rows}, 35, 30, {cin}]", dk.row_resize_conv4_int8,
                           dk.row_resize_conv4_int8_plain, (xq, sx, kp, sk, offsets, bias, 56),
                           dev, True)
    # a narrow width from a stream of its own, so that the later checks' data do not change
    nx, nk, nsx, nb = narrow_conv_inputs(np.random.default_rng([seed, 6]), 4, 35, 30, 32, 32, dev)
    nkq, nsk, noff = dk._quant_row_phases(nk, plans)
    check_conv_equal("6 kernel D", "narrow [4, 35, 30, 32]", dk.row_resize_conv4_int8,
                     dk.row_resize_conv4_int8_plain,
                     (nx, nsx, dk.pack_k_major(nkq), nsk, noff, nb, 56), dev, False)
    return xq[:TIME_ROWS], sx[:TIME_ROWS], kp, sk, offsets, bias, err


def conv_int64(xq, kq, pad):
    """Direct int64 sum of an NHWC x HWIO int8 conv, on the host's CPU (an
    independent reference: one float64 matmul per tap, every product and
    sum an integer far below 2**53, so exact, returned as int64)."""
    import torch
    import torch.nn.functional as F

    b, h, w, cin = xq.shape
    kh, kw, _, cout = kq.shape
    xp = F.pad(xq.cpu().to(torch.float64), (0, 0, pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    ho, wo = xp.shape[1] - kh + 1, xp.shape[2] - kw + 1
    k64 = kq.cpu().to(torch.float64)
    out = torch.zeros((b * ho * wo, cout), dtype=torch.float64)
    for a in range(kh):
        for c in range(kw):
            out += xp[:, a:a + ho, c:c + wo].reshape(-1, cin) @ k64[a, c]
    return out.to(torch.int64).reshape(b, ho, wo, cout)


def check_conv_i8(gp, rng, dev, rows):
    import torch

    from zdcsim_torch.models import proton_fast as pf

    for name, (h, w) in (("Conv_1", (56, 30)), ("Conv_2", (55, 29))):
        kernel = torch.as_tensor(gp[name]["kernel"][0]).to(dev, torch.bfloat16)
        kq, _ = pf._quant_per_cout(kernel)
        xq = torch.as_tensor(rng.integers(-127, 128, (rows, h, w, kq.shape[2]),
                                          dtype="int8")).to(dev)
        out = pf._conv_i8(xq, kq, ((1, 1), (1, 1)))
        ref = conv_int64(xq, kq, ((1, 1), (1, 1)))
        same = out.dtype == torch.int32 and torch.equal(out.cpu().to(torch.int64), ref)
        log("7 conv_i8", f"{name} [{rows}, {h}, {w}, {kq.shape[2]}] x {tuple(kq.shape)} -> "
            f"{tuple(out.shape)} int32 on {dev.type}: equal to the int64 direct sum {same} "
            f"(max |sum| {ref.abs().max().item()})")
        if not same:
            fail(f"_conv_i8 differs from the int64 direct sum at {name}")


def check_kernels_gh(gp, rng, dev, rows):
    """Phase 7b: G and H against their plain versions on the Dense_1 output
    of ``rows`` showers of the teacher's expert 1 (bf16, as the engine holds
    it), with that expert's weights. Returns the inputs and the errors."""
    import torch

    from zdcsim_torch.convert import expert, from_jax_params, tree_to_torch
    from zdcsim_torch.models.proton_fast import mlp_apply
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    p = tree_to_torch(expert(from_jax_params(gp, {})[0], 1), dtype=torch.bfloat16, device=dev)
    noise, cond = (torch.as_tensor(rng.standard_normal((rows, n), dtype="float32"))
                   .to(dev, torch.bfloat16) for n in (10, 9))
    front, tail = fdk.front_weights(p), fdk.tail_weights(p)
    g, h = fdk.fused_decode_front, fdk.fused_decode
    n0 = (g.launches, g.cluster_launches, h.launches, h.cluster_launches)
    with torch.no_grad():
        x = mlp_apply(p, noise, cond)
        q, s = g(x, *front)
        q2, s2 = g(x, *front)
        qp, sp = fdk.fused_decode_front_plain(x, *front)
        out = h(x, *front, *tail)
        out2 = h(x, *front, *tail)
        ref = fdk.fused_decode_plain(x, *front, *tail)
        counts = h(x, *front, *tail, apply_expm1=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rerun = torch.equal(q, q2) and torch.equal(s, s2) and torch.equal(out, out2)
    n = [a - b for a, b in zip((g.launches, g.cluster_launches, h.launches, h.cluster_launches),
                               n0)]
    plans = dict(zip(fdk.H_STAGES, fdk.stage_plans(fdk.H_STAGES, x)))
    log("7b kernels G, H", f"G and H run twice: torch.equal {rerun}; G {n[1]} of {n[0]} launches, "
        f"H {n[3]} of {n[2]} with every norm stage in clusters of its plan's k (stage: k, "
        f"share kept {', '.join(f'{st}: {pl.k}, {pl.kept}' for st, pl in plans.items())})")
    if not rerun:
        fail("G or H run twice differ")
    if dev.type == "cuda" and n != [2, 2, 3, 3]:
        fail(f"G or H ran a norm stage off its plan's clusters: launches, cluster launches {n}")
    s_rel = ((s - sp).abs() / sp).max().item()
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    q_max, flips = diff.max().item(), (diff != 0).float().mean().item()
    log("7b kernels G, H", f"G [{rows}, {x.shape[1]}] bf16 -> q {tuple(q.shape)}: max s rel err "
        f"{s_rel:.3e} (rtol 1e-5), max |q - q_plain| {q_max} (<= 1), flips {flips:.3e} (< 1%)")
    if not (q.shape == qp.shape and s.shape == sp.shape and s_rel <= 1e-5 and q_max <= 1
            and flips < 0.01):
        fail("kernel G disagrees with its plain version")
    err = (out - ref).abs().max().item()
    lim = 0.05 * ref.abs().max().item() + 0.05  # the int8 bound of the CPU tests
    e_rel, e_ok = within_rtol(counts, torch.expm1(out), 1e-5)
    log("7b kernels G, H", f"H [{rows}, {x.shape[1]}] bf16 -> {tuple(out.shape)} f32: max abs err "
        f"{err:.4e} (int8 bound {lim:.4f}); apply_expm1 against expm1 of the output: max rel "
        f"err {e_rel:.3e} (rtol 1e-5: {e_ok})")
    if not (out.shape == ref.shape and err < lim and e_ok and torch.isfinite(out).all()):
        fail("kernel H disagrees with its plain version")
    return p, x, front, tail, float(q_max), err


CONV_NAMES = {0: "Conv_0 (4 parity phases)", 1: "Conv_1", 2: "Conv_2"}
CONV0_SLABS = ((0, 9), (9, 6), (15, 6), (21, 4))  # (first tap, taps) of each parity phase


CONV_SOURCES = ("fused_decode", "up2_conv4_int8", "row_resize_conv4_int8")
DP4A_BODIES = ("up2_conv4_int8_kernel", "row_resize_conv4_int8_kernel")


def sass_label(name, index):
    """A readable label of a mangled kernel name from the SASS: the shared
    conv kernel as ``conv_mma_kernel<BN, f32|bf16> [source]`` (its anonymous
    namespace carries the source's name), a ``__dp4a`` body by its name with
    ``<f32|bf16>``; ``None`` for any other kernel."""
    import re

    out = "bf16" if "nv_bfloat16" in name else "f32"
    if "conv_mma_kernel" in name:
        bn = re.search(r"Li(\d+)E", name[name.index("conv_mma_kernel"):]).group(1)
        src = next((c for c in CONV_SOURCES if f"{c}_cu" in name), f"object {index}")
        return f"conv_mma_kernel<{bn}, {out}> [{src}]"
    return next((f"{b}<{out}>" for b in DP4A_BODIES if b in name), None)


def library_sass(lib_path):
    """``cuobjdump -sass`` of the built library; ``None`` where the toolkit
    has no ``cuobjdump``."""
    from zdcsim_torch.ops import _build

    exe = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(exe):
        return None
    return subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, timeout=300,
                          check=True).stdout


def conv_sass_counts(sass):
    """Phase 2: ``{label: {op: count}}`` of the int8 tensor-core (``IMMA``,
    ``IGMMA``) and ``IDP4A`` instructions in each instantiation of the shared
    ``conv_mma_kernel`` and of B's and D's ``__dp4a`` bodies, from the
    library's SASS."""
    import re

    counts, fn, n_elf = {}, None, 0
    for line in sass.splitlines():
        if "Fatbin elf code" in line:
            n_elf += 1  # one ELF per compiled source
        if "Function :" in line:
            fn = sass_label(line.split("Function :")[1].strip(), n_elf)
            if fn is not None:
                while fn in counts:  # two sources' instantiations under one label
                    fn += "'"
                counts[fn] = dict.fromkeys(("IMMA", "IGMMA", "IDP4A"), 0)
            continue
        if fn:
            # opcodes as SASS spells them: IMMA.16832..., IGMMA.64x..., IDP.4A...
            for op in re.findall(r"\b(IMMA|IGMMA|IDP)(?=[.\s])", line):
                counts[fn]["IDP4A" if op == "IDP" else op] += 1
    return counts


def bulk_sass_counts(sass):
    """Phase 2: ``{label: Counter(opcode)}`` of every instruction in each
    instantiation of E's and F's bulk body (``expm1_sums_bulk_kernel<dtype,
    shape>``, ``any`` for the generic one), from the library's SASS."""
    import collections
    import re

    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = None
            if "expm1_sums_bulk_kernel" in name:
                h, w = re.search(r"Li(\d+)ELi(\d+)E", name).groups()
                fn = (f"expm1_sums_bulk_kernel<{'bf16' if 'nv_bfloat16' in name else 'f32'}, "
                      f"{f'{h}x{w}' if h != '0' else 'any'}>")
                counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and m:
            counts[fn][m.group(1)] += 1
    return counts


def check_conv_stages(x, front, tail, dev):
    """Phase 7b, the convs: each int8 conv that G and H launch
    (``fused_conv_int8``: Conv_0's parity phases, Conv_1, Conv_2) on the
    activations of that path (the plain versions' LN-quant of the Dense_1
    output, G's resized grid, GN1-quant of Conv_1's output), equal to its
    plain version bit for bit. Returns each conv's inputs."""
    import torch

    from zdcsim_torch.ops import decode_kernels as dk
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    rows = x.shape[0]
    ln_s, ln_b, kp0, sk0, b0 = front[:5]
    kp1, sk1, b1, g1s, g1b, kp2, sk2, b2 = tail[:8]
    with torch.no_grad():
        xq, sx = dk.ln_leaky_rowquant_plain(x, ln_s, ln_b)
        q, s = fdk.fused_decode_front_plain(x, *front)
        y1 = fdk.fused_conv_int8_plain(1, q, s, kp1, sk1, b1)
        q2, s2 = dk.gn_leaky_rowquant_plain(y1, g1s, g1b, fdk.GROUPS)
        inputs = {0: (xq.reshape(rows, fdk.H0, fdk.W0, fdk.C0), sx.reshape(rows), kp0, sk0, b0),
                  1: (q, s, kp1, sk1, b1), 2: (q2, s2.reshape(rows), kp2, sk2, b2)}
        outs = {}
        for conv, args in inputs.items():
            out = fdk.fused_conv_int8(conv, *args)
            ref = fdk.fused_conv_int8_plain(conv, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            same = out.shape == ref.shape and torch.equal(out, ref)
            e = (out - ref).abs().max().item() if out.shape == ref.shape else float("inf")
            log("7b conv stages", f"conv{conv} {CONV_NAMES[conv]} {list(args[0].shape)} int8 -> "
                f"{list(out.shape)} f32: equal to its plain version {same} (max abs err {e:.3e})")
            if not same:
                fail(f"the int8 conv {CONV_NAMES[conv]} of G/H differs from its plain version")
            outs[conv] = ref
    return inputs, outs


STAGE_NAMES = {1: "LN-quant", 3: "GN_0-quant through the resize", 5: "GN_1-quant",
               7: "GN_2 + Conv_3"}


def check_norm_stages(x, front, tail, conv_out, dev):
    """Phase 7b, the norm stages: each of G's and H's four
    (``fused_norm_stage``) on that path's own input (the Dense_1 output, the
    outputs of Conv_0, Conv_1 and Conv_2 from :func:`check_conv_stages`)
    against its plain version, at kernels A's and C's bounds (s within rtol
    1e-5, |q - q_plain| <= 1, flips under 1%; stage 7 within H's int8
    bound), launched twice bit-identical, both launches in clusters of the
    plan's k with its body. Returns ``{stage: (x, scale, bias[, k3, b3])}``."""
    import torch

    from zdcsim_torch.ops import fused_decode_kernels as fdk

    fn = fdk.fused_norm_stage
    ln_s, ln_b, _, _, _, g0s, g0b = front
    g1s, g1b, g2s, g2b, k3, b3 = tail[3], tail[4], tail[8], tail[9], tail[10], tail[11]
    stage_in = {1: (x, ln_s, ln_b), 3: (conv_out[0], g0s, g0b), 5: (conv_out[1], g1s, g1b),
                7: (conv_out[2], g2s, g2b, k3, b3)}
    for stage, args in stage_in.items():
        n0, c0 = fn.launches, fn.cluster_launches
        with torch.no_grad():
            got, again = fn(stage, *args), fn(stage, *args)
            ref = fdk.fused_norm_stage_plain(stage, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        n, nc = fn.launches - n0, fn.cluster_launches - c0
        inp = args[0]
        plan = fdk.stage_plan(stage, inp.shape[0], inp.element_size())
        ran = (f"{nc} of {n} launches in clusters of the plan's k={plan.k} ({plan.threads} "
               f"threads, {plan.smem} B shared, share {'kept' if plan.kept else 'streamed'})")
        if stage == 7:
            rerun = torch.equal(got, again)
            err = (got - ref).abs().max().item()
            lim = 0.05 * ref.abs().max().item() + 0.05  # the int8 bound of H's check
            ok = got.shape == ref.shape and err < lim and bool(torch.isfinite(got).all())
            what = f"-> {list(got.shape)} f32: max abs err {err:.4e} (H's int8 bound {lim:.4f})"
        else:
            (q, s), (q2, s2), (qp, sp) = got, again, ref
            rerun = torch.equal(q, q2) and torch.equal(s, s2)
            s_rel = ((s - sp).abs() / sp).max().item()
            diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
            q_max, flips = diff.max().item(), (diff != 0).float().mean().item()
            ok = (q.shape == qp.shape and s.shape == sp.shape and s_rel <= 1e-5 and q_max <= 1
                  and flips < 0.01)
            what = (f"-> q {list(q.shape)}: max s rel err {s_rel:.3e} (rtol 1e-5), max |q - "
                    f"q_plain| {q_max} (<= 1), flips {flips:.3e} (< 1%)")
        log("7b norm stages", f"stage {stage} {STAGE_NAMES[stage]} {list(inp.shape)} "
            f"{str(inp.dtype)[6:]} {what}; rerun bit-identical {rerun}; {ran}")
        if not (ok and rerun):
            fail(f"norm stage {stage} ({STAGE_NAMES[stage]}) disagrees with its plain version "
                 "or with its rerun")
        if dev.type == "cuda" and (n != 2 or nc != 2):
            fail(f"norm stage {stage}: {nc} of {n} launches in clusters of the plan's k")
    return stage_in


def seeded_router(rng, n_experts=3, widths=(9, 128, 64, 32)):
    """A router in the artifact's Flax layout, drawn from ``rng`` (LeCun
    normal kernels, zero biases, as Flax initialises ``nn.Dense``)."""
    import numpy as np

    dims = [*widths, n_experts]
    return {
        f"Dense_{i}": {
            "kernel": (rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype("float32"),
            "bias": np.zeros(dims[i + 1], "float32"),
        }
        for i in range(len(dims) - 1)
    }


def serve_rate(eng, dev, n, batch, tile, card, seed, precision, phase="8 serve"):
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = eng.throughput_bulk(n_showers=n, generator=gen)
    peak = torch.cuda.max_memory_allocated(dev)
    log(phase, f"{precision} throughput_bulk: {stats['showers_per_sec']:.1f} showers/s "
        f"({n} showers in {stats['seconds']:.3f}s, batch {batch}, tile {tile}); "
        f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")


def serve(gp, rp, rng, dev, n, batch, tile, card, seed, profile=False):
    """The yardstick ``int8`` serve, then each kernel path; returns the
    launch counts of each path's main run and the seeded router."""
    import numpy as np
    import torch

    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models.router import RouterNetwork

    cond = rng.standard_normal((n, 9), dtype="float32")
    noise = rng.standard_normal((n, 10), dtype="float32")
    teacher_router = RouterNetwork(3)
    teacher_router.load_state_dict(to_state_dict(rp))
    with torch.no_grad():
        t_ids = teacher_router(torch.as_tensor(cond))[1].argmax(-1)
    log("8 serve", f"the teacher's router sends these conditions to experts "
        f"{torch.bincount(t_ids, minlength=3).tolist()}; serving with a router drawn from --seed")
    router = seeded_router(rng)

    eng8 = FastSim(gp, router, batch_size=batch, precision="int8", device=dev)
    eng8._build_switch(tile=tile)
    t = time.perf_counter()
    imgs8, ids8 = eng8.simulate_bulk(cond, noise=noise, return_experts=True)
    imgs8, ids8 = imgs8.cpu().numpy(), ids8.cpu().numpy()
    log("8 serve", f"int8 (plain int32 convs): {n} showers in {time.perf_counter() - t:.3f}s")
    if dev.type == "cuda":
        serve_rate(eng8, dev, n, batch, tile, card, seed, "int8")
    del eng8
    b = np.log1p(imgs8.sum(axis=(1, 2)))

    every = kernel_wrappers()
    wrappers = {name: every[name] for names in KERNEL_PATHS.values() for name in names}
    launches = {}
    for precision, names in KERNEL_PATHS.items():
        eng = FastSim(gp, router, batch_size=batch, precision=precision, device=dev)
        eng._build_switch(tile=tile)
        reset_counts(wrappers)
        t = time.perf_counter()
        imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_main = time.perf_counter() - t
        counts = read_counts(wrappers)
        launches[precision] = counts
        used = torch.bincount(ids, minlength=3).tolist()
        log("8 serve", f"{precision} main path: {n} showers, batch {batch}, tile {tile} in "
            f"{t_main:.3f}s; kernel launches {counts}; showers per expert {used}")
        if dev.type == "cuda" and min(counts[k] for k in names) <= 0:
            fail(f"the {precision} path did not launch each of its kernels {names}: {counts}")
        # the teacher's B (512 -> 256) and D (256 -> 128) run on the tensor cores
        off_mma = [k for k in names if counts.get(f"{k} on conv_mma", counts[k]) != counts[k]]
        if dev.type == "cuda" and off_mma:
            fail(f"the {precision} path ran {off_mma} off the tensor cores: {counts}")
        # A and C: every launch in clusters of its plan's k (the tiles' k
        # vary with their rows: 64 rows take k=2, a short last tile more)
        for k in names:
            if f"{k} on clusters" in counts:
                log("8 serve", f"{precision} {k}: {counts[k + ' on clusters']} of {counts[k]} "
                    f"launches in clusters of the plan's k")
        off_plan = [k for k in names if counts.get(f"{k} on clusters", counts[k]) != counts[k]]
        if dev.type == "cuda" and off_plan:
            fail(f"the {precision} path ran {off_plan} off their plan's cluster size: {counts}")
        if min(used) <= 0:
            fail(f"the serve did not decode with every expert: {used}")
        imgs_np, ids_np = imgs.cpu().numpy(), ids.cpu().numpy()
        if imgs_np.shape != (n, 56, 30) or not np.isfinite(imgs_np).all() or imgs_np.min() < 0:
            fail(f"{precision}: served showers not finite/non-negative of shape ({n}, 56, 30)")
        log("8 serve", f"{precision} output {imgs_np.shape} finite and >= 0 (min "
            f"{imgs_np.min():.3e}, max {imgs_np.max():.3e})")
        a = np.log1p(imgs_np.sum(axis=(1, 2)))
        rel = np.abs(a - b) / np.abs(b)
        same_ids = bool((ids_np == ids8).all())
        per_expert = [float(rel[ids8 == e].max()) for e in range(3)]
        log("8 serve", f"{precision} vs precision='int8': routing ids identical {same_ids}; "
            f"max rel diff of per-shower log1p sums {rel.max():.4f} (rtol 0.15), "
            f"per expert {[round(x, 4) for x in per_expert]}")
        if not same_ids or rel.max() > 0.15:
            fail(f"{precision} and int8 serving disagree")
        if dev.type == "cuda":
            serve_rate(eng, dev, n, batch, tile, card, seed, precision)
            if profile:
                profile_serve(lambda: eng.simulate_bulk(cond, noise=noise),
                              f"{precision} serve of {n} showers", card)
        del eng
    return launches, router


def profile_serve(run, what, card, phase="profile"):
    """``run()`` (one serve or step) under ``torch.profiler``: device time per kernel,
    and the share of its wall time in which no kernel ran. Returns
    ``{kernel name: [launches, us]}``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans, per_kernel = [], {}
    for e in prof.events():
        # a host span's copy on the device timeline (a user annotation) is no work
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = per_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    if not spans:
        fail(f"the profiler saw no device activity in {what}")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = sum(v[1] for v in per_kernel.values())
    log(phase, f"{what}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f} [{card}]")
    # the 15 costliest kernels, then those in anonymous namespaces, where every
    # kernel of the port lives (and a few of PyTorch's)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    for i, (name, (count, us)) in enumerate(ranked):
        if i < 15 or name.startswith("void (anonymous namespace)::"):
            print(f"  {us / 1e3:9.2f} ms {100 * us / total:5.1f}% {count:6d}x  {name[:110]}",
                  flush=True)
    return per_kernel


def time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, replays=None):
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed untimed for at least ``GRAPH_WARM`` replays and
    ``GRAPH_WARM_MS`` of card time, then 5 times, each replay between its
    own CUDA events; the mean call of the 5 is the time. A and C take 10-30
    us on the card, less than the host takes to launch one through its
    wrapper, so :func:`time_ms` measures the host there; replaying a graph
    does not. A card that comes from host-bound work runs the first tens of
    ms of load slower, so the untimed replays last that long.
    ``replays``, a list where given, receives every replay's ms a call, the
    untimed ones first."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start, first = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    first.record()
    first.synchronize()
    one_ms = start.elapsed_time(first)
    n_warm = max(GRAPH_WARM, -(-GRAPH_WARM_MS // one_ms))
    events = [first] + [torch.cuda.Event(enable_timing=True) for _ in range(int(n_warm) + 4)]
    for ev in events[1:]:
        graph.replay()
        ev.record()
    torch.cuda.synchronize()
    per_call = [one_ms / iters] + [a.elapsed_time(b) / iters for a, b in zip(events, events[1:])]
    if replays is not None:
        replays.extend(per_call)
    return events[-6].elapsed_time(events[-1]) / (5 * iters)


def in_grid_taps(h, w):
    """Tap-positions of the ``[2h-1, 2w-1]`` output that read the ``[h, w]``
    source grid; taps on the zero halo need no work. Phase ``ee`` covers h x w
    source positions, an odd row or column phase one fewer."""
    from zdcsim_torch.ops import decode_kernels as dk

    n = 0
    for name in dk._PHASES:
        rows = h if name[0] == "e" else h - 1
        cols = w if name[1] == "e" else w - 1
        for dr, dc in dk._PHASE_OFFSETS[name]:
            n += (sum(0 <= i + dr < h for i in range(rows))
                  * sum(0 <= j + dc < w for j in range(cols)))
    return n


def row_resize_taps(h, w, n_resized_rows):
    """(Row-group, column) tap-positions of kernel D's ``[n_resized_rows - 1,
    w]`` output that read the ``[h, w]`` source grid: each phase's merged
    row groups (not the zero-padded one) x the 4 column taps."""
    from zdcsim_torch.models.proton_fast import _row_phase_plan

    _, p_num, plans = _row_phase_plan(h, n_resized_rows, 4, 1)
    rows = sum(0 <= p_num * r + d < h
               for _, groups, n_phase in plans for r in range(n_phase) for d, _ in groups)
    return rows * sum(0 <= j + t - 1 < w for j in range(w) for t in range(4))


def pad1_taps(h, w, k):
    """Tap-positions of a ``k x k`` conv with one zero row/column before the
    ``[h, w]`` grid and its ``[h + 3 - k, w + 3 - k]`` output (H's Conv_1,
    Conv_2 and Conv_3) that read the grid; taps on the padding need no work."""
    def line(n):
        return sum(0 <= i + a - 1 < n for i in range(n + 3 - k) for a in range(k))
    return line(h) * line(w)


def bound(n_bytes, n_ops, ops_per_s, f32_ops=0):
    """``(bound in ms, what bounds it)``: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type
    (``f32_ops`` at the float32 rate, added to ``n_ops`` at ``ops_per_s``)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s + f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def int_mm_ms(kp, cin, gemms, gen):
    """``torch._int_mm`` on pre-built int8 matrices of a conv's GEMM shapes,
    a yardstick the port never calls: one ``[M, taps x Cin] x [taps x Cin,
    N]`` product per ``(M, first tap, taps)`` of ``gemms`` (no im2col), the
    B operand that slab of the packed weights ``kp`` (column-major, as
    cuBLASLt takes it). Returns ``(ms, TOP/s, [[M, K, N], ...])``."""
    import torch

    mats = []
    for m, tap0, taps in gemms:
        a = torch.randint(-127, 128, (m, taps * cin), generator=gen, device="cuda",
                          dtype=torch.int8)
        mats.append((a, kp[:, tap0 * cin:(tap0 + taps) * cin].contiguous().t()))
    ms = time_ms(lambda: [torch._int_mm(a, b) for a, b in mats], 50)
    ops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in mats)
    return ms, ops / ms / 1e9, [[a.shape[0], a.shape[1], b.shape[1]] for a, b in mats]


def time_kernels(a_in, b_in, c_in, d_in, launches, errs, card):
    """Phase 9, kernels A-D at the serving tile; B and D also beside
    ``torch._int_mm`` on their GEMM shapes."""
    import torch

    from zdcsim_torch.ops import decode_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(90)

    y, scale, bias = a_in
    y = y[:TIME_ROWS].contiguous()
    rows, f = y.shape
    a_ms = graph_ms(lambda: dk.ln_leaky_rowquant(y, scale, bias), 50)
    a_eager = time_ms(lambda: dk.ln_leaky_rowquant(y, scale, bias), 50)
    a_plain = time_ms(lambda: dk.ln_leaky_rowquant_plain(y, scale, bias), 10)
    a_bytes = rows * f * 2 + 2 * f * 4 + rows * f + rows * 4
    a_ops = rows * f * 13  # mean 1, variance 3, normalise+affine 4, leaky 1, amax 1, quantise 3

    xq, sx, kp, sk, cbias = b_in
    nb, h, w, cin = xq.shape
    cout = kp.shape[0]
    b_ms = time_ms(lambda: dk.up2_conv4_int8(xq, sx, kp, sk, cbias, torch.bfloat16), 50)
    b_plain = time_ms(lambda: dk.up2_conv4_int8_plain(xq, sx, kp, sk, cbias, torch.bfloat16), 3)
    b_ops = 2 * nb * in_grid_taps(h, w) * cin * cout
    b_bytes = (xq.numel() + nb * 4 + kp.numel() + sk.numel() * 4 + cout * 4
               + nb * (2 * h - 1) * (2 * w - 1) * cout * 2)
    b_mm = int_mm_ms(kp, cin, [(nb * h * w, t0, t) for t0, t in CONV0_SLABS], gen)

    x, gscale, gbias = c_in
    x = x.contiguous()
    c_ms = graph_ms(lambda: dk.gn_leaky_rowquant(x, gscale, gbias), 50)
    c_eager = time_ms(lambda: dk.gn_leaky_rowquant(x, gscale, gbias), 50)
    c_plain = time_ms(lambda: dk.gn_leaky_rowquant_plain(x, gscale, gbias), 10)
    c_bytes = x.numel() * 2 + 2 * x.shape[-1] * 4 + x.numel() + x.shape[0] * 4
    c_ops = x.numel() * 13  # sums 3, normalise+affine 4, leaky 1, amax 1, quantise 3, +1 rounding

    dq, dsx, dkp, dsk, offsets, dbias = d_in
    dq = dq.contiguous()
    nd, hd, wd, dcin = dq.shape
    dcout = dkp.shape[0]
    d_ms = time_ms(lambda: dk.row_resize_conv4_int8(dq, dsx, dkp, dsk, offsets, dbias, 56,
                                                    torch.bfloat16), 50)
    d_plain = time_ms(lambda: dk.row_resize_conv4_int8_plain(dq, dsx, dkp, dsk, offsets, dbias,
                                                             56, torch.bfloat16), 3)
    d_ops = 2 * nd * row_resize_taps(hd, wd, 56) * dcin * dcout
    d_bytes = (dq.numel() + nd * 4 + dkp.numel() + dsk.numel() * 4 + dcout * 4
               + nd * 55 * wd * dcout * 2)
    max_l = len(offsets[0])
    d_mm = int_mm_ms(dkp, dcin, [(nd * ((55 - p + 7) // 8) * wd, p * max_l * 4, 4 * n)
                                 for p, n in enumerate(dk.row_phase_groups(offsets))], gen)

    rec = []
    for name, src, replaces, ms, plain, n_bytes, n_ops, peak, err in (
        ("ln_leaky_rowquant", "ln_leaky_rowquant.cu", "zdcsim/ops/pallas_decode.py:74",
         a_ms, a_plain, a_bytes, a_ops, F32_OPS_PER_S, errs[0]),
        ("up2_conv4_int8", "up2_conv4_int8.cu", "zdcsim/ops/pallas_decode.py:211",
         b_ms, b_plain, b_bytes, b_ops, INT8_OPS_PER_S, errs[1]),
        ("gn_leaky_rowquant", "gn_leaky_rowquant.cu", "zdcsim/ops/pallas_decode.py:308",
         c_ms, c_plain, c_bytes, c_ops, F32_OPS_PER_S, errs[2]),
        ("row_resize_conv4_int8", "row_resize_conv4_int8.cu", "zdcsim/ops/pallas_decode.py:463",
         d_ms, d_plain, d_bytes, d_ops, INT8_OPS_PER_S, errs[3]),
    ):
        bound_ms, bound_by = bound(n_bytes, n_ops, peak)
        rec.append({"name": name, "route": "cuda", "source": f"zdcsim_torch/csrc/{src}",
                    "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None})
    for r, ((mm, mm_tops, shapes), n_ops) in ((rec[1], (b_mm, b_ops)), (rec[3], (d_mm, d_ops))):
        r["int_mm_ms"] = mm
        log("9 kernel times", f"{r['name']} on the int8 tensor cores: {r['ms']:.4f} ms "
            f"({n_ops / r['ms'] / 1e9:.1f} TOP/s on the in-grid taps); "
            f"torch._int_mm on pre-built [M, K, N] {shapes}: {mm:.4f} ms "
            f"({mm_tops:.1f} TOP/s); {launches[r['name'] + ' on conv_mma']} of its "
            f"{r['launches']} launches on the tensor cores [{card}]")
    for r, eager in ((rec[0], a_eager), (rec[2], c_eager)):
        r["eager_ms"] = eager
        log("9 kernel times", f"{r['name']}: {r['ms']:.4f} ms a launch replayed in a CUDA "
            f"graph, {eager:.4f} ms a launch through the wrapper's host loop [{card}]")
    for r in rec:
        log("9 kernel times", f"{r['name']} at {TIME_ROWS} rows: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, {r['launches']} launches per "
            f"{N_SHOWERS} showers on the int8_pallas path [{card}]")
    return rec


def sweep_clusters(rec, a_in, c_in, card):
    """Phase 9, A and C: every cluster size of ``CLUSTER_SIZES`` at
    ``SWEEP_ROWS`` rows of the serving shapes (:func:`graph_ms`), beside how many
    such clusters the card holds at once; the plan's k is marked. Adds the
    sweep to A's and C's records as ``k_sweep``."""
    from zdcsim_torch.ops import decode_kernels as dk

    for r, fn, (data, *params) in ((rec[0], dk.ln_leaky_rowquant, a_in),
                                   (rec[2], dk.gn_leaky_rowquant, c_in)):
        kind, sample = norm_sample(data)
        sweep = []
        for rows in SWEEP_ROWS:
            xs = data[:rows].contiguous()
            plan_k = dk.norm_quant_plan(kind, rows, sample, xs.element_size()).k
            for k in dk.CLUSTER_SIZES:
                p = dk.norm_quant_plan(kind, rows, sample, xs.element_size(), k)
                ms = graph_ms(lambda: fn(xs, *params, k=k), 50)
                n = dk.norm_quant_max_clusters(kind, xs.dtype, sample, k)
                sweep.append({"rows": rows, "k": k, "ms": ms, "max_active_clusters": n,
                              "kept": p.kept, "plan": k == plan_k})
                log("9 cluster sweep", f"{r['name']} [{rows}, {', '.join(map(str, sample))}] "
                    f"{str(xs.dtype)[6:]} k={k}: {ms:.4f} ms; {n} such clusters fit at once; "
                    f"{p.threads} threads, {p.smem} B shared, share "
                    f"{'kept' if p.kept else 'streamed'}{'  <- plan' if k == plan_k else ''} "
                    f"[{card}]")
        r["k_sweep"] = sweep


def time_conv_stages(conv_in, card):
    """Phase 9, the convs: each int8 conv of G and H with CUDA events at the
    serving tile, beside its int8 bound (the taps that read the source grid)
    and ``torch._int_mm`` on pre-built ``[M, K] x [K, N]`` int8 matrices of
    the same GEMM shapes (one per Conv_0 phase, the full K; no im2col), a
    yardstick the port never calls. Returns ``{"conv<i>": ms}``."""
    import torch

    from zdcsim_torch.ops import fused_decode_kernels as fdk

    gen = torch.Generator(device="cuda").manual_seed(9)
    taps = {0: in_grid_taps(18, 10), 1: pad1_taps(56, 30, 4), 2: pad1_taps(55, 29, 3)}
    slabs = {0: CONV0_SLABS, 1: ((0, 16),), 2: ((0, 9),)}
    times = {}
    for conv, args in conv_in.items():
        xq, sx, kp, sk, bias = args
        rows = xq.shape[0]
        (h, w, cin), (oh, ow, cout) = fdk.CONVS[conv][:2]
        with torch.no_grad():
            ms = time_ms(lambda: fdk.fused_conv_int8(conv, *args), 50)
        n_ops = 2 * rows * taps[conv] * cin * cout
        n_bytes = (xq.numel() + kp.numel() + 4 * (sx.numel() + sk.numel() + bias.numel())
                   + 4 * rows * oh * ow * cout)
        bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OPS_PER_S)
        m = rows * (h * w if conv == 0 else oh * ow)
        mm_ms, mm_tops, shapes = int_mm_ms(kp, cin, [(m, t0, t) for t0, t in slabs[conv]], gen)
        times[f"conv{conv}"] = ms
        log("9 conv times", f"conv{conv} {CONV_NAMES[conv]} at {rows} rows: {ms:.4f} ms "
            f"({n_ops / ms / 1e9:.1f} TOP/s on the in-grid taps), bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound; torch._int_mm on pre-built "
            f"[M, K, N] {shapes}: {mm_ms:.4f} ms ({mm_tops:.1f} TOP/s) [{card}]")
    return times


STAGE_ROWS = (TIME_ROWS, 256)  # phase 9's rows of the norm stages, G and H
STAGE_SWEEP = {3: (2, 4, 8), 5: (2, 4, 8)}  # the f32 GroupNorms: k = 2 streams, 4 and 8 keep


def stage_bytes(stage, x):
    """The bytes norm stage ``stage`` must move on input ``x``: the input and
    its norm's parameters read once, the output (and s) written once."""
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    rows = x.shape[0]
    n_in = x.numel() * x.element_size()
    if stage == 1:
        return n_in + 2 * x.shape[1] * 4 + x.numel() + rows * 4
    c = x.shape[-1]
    if stage == 7:
        return n_in + 2 * c * 4 + 4 * c * 4 + 4 + rows * fdk.HG * fdk.WG * 4
    out_pixels = fdk.HG * fdk.WG if stage == 3 else x.shape[1] * x.shape[2]
    return n_in + 2 * c * 4 + rows * out_pixels * c + rows * 4


def time_norm_stages(stage_in, card):
    """Phase 9, the norm stages of G and H: each stage alone
    (``fused_norm_stage``, :func:`graph_ms`) at ``STAGE_ROWS`` rows (the
    64-row inputs repeated) beside its byte floor at 3.35 TB/s and its plan's
    k; the f32 GroupNorm stages also at each k of ``STAGE_SWEEP`` (k = 2
    streams the share in every pass in one wave, k = 4 and 8 keep it in
    shared memory over more than one wave), the sweep that chose the plan.
    Returns ``{rows: {stage: {"ms", "floor_ms", "k", "kept"}}}``."""
    import torch

    from zdcsim_torch.ops import decode_kernels as dk
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    fn = fdk.fused_norm_stage
    times = {}
    for rows in STAGE_ROWS:
        times[rows] = {}
        for stage, (x, *params) in stage_in.items():
            xr = x.repeat(-(-rows // x.shape[0]), *(1,) * (x.ndim - 1))[:rows].contiguous()
            floor_ms = stage_bytes(stage, xr) / HBM_BYTES_PER_S * 1e3
            plan = fdk.stage_plan(stage, rows, xr.element_size())
            for k in sorted(set(STAGE_SWEEP.get(stage, ())) | {plan.k}):
                p = fdk.stage_plan(stage, rows, xr.element_size(), k)
                with torch.no_grad():
                    ms = graph_ms(lambda: fn(stage, xr, *params, k=k), 20)
                if k == plan.k:
                    times[rows][stage] = {"ms": ms, "floor_ms": floor_ms, "k": k,
                                          "kept": p.kept}
                log("9 norm stages", f"stage {stage} {STAGE_NAMES[stage]} [{rows}, "
                    f"{', '.join(map(str, xr.shape[1:]))}] {str(xr.dtype)[6:]} k={k}: {ms:.4f} ms, "
                    f"byte floor {floor_ms:.4f} ms ({100 * floor_ms / ms:.1f}%), "
                    f"{-(-rows // dk.ONE_WAVE_CLUSTERS[k])} waves of up to "
                    f"{dk.ONE_WAVE_CLUSTERS[k]} clusters at one block an SM, share "
                    f"{'kept' if p.kept else 'streamed'}, {p.smem} B shared"
                    f"{'  <- plan' if k == plan.k else ''} [{card}]")
    return times


def time_fused(p, x, front, tail, launches, errs, conv_ms, card, stage_ms=None):
    """Phase 9, G and H: CUDA-event times at the serving tile beside their
    plain versions and the ported chains that compute the same functions
    (kernels A -> B (f32 out) -> C -> the resize gather; the ``int8_pallas``
    decode after the MLP); ``conv_ms`` (phase 9's conv times) goes into
    their records."""
    import torch

    from zdcsim_torch.models.proton_fast import decode_apply, quantize_weights
    from zdcsim_torch.ops import decode_kernels as dk
    from zdcsim_torch.ops import fused_decode_kernels as fdk

    x = x[:TIME_ROWS].contiguous()
    rows, f = x.shape
    ln_s, ln_b, kp0, sk0, b0, g0s, g0b = front
    qw = quantize_weights(p, "pallas")

    def chain_g():
        xq, sx = dk.ln_leaky_rowquant(x, ln_s, ln_b)
        y0 = dk.up2_conv4_int8(xq.reshape(rows, 18, 10, -1), sx, kp0, sk0, b0, torch.float32)
        q, s = dk.gn_leaky_rowquant(y0, g0s, g0b)
        return fdk._gather_resize(q), s

    def chain_h():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return decode_apply(p, x, torch.bfloat16, int8=True, int8_backend="pallas", qweights=qw)

    x256 = x.repeat(-(-256 // rows), 1)[:256].contiguous()
    with torch.no_grad():
        g_ms = graph_ms(lambda: fdk.fused_decode_front(x, *front), 20)
        g_eager = time_ms(lambda: fdk.fused_decode_front(x, *front), 20)
        g_256 = graph_ms(lambda: fdk.fused_decode_front(x256, *front), 10)
        g_plain = time_ms(lambda: fdk.fused_decode_front_plain(x, *front), 3)
        g_chain = time_ms(chain_g, 20)
        h_ms = graph_ms(lambda: fdk.fused_decode(x, *front, *tail), 20)
        h_eager = time_ms(lambda: fdk.fused_decode(x, *front, *tail), 20)
        h_256 = graph_ms(lambda: fdk.fused_decode(x256, *front, *tail), 10)
        h_plain = time_ms(lambda: fdk.fused_decode_plain(x, *front, *tail), 3)
        h_chain = time_ms(chain_h, 20)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # int8 operations on the taps that read each source grid; f32 operations:
    # LN as kernel A (13 an element), each GroupNorm as kernel C (13) and each
    # conv epilogue (3) per element, GN2 without the quant (9), Conv_3 (2 a tap)
    g_i8 = 2 * rows * in_grid_taps(18, 10) * 512 * 256
    g_f32 = rows * (f * 13 + 35 * 19 * 256 * 16)
    h_i8 = g_i8 + 2 * rows * (pad1_taps(56, 30, 4) * 256 * 128 + pad1_taps(55, 29, 3) * 128 * 64)
    h_f32 = g_f32 + rows * (55 * 29 * (128 * 16 + 64 * 12) + 2 * pad1_taps(55, 29, 2) * 64
                            + 56 * 30 * 2)
    g_bytes = nbytes((x,) + front) + rows * 56 * 30 * 256 + rows * 4
    h_bytes = nbytes((x,) + front + tail) + rows * 56 * 30 * 4
    rec = []
    stage_ms = stage_ms or {}
    for name, path, replaces, ms, eager, ms_256, plain, chain, n_bytes, i8, f32, err, what, \
            convs, stages in (
        ("fused_decode_front", "int8_fused_front", "zdcsim/ops/pallas_decode_fused.py:586", g_ms,
         g_eager, g_256, g_plain, g_chain, g_bytes, g_i8, g_f32, errs[0],
         "A -> B(f32) -> C -> gather", ("conv0",), fdk.G_STAGES),
        ("fused_decode", "int8_fused", "zdcsim/ops/pallas_decode_fused.py:479", h_ms, h_eager,
         h_256, h_plain, h_chain, h_bytes, h_i8, h_f32, errs[1], "the int8_pallas decode",
         ("conv0", "conv1", "conv2"), fdk.H_STAGES),
    ):
        bound_ms, bound_by = bound(n_bytes, i8, INT8_OPS_PER_S, f32)
        n = launches[path][name]
        split = {str(st): stage_ms.get(rows, {}).get(st, {}).get("ms") for st in stages}
        rec.append({"name": name, "route": "cuda", "source": "zdcsim_torch/csrc/fused_decode.cu",
                    "replaces": replaces, "launches": n,
                    "cluster_launches": launches[path].get(f"{name} on clusters", 0),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, "eager_ms": eager,
                    "ms_256_rows": ms_256, "chain_ms": chain,
                    "conv_ms": {c: conv_ms[c] for c in convs}, "stage_ms": split})
        log("9 kernel times", f"{name} at {rows} rows: {ms:.4f} ms replayed in a CUDA graph "
            f"({eager:.4f} ms through the wrapper's host loop; {ms_256:.4f} ms at 256 rows), its "
            f"convs {sum(conv_ms[c] for c in convs):.4f} ms, its norm stages {split} ms, plain "
            f"{plain:.4f} ms, chain ({what}) {chain:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound, {n} launches per {N_SHOWERS} "
            f"showers on its path [{card}]")
    return rec


def within_rtol(out, ref, rtol):
    """``(max relative error, all within rtol)`` of two tensors."""
    err = (out - ref).abs()
    return (err / ref.abs().clamp(min=1e-30)).max().item(), bool((err <= rtol * ref.abs()).all())


def gate_data(dev, rehearse):
    """Phase 10: the gate's split (numpy; its test side is the gate's), and
    kernel E against its plain version on its real showers (f32 and bf16)
    and on a neutron-sized batch, each launch on the bulk ring. Returns
    ``(cond, real, max abs err, split)``."""
    import numpy as np
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.config import load_config
    from zdcsim_torch.data.dataset import get_train_test_data
    from zdcsim_torch.data.loader import split_to_arrays
    from zdcsim_torch.ops import epilogue_kernels as ek

    t = time.perf_counter()
    overrides = [*ft.GATE_OVERRIDES]
    if rehearse:
        overrides.append(f"dataset.synthetic_n_samples={REHEARSE_SPLIT}")
    split = get_train_test_data(load_config(overrides))  # phase 17 trains on its train side
    test = split_to_arrays(split, False)
    cond, real = test["cond"], test["real"][..., 0]  # ft.gate_split's arrays
    log("10 kernel E", f"gate split in {time.perf_counter() - t:.2f}s: test cond {cond.shape}, "
        f"real {real.shape}, first test showers' photon sums "
        f"{np.expm1(real[:3]).sum(axis=(1, 2)).round(1).tolist()}")
    rng = np.random.default_rng(10)
    shown = real[:8] if rehearse else real
    errs = []
    for x, dt in ((shown, torch.float32), (shown, torch.bfloat16),
                  (rng.random((37, 44, 44), dtype=np.float32) * 3, torch.float32)):
        xt = torch.as_tensor(x).to(dev, dt)
        k0 = ek.expm1_channel_sums.bulk_launches
        out, ref = ek.expm1_channel_sums(xt), ek.expm1_channel_sums_plain(xt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rel, ok = within_rtol(out, ref, 1e-5)
        errs.append((out - ref).abs().max().item())
        on_bulk = ek.expm1_channel_sums.bulk_launches == k0 + 1
        ran = (f"on the bulk ring {on_bulk}" if dev.type == "cuda"
               else "plain version on the CPU; the card runs the bulk ring")
        log("10 kernel E", f"{list(x.shape)} {str(dt)[6:]} -> {list(out.shape)}: max rel err "
            f"{rel:.3e} (rtol 1e-5: {ok}), max abs err {errs[-1]:.3e} ({ran})")
        if not ok or not torch.isfinite(out).all():
            fail("kernel E disagrees with its plain version")
        if dev.type == "cuda" and not on_bulk:
            fail(f"kernel E on {list(x.shape)} {dt} did not run on the bulk ring")
    return cond, real, max(errs), split


def kernel_f_path(gp, router, dev, n, card):
    """Phase 11: the teacher's all-expert log-space decode of ``n`` showers
    (each expert decodes every shower), routed by phase 8's seeded router,
    into kernel F; F against its plain version, and bit-equal to kernel E
    on the routed rows, both on the bulk ring. Returns ``(launches of F,
    its bulk-ring launches, max abs err)``."""
    import numpy as np
    import torch

    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models.proton_fast import fast_generator_apply
    from zdcsim_torch.ops import epilogue_kernels as ek

    rng = np.random.default_rng(11)
    cond = torch.as_tensor(rng.standard_normal((n, 9), dtype="float32")).to(dev)
    noise = torch.as_tensor(rng.standard_normal((n, 10), dtype="float32")).to(dev)
    eng = FastSim(gp, router, batch_size=n, precision="int8", device=dev)
    with torch.no_grad():
        ids = eng.router(cond)[1].argmax(-1)
        for fn in (ek.expm1_channel_sums, ek.routed_expm1_channel_sums):
            fn.launches = fn.bulk_launches = 0
        imgs = torch.stack([
            fast_generator_apply(p, noise.to(torch.bfloat16), cond.to(torch.bfloat16), int8=True,
                                 qweights=q)[..., 0].to(torch.float32)
            for p, q in zip(eng._experts, eng._qweights)])
        out = ek.routed_expm1_channel_sums(imgs, ids)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    launches = ek.routed_expm1_channel_sums.launches
    bulk = ek.routed_expm1_channel_sums.bulk_launches
    used = torch.bincount(ids, minlength=3).tolist()
    log("11 kernel F", f"all-expert decode {list(imgs.shape)} f32 (log space) -> F: {launches} "
        f"launch(es), {bulk} on the bulk ring; showers per expert {used} [{card}]")
    if dev.type == "cuda" and (launches <= 0 or bulk != launches):
        fail("the all-expert path did not launch kernel F on the bulk ring")
    if min(used) <= 0:
        fail(f"the seeded router left an expert unread: {used}")
    ref = ek.routed_expm1_channel_sums_plain(imgs, ids)
    e_bulk = ek.expm1_channel_sums.bulk_launches
    rows = ek.expm1_channel_sums(imgs[ids, torch.arange(n, device=dev)].contiguous())
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if ek.expm1_channel_sums.bulk_launches != e_bulk + 1:
            fail("kernel E on the routed rows did not run on the bulk ring")
    rel, ok = within_rtol(out, ref, 1e-5)
    same = torch.equal(out, rows)
    err = (out - ref).abs().max().item()
    log("11 kernel F", f"F vs plain: max rel err {rel:.3e} (rtol 1e-5: {ok}), max abs err "
        f"{err:.3e}; F bit-equal to E on the routed rows: {same}")
    if not (ok and same and torch.isfinite(out).all()):
        fail("kernel F disagrees with its plain version or with kernel E")
    return launches, bulk, err


def float_serves(gp, router, dev, n, batch, tile, card, seed):
    """Phase 12: ``f32`` and ``bf16`` serves of ``n`` teacher showers against
    ``int8`` on the same conditions and noise, with phase 8's router."""
    import numpy as np
    import torch

    from zdcsim_torch.inference.engine import FastSim

    rng = np.random.default_rng(12)
    cond = rng.standard_normal((n, 9), dtype="float32")
    noise = rng.standard_normal((n, 10), dtype="float32")
    ref_ids, b = None, None
    for precision in ("int8", "f32", "bf16"):
        eng = FastSim(gp, router, batch_size=batch, precision=precision, device=dev)
        eng._build_switch(tile=tile)
        t = time.perf_counter()
        imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
        imgs, ids = imgs.cpu().numpy(), ids.cpu().numpy()
        dt = time.perf_counter() - t
        if imgs.shape != (n, 56, 30) or not np.isfinite(imgs).all() or imgs.min() < 0:
            fail(f"{precision}: served showers not finite/non-negative of shape ({n}, 56, 30)")
        a = np.log1p(imgs.sum(axis=(1, 2)))
        if ref_ids is None:
            ref_ids, b = ids, a
            log("12 float serves", f"int8 reference: {n} showers in {dt:.3f}s, showers per "
                f"expert {np.bincount(ids, minlength=3).tolist()}")
        else:
            rel = np.abs(a - b) / np.abs(b)
            same_ids = bool((ids == ref_ids).all())
            log("12 float serves", f"{precision}: {n} showers in {dt:.3f}s; routing identical "
                f"to int8 {same_ids}; max rel diff of per-shower log1p sums {rel.max():.4f} "
                f"(rtol 0.15)")
            if not same_ids or rel.max() > 0.15:
                fail(f"{precision} and int8 serving disagree")
        if dev.type == "cuda" and precision != "int8":
            serve_rate(eng, dev, n, batch, tile, card, seed, precision, "12 float serves")
        del eng


def gates(data, dev, rehearse, card):
    """Phase 13: the fidelity gate (``fidelity_torch.run_gate``) on the
    teacher at ``int8``, ``int8_pallas`` and ``int8_fused`` and on the w=0.125 student at
    ``int8``; every kernel count is set to 0 just before each gate and read
    just after; every launch of E must be on the bulk ring. Returns kernel
    E's launches and bulk-ring launches of the first gate (the teacher's
    ``int8``)."""
    import numpy as np
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.ops import epilogue_kernels as ek

    cond, real = data
    ch_real = ek.expm1_channel_sums(torch.as_tensor(real).to(dev))
    floor = ft.real_floor(ch_real)[0]
    log("13 gate", f"real-vs-real floor {floor:.4f} on {len(cond)} test showers (CPU test "
        f"anchor on the full split: {FLOOR_ANCHOR}; not a check here) [{card}]")
    wrappers = kernel_wrappers()
    runs = ([(STUDENT, "int8")] if rehearse
            else [(TEACHER, "int8"), (TEACHER, "int8_pallas"), (TEACHER, "int8_fused"),
                  (STUDENT, "int8")])
    e_launches = None
    for path, precision in runs:
        reset_counts(wrappers)
        t = time.perf_counter()
        rec = ft.run_gate(path, precision, dev, data=data, n_draws=1 if rehearse else ft.N_DRAWS)
        counts = read_counts(wrappers)
        print(json.dumps(rec), flush=True)
        log("13 gate", f"{os.path.basename(path)} {precision}: {time.perf_counter() - t:.2f}s, "
            f"value {rec['value']} x floor, vs_baseline {rec['vs_baseline']}; kernel launches "
            f"{counts} [{card}]")
        needs = ("expm1_channel_sums",) + (KERNEL_PATHS[precision] if precision in KERNEL_PATHS
                                           else ())
        if dev.type == "cuda" and min(counts[k] for k in needs) <= 0:
            fail(f"the {precision} gate did not launch each of its kernels {needs}: {counts}")
        e_bulk = counts["expm1_channel_sums on the bulk ring"]
        if dev.type == "cuda" and e_bulk != counts["expm1_channel_sums"]:
            fail(f"the {precision} gate ran kernel E off the bulk ring: {counts}")
        if not (np.isfinite(rec["value"]) and rec["vs_baseline"] >= 1.0):
            fail(f"the gate of {os.path.basename(path)} at {precision} did not pass: {rec}")
        if e_launches is None:
            e_launches = (counts["expm1_channel_sums"], e_bulk)
    return e_launches


def log1p_sums(imgs):
    """Per-shower ``log1p`` of the photon sum, numpy."""
    import numpy as np

    return np.log1p(imgs.sum(dim=(1, 2)).cpu().numpy())


def int8_rule(a, ref, ids, n_experts=3, quantile=INT8_QUANTILE, rtol=0.15, cap=INT8_CAP):
    """Phase 16's rule for a neutron student's ``int8`` serve against its
    ``f32`` serve (F5): per expert, the ``quantile`` of the per-shower
    relative difference of log1p sums within ``rtol``, and every shower
    within ``cap``. Returns the per-expert quantiles, the largest
    difference and the verdict."""
    import numpy as np

    rel = np.abs(a - ref) / np.abs(ref)
    qs = [float(np.quantile(rel[ids == e], quantile)) if (ids == e).any() else 0.0
          for e in range(n_experts)]
    worst = float(rel.max())
    return {"quantiles": qs, "max": worst, "ok": max(qs) <= rtol and worst <= cap}


def check_agrees(phase, what, imgs, ids, ref_sums, ref_ids, ref_name="the int8 switch serve",
                 quantile_rule=False):
    """The phase 8 rule: routing identical to the reference serve and
    per-shower log1p sums within rtol 0.15 of it; showers finite and >= 0.
    ``quantile_rule``: :func:`int8_rule` in place of the rtol on every
    shower (phase 16's neutron students)."""
    import numpy as np

    imgs_np = imgs.cpu().numpy()
    if not np.isfinite(imgs_np).all() or imgs_np.min() < 0:
        fail(f"{what}: served showers not finite and non-negative")
    a = log1p_sums(imgs)
    rel = float((np.abs(a - ref_sums) / np.abs(ref_sums)).max())
    same_ids = bool((ids.cpu().numpy() == ref_ids).all())
    if quantile_rule:
        r = int8_rule(a, ref_sums, ref_ids)
        ok = r["ok"]
        rule = (f"per expert {INT8_QUANTILE} quantiles "
                f"{', '.join(f'{q:.4f}' for q in r['quantiles'])} (rtol 0.15), max "
                f"{rel:.4f} (cap {INT8_CAP})")
    else:
        ok = rel <= 0.15
        rule = f"max rel diff of per-shower log1p sums {rel:.4f} (rtol 0.15)"
    log(phase, f"{what} vs {ref_name}: routing identical {same_ids}; {rule}")
    if not same_ids or not ok:
        fail(f"{what} and {ref_name} disagree")


def engine_conditions(rng, eng, n, rehearse):
    """Phase 15's conditions and noise: ``n`` N(0, 1) rows; in the rehearsal
    the first of 64 seeded candidates that ``eng``'s router sends to each
    expert (one shower per expert, the fewest that read them all)."""
    import numpy as np
    import torch

    cond = rng.standard_normal((64 if rehearse else n, 9), dtype="float32")
    noise = rng.standard_normal((len(cond), 10), dtype="float32")
    if rehearse:
        ids = eng._route(torch.as_tensor(cond).to(eng.device)).cpu().numpy()
        pick = [int(np.flatnonzero(ids == e)[0]) for e in range(eng.n_experts)]
        cond, noise = cond[pick], noise[pick]
    return cond, noise


def dyn_serves(trees, router, dev, cond, noise, batch, tile, ref, card, seed, profile):
    """Phase 15, the kernel paths through ``dyn_dispatch``: equal to the
    switch path on the same noise; on the card the CUDA graph of
    ``simulate_bulk`` equal to the eager dyn loop, both timed, and the
    per-tile weight gather's device time against a replayed chunk's.
    ``trees``: ``{precision: (generator tree, cfg)}``; a serve of the
    teacher is held to ``ref`` as well."""
    import torch

    from zdcsim_torch.inference.engine import FastSim, _take

    phase = "15 engine API"
    every = kernel_wrappers()
    n = len(cond)
    for precision, (gp, cfg) in trees.items():
        names = KERNEL_PATHS[precision]
        wrappers = {k: every[k] for k in names}
        eng = FastSim(gp, router, batch_size=batch, precision=precision, device=dev, cfg=cfg)
        eng._build_switch(tile=tile)
        sw, sw_ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
        eng._build_switch(tile=tile, dyn_dispatch=True)
        reset_counts(wrappers)
        dyn, dyn_ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
        counts = read_counts(wrappers)
        same = torch.equal(dyn, sw) and torch.equal(dyn_ids, sw_ids)
        k_tiles = batch // tile + eng.n_experts
        log(phase, f"{precision} dyn_dispatch{' (w=0.125 student)' if cfg else ''}, {n} showers, "
            f"batch {batch}, tile {tile} ({k_tiles} tiles a chunk): equal to the switch path "
            f"{same}; kernel launches {counts}")
        if not same:
            fail(f"{precision}: dyn_dispatch differs from the switch path")
        if dev.type == "cuda" and min(counts[k] for k in names) <= 0:
            fail(f"the {precision} dyn serve did not launch each of its kernels {names}")
        if cfg is None:
            check_agrees(phase, f"{precision} dyn", dyn, dyn_ids, *ref)
        if dev.type != "cuda":
            log(phase, f"{precision}: on the CPU simulate_bulk is the eager loop (the card "
                f"replays a CUDA graph)")
            continue

        def gen():
            return torch.Generator(device=dev).manual_seed(seed + 15)

        walls = {}
        for what, run in (("eager", lambda: eng.simulate_switch(cond, generator=gen())),
                          ("capture", lambda: eng.simulate_bulk(cond, generator=gen())),
                          ("graph", lambda: eng.simulate_bulk(cond, generator=gen()))):
            t = time.perf_counter()
            walls[what] = (run(), None)[0]
            torch.cuda.synchronize()
            walls[what + "_s"] = time.perf_counter() - t
        same = (torch.equal(walls["graph"], walls["eager"])
                and torch.equal(walls["capture"], walls["eager"]))
        graph = eng._graphs[(batch, tile)][0]
        chunk_ms = time_ms(graph.replay, 5)
        es = [torch.tensor(k % eng.n_experts, device=dev) for k in range(k_tiles)]
        gather_ms = graph_ms(lambda: [_take(eng._stacked, e) for e in es], 1)
        log(phase, f"{precision} simulate_bulk as a CUDA graph: equal to the eager dyn loop "
            f"{same}; {n} showers in {walls['graph_s']:.3f}s replayed ({n / walls['graph_s']:.1f} "
            f"showers/s; {walls['capture_s']:.3f}s with the warm-up and capture), "
            f"{walls['eager_s']:.3f}s eager ({n / walls['eager_s']:.1f} showers/s); a replayed "
            f"chunk {chunk_ms:.3f} ms on the card, of which the per-tile weight gather "
            f"({k_tiles} tiles, replayed alone) {gather_ms:.3f} ms ({100 * gather_ms / chunk_ms:.1f}%) "
            f"[{card}]")
        if not same:
            fail(f"{precision}: the CUDA graph of simulate_bulk differs from the eager dyn loop")
        if profile:
            for what, run in ((f"{precision} eager dyn serve of {n} showers",
                               lambda: eng.simulate_switch(cond, generator=gen())),
                              (f"{precision} graph-replayed serve of {n} showers",
                               lambda: eng.simulate_bulk(cond, generator=gen()))):
                per_kernel = profile_serve(run, what, card, phase)
                total = sum(v[1] for v in per_kernel.values())
                sel = sum(v[1] for k, v in per_kernel.items() if "indexSelect" in k)
                log(phase, f"{what}: index_select kernels (the weight gather"
                    f"{', and the column gather of kernel D' if precision == 'int8_pallas' else ''}) "
                    f"{100 * sel / total:.1f}% of device time [{card}]")
        del eng


def engine_api(gp, router, dev, rehearse, card, seed, profile=False):
    """Phase 15: the serving API beyond the switch path, on the teacher behind
    phase 8's seeded router (``dyn_serves``; the dense ``simulate`` on
    ``int8`` and ``int8_fused``; ``static_act_quant``; ``simulate_grouped``
    and ``simulate_stream``); then ``bench_torch.py``'s first rung at
    ``BENCH_SHOWERS``. The rehearsal serves the w=0.125 student on
    ``int8_pallas``'s dyn check and on grouped and stream dispatch."""
    import numpy as np
    import torch

    import bench_torch
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact

    phase = "15 engine API"
    n, batch, tile = REHEARSE_ENGINE if rehearse else ENGINE_SERVE
    eng8 = FastSim(gp, router, batch_size=batch, precision="int8", device=dev)
    eng8._build_switch(tile=tile)
    cond, noise = engine_conditions(np.random.default_rng([seed, 15]), eng8, n, rehearse)
    n = len(cond)
    ref8, ref_ids = eng8.simulate_switch(cond, noise=noise, return_experts=True)
    ref = (log1p_sums(ref8), ref_ids.cpu().numpy())
    log(phase, f"int8 switch serve (the reference): {n} showers, showers per expert "
        f"{np.bincount(ref[1], minlength=3).tolist()}")
    if np.bincount(ref[1], minlength=3).min() <= 0:
        fail("phase 15's conditions leave an expert unread")
    if rehearse:
        # the w=0.125 student where the teacher's width is not needed: the
        # CPU decodes the teacher at about 0.1 s a row
        gp_s, _, _, meta = load_serving_artifact(STUDENT)
        student = (gp_s, load_config([f"model.generator.width={float(meta['width'])}"]))
    # the rehearsal leaves out int8_fused (the teacher's width, about 1.2 s on
    # two threads), which tests/test_torch_engine_api.py holds on the CPU
    dyn_serves({"int8_pallas": student} if rehearse
               else {"int8_pallas": (gp, None), "int8_fused": (gp, None)},
               router, dev, cond, noise, batch, tile, ref, card, seed, profile)

    nd, dense_batch = REHEARSE_DENSE if rehearse else ENGINE_DENSE
    h = kernel_wrappers()["fused_decode"]
    for precision in ("int8", "int8_fused"):
        eng = FastSim(gp, router, batch_size=dense_batch, precision=precision, device=dev)
        h.launches = 0
        t = time.perf_counter()
        imgs, ids = eng.simulate(cond[:nd], noise=noise[:nd], return_experts=True)
        log(phase, f"{precision} dense simulate: {nd} showers in chunks of {dense_batch}, every "
            f"expert decoding each, in {time.perf_counter() - t:.3f}s; kernel H launches "
            f"{h.launches}")
        if dev.type == "cuda" and precision == "int8_fused" and h.launches <= 0:
            fail("the int8_fused dense path did not launch kernel H")
        check_agrees(phase, f"{precision} dense", imgs, ids, ref[0][:nd], ref[1][:nd])
        if dev.type == "cuda":
            stats = eng.throughput(n_batches=5, warmup=2,
                                   generator=torch.Generator(device=dev).manual_seed(seed))
            log(phase, f"{precision} dense throughput: {stats['showers_per_sec']:.1f} showers/s "
                f"(batch {dense_batch}, 5 batches) [{card}]")
        del eng

    # the calibration batch is cut to 1 row in the rehearsal (the CPU decodes
    # the full width at about 0.1 s a row)
    static_cls = type("FastSimSmallCal", (FastSim,), {"CAL_BATCH": 1}) if rehearse else FastSim
    t = time.perf_counter()
    eng_s = static_cls(gp, router, batch_size=batch, precision="int8", device=dev,
                       static_act_quant=True)
    eng_s._build_switch(tile=tile)
    scales = [{k: round(float(v), 6) for k, v in sc.items()} for sc in eng_s._act_scales]
    log(phase, f"static_act_quant on int8: calibrated on {eng_s.CAL_BATCH} + "
        f"{4 * eng_s.CAL_BATCH} rows an expert in {time.perf_counter() - t:.2f}s; "
        f"act_scale_headroom {eng_s.act_scale_headroom:.4f}; scales {scales}")
    stat = eng_s.simulate_switch(cond, noise=noise)
    rel = float(torch.linalg.norm(stat - ref8) / torch.linalg.norm(ref8).clamp(min=1e-6))
    log(phase, f"static serve vs the dynamic int8 serve: rel {rel:.4f} (< 0.15)")
    if rel >= 0.15:
        fail("the static-quant serve disagrees with the dynamic serve")
    if not rehearse:  # the CPU tests hold it (tests/test_torch_static_quant.py)
        eng_s._build_switch(tile=tile, dyn_dispatch=True)
        same = torch.equal(eng_s.simulate_switch(cond, noise=noise), stat)
        log(phase, f"static x dyn_dispatch equal to static x switch: {same}")
        if not same:
            fail("static x dyn_dispatch differs from static x switch")
    del eng_s

    if rehearse:
        # the student, and stream chunks of 1 row: the grouped buckets alone
        # hold 256 rows an expert
        (gp_g, cfg), g_batch = student, 1
    else:
        gp_g, cfg, g_batch = gp, None, batch
    eng_g = FastSim(gp_g, router, batch_size=g_batch, precision="int8", device=dev, cfg=cfg)
    # the rehearsal groups one shower: a bucket holds at least 256 rows
    ng = 1 if rehearse else n
    t = time.perf_counter()
    grouped, g_ids = eng_g.simulate_grouped(cond[:ng], noise=noise[:ng], return_experts=True)
    t_g = time.perf_counter() - t
    t = time.perf_counter()
    stream, s_ids = eng_g.simulate_stream(cond, noise=noise, return_experts=True)
    t_s = time.perf_counter() - t
    same_ids = bool((g_ids.numpy() == ref[1][:ng]).all() and (s_ids.numpy() == ref[1]).all())
    log(phase, f"simulate_grouped {t_g:.3f}s ({ng} showers), simulate_stream {t_s:.3f}s ({n} "
        f"showers; the float "
        f"Generator in bf16{', w=0.125 student' if rehearse else ''}): routing identical to the "
        f"switch serve {same_ids}")
    if not same_ids:
        fail("grouped or stream dispatch routed otherwise than the switch serve")
    if rehearse:
        check_agrees(phase, "simulate_stream", stream[:ng], s_ids[:ng], log1p_sums(grouped),
                     ref[1][:ng], "simulate_grouped")
    else:
        check_agrees(phase, "simulate_grouped", grouped, g_ids, *ref)
        check_agrees(phase, "simulate_stream", stream, s_ids, *ref)
    del eng_g

    rung = dict(bench_torch.ladder()[0])
    rung.update(REHEARSE_BENCH if rehearse else {"n_showers": BENCH_SHOWERS})
    res = bench_torch.run_rung(rung, dev, repeats=1 if rehearse else 3, seed=seed)
    peak = res["peak_bytes"]
    log(phase, f"bench_torch first rung {bench_torch.describe(rung)}: showers/s "
        + " ".join(f"{r:.1f}" for r in res["rates"]) + f", median {res['median']:.1f}; routing "
        f"{res['routing']}; peak device memory "
        + (f"{peak} bytes ({peak / 2**30:.3f} GiB)" if peak is not None else "not measured")
        + f" [{card}]")
    if profile and dev.type == "cuda":
        profile_bench_rung(rung, dev, card, seed)


def profile_bench_rung(rung, dev, card, seed):
    """Phase 15 with ``--profile``: one chunk of ``bench_torch.py``'s first
    rung (the w=0.125 student on ``int8``) eager through the dyn tile loop,
    then replayed from its CUDA graph, each under ``torch.profiler``."""
    import torch

    import bench_torch
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact

    gp_s, _, rp_s, meta = load_serving_artifact(os.path.join(HERE, rung["artifact"]))
    eng = FastSim(gp_s, rp_s, batch_size=rung["batch_size"], precision="int8", device=dev,
                  cfg=load_config([f"model.generator.width={float(meta['width'])}"]))
    eng._build_switch(tile=rung["tile"], dyn_dispatch=True)
    cond = torch.randn((rung["batch_size"], eng.cond_dim),
                       generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev)
    eng.simulate_bulk(cond, generator=gen)  # warm-up and capture
    what = f"bench_torch {bench_torch.describe(rung)}: one chunk of {rung['batch_size']} showers"
    profile_serve(lambda: eng.simulate_switch(cond, generator=gen), what + " eager",
                  card, "15 engine API")
    profile_serve(lambda: eng.simulate_bulk(cond, generator=gen), what + " replayed",
                  card, "15 engine API")


def neutron_batch_tree(rng, n_experts=3):
    """Phase 16's full-width ``GeneratorNeutron(norm="batch")`` tree, numpy
    in the Flax layout with experts stacked, and its ``gen_stats``, drawn
    from ``rng``: kernels N(0, 1 / fan-in), biases N(0, 0.1) (the output's
    plus 0.5, so that its ReLU passes pixels), BatchNorm scales 1 + N(0,
    0.1), running means N(0, 0.3) and variances 0.5 + U(0, 1)."""
    import numpy as np
    import torch

    from zdcsim_torch.convert import from_state_dict
    from zdcsim_torch.models.neutron import GeneratorNeutron
    from zdcsim_torch.utils.artifact import _flatten, _unflatten

    shapes = {k: tuple(v.shape) for k, v in GeneratorNeutron(norm="batch").state_dict().items()}
    trees, stats = [], []
    for _ in range(n_experts):
        sd = {}
        for k, shape in shapes.items():
            if k.endswith("running_mean"):
                v = 0.3 * rng.standard_normal(shape)
            elif k.endswith("running_var"):
                v = 0.5 + rng.random(shape)
            elif k.endswith("weight") and len(shape) > 1:
                v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            elif k.endswith("weight"):
                v = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                v = 0.1 * rng.standard_normal(shape) + (0.5 if k == "Conv_3.bias" else 0.0)
            sd[k] = torch.as_tensor(v.astype("float32"))
        st = {}
        trees.append(from_state_dict(sd, stats_out=st))
        stats.append(st)
    def stack(ts):
        flat = [_flatten(t) for t in ts]
        return _unflatten({k: np.stack([f[k] for f in flat]) for k in flat[0]})

    return stack(trees), {"batch_stats": stack(stats)}


def spread_router(rng, share=0.05):
    """The first router drawn from ``rng`` (:func:`seeded_router`) that sends
    every expert at least ``share`` of 4096 N(0, 1) probe conditions, drawn
    from ``rng`` before it: a router with zero biases drawn at random may
    leave an expert nearly unread."""
    import torch

    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.models.router import RouterNetwork

    probe = torch.as_tensor(rng.standard_normal((4096, 9), dtype="float32"))
    while True:
        router = seeded_router(rng)
        net = RouterNetwork(3)
        net.load_state_dict(to_state_dict(router))
        with torch.no_grad():
            counts = torch.bincount(net(probe)[1].argmax(-1), minlength=3)
        if counts.min().item() >= share * len(probe):
            return router


def neutron_rates(eng, dev, n, seed):
    """``throughput_bulk`` 3 times on ``n`` N(0, 1) conditions (the first
    warms up and captures), with the routing of those conditions and the
    peak device memory: ``(rates, median, spread, routing, peak bytes)``."""
    import statistics

    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    cond = torch.randn((n, eng.cond_dim), generator=torch.Generator(dev).manual_seed(seed),
                       device=dev)
    routing = torch.bincount(eng._route(cond), minlength=eng.n_experts).tolist()
    rates = [eng.throughput_bulk(n_showers=n, warmup=r == 0,
                                 generator=torch.Generator(dev).manual_seed(seed))
             ["showers_per_sec"] for r in range(3)]
    med = statistics.median(rates)
    peak = torch.cuda.max_memory_allocated(dev)
    return rates, med, (max(rates) - min(rates)) / med, routing, peak


def log_rates(phase, what, eng, dev, n, card, seed):
    rates, med, spread, routing, peak = neutron_rates(eng, dev, n, seed)
    log(phase, f"{what} throughput_bulk, {n} showers (batch {eng.batch_size}, tile {eng._tile}"
        f"{', a CUDA graph' if eng._dyn else ', the eager loop'}): showers/s "
        + " ".join(f"{r:.1f}" for r in rates) + f", median {med:.1f}, spread (max - min) / "
        f"median {spread:.4f}; routing {routing}; peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB) [{card}]")


def neutron_serves(dev, rehearse, card, seed, profile):
    """Phase 16, the serves: the neutron teacher (its module, ``bf16``) and
    both students (``int8``) through the dyn tile loop, replayed as a CUDA
    graph on the card, behind a router drawn from ``--seed``; then a
    full-width random ``norm="batch"`` tree folded on the device and served
    on ``int8``. Each: every expert decodes, showers finite, >= 0 and of
    shape [n, 44, 44], the graph ``torch.equal`` to the eager dyn loop,
    routing identical to an ``f32`` serve and per-shower log1p sums within
    rtol 0.15 of it (the students: ``int8_rule``), no decode kernel
    launched, rates and peak memory."""
    import numpy as np
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact

    phase = "16 neutron"
    rng = np.random.default_rng([seed, 16])
    router = spread_router(rng)
    wrappers = kernel_wrappers()
    cond = noise = None
    serves = [(name, *load_serving_artifact(path)) for name, path in NEUTRON.items()]
    serves.append(("random norm=batch tree, full width", *neutron_batch_tree(rng), None,
                   {"family": "neutron", "norm": "batch"}))
    for name, gp, gs, _, meta in serves:
        precision = "bf16" if name == "teacher" else "int8"
        n, batch, tile = (REHEARSE_NEUTRON if rehearse
                          else NEUTRON_SERVE["teacher" if "student" not in name else "student"])
        cfg = load_config(ft._artifact_model_config(meta))
        eng = FastSim(gp, router, batch_size=batch, precision=precision, device=dev, cfg=cfg,
                      gen_stats=gs)
        dyn = "norm=batch" not in name
        eng._build_switch(tile=tile, dyn_dispatch=dyn)
        if cond is None:  # one set for every serve, as many as the largest takes
            cond, noise = engine_conditions(
                rng, eng, max(v[0] for v in NEUTRON_SERVE.values()), rehearse)
        c, z = cond[:n], noise[:n]
        how = ("the module" if not eng.fast_neutron else
               "fast_neutron_apply, folded at build" if "norm=batch" in name else
               "fast_neutron_apply, prefolded")
        reset_counts(wrappers)
        t = time.perf_counter()
        imgs, ids = eng.simulate_bulk(c, noise=z, return_experts=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        used = torch.bincount(ids, minlength=3).tolist()
        log(phase, f"{name} {precision} ({how}; fast_neutron {eng.fast_neutron}, "
            f"uses_fast_path {eng.uses_fast_path}): {len(c)} showers, batch {batch}, tile "
            f"{tile}, {'dyn_dispatch' if dyn else 'switch'} in {dt:.3f}s; showers per expert "
            f"{used}; decode kernel launches {counts or 'none'}")
        if min(used) <= 0:
            fail(f"the {name} serve did not decode with every expert: {used}")
        if counts:
            fail(f"the neutron path launched the proton decode kernels: {counts}")
        imgs_np = imgs.cpu().numpy()
        if imgs_np.shape != (len(c), 44, 44) or not np.isfinite(imgs_np).all() or imgs_np.min() < 0:
            fail(f"{name}: served showers not finite/non-negative of shape ({len(c)}, 44, 44)")
        if dyn:
            eager, e_ids = eng.simulate_switch(c, noise=z, return_experts=True)
            same = bool(torch.equal(imgs, eager) and torch.equal(ids, e_ids))
            form = "a CUDA graph" if dev.type == "cuda" else "the eager loop on the CPU"
            log(phase, f"{name}: simulate_bulk ({form}) equal to the eager dyn loop: {same}")
            if not same:
                fail(f"{name}: the dyn graph differs from the eager dyn loop")
        ref = FastSim(gp, router, batch_size=batch, precision="f32", device=dev, cfg=cfg,
                      gen_stats=gs)
        ref._build_switch(tile=tile)
        r_imgs, r_ids = ref.simulate_switch(c, noise=z, return_experts=True)
        check_agrees(phase, f"{name} {precision}", imgs, ids, log1p_sums(r_imgs),
                     r_ids.cpu().numpy(), "the f32 serve", quantile_rule="student" in name)
        del ref, r_imgs
        if dev.type == "cuda":
            log_rates(phase, f"{name} {precision}", eng, dev, n, card, seed)
            if profile and name == "student_w0.125":
                eng.simulate_bulk(c[:batch], noise=z[:batch])  # the graph of one chunk
                what = f"neutron w=0.125 student int8: one chunk of {batch} showers, tile {tile}"
                profile_serve(lambda: eng.simulate_switch(c[:batch], noise=z[:batch]),
                              what + " eager", card, phase)
                profile_serve(lambda: eng.simulate_bulk(c[:batch], noise=z[:batch]),
                              what + " replayed", card, phase)
        del eng, imgs


def neutron_gates(dev, rehearse, card):
    """Phase 16, the gates: the neutron gate's test split (25600 synthetic
    neutron events, seed 7: 5120 real showers [5120, 44, 44]), kernel E on
    them against its plain version (rtol 1e-5) on the bulk ring, then
    ``fidelity_torch.run_gate`` on the two students and the teacher at
    ``int8``, counts set to 0 before each gate: a student fails unless
    ``vs_baseline >= 1.0`` under the teacher-relative rule; the teacher's
    record is informational. Returns ``(E's max abs err, its launches in
    the first gate, the real showers on the device)``."""
    import numpy as np
    import torch

    import fidelity_torch as ft
    from zdcsim_torch.config import load_config
    from zdcsim_torch.ops import epilogue_kernels as ek

    phase = "16 neutron"
    overrides = [*ft.GATE_OVERRIDES, *ft._artifact_model_config({"family": "neutron"})]
    if rehearse:
        overrides.append(f"dataset.synthetic_n_samples={REHEARSE_SPLIT}")
    t = time.perf_counter()
    cond, real = ft.gate_split(load_config(overrides))
    log(phase, f"neutron gate split in {time.perf_counter() - t:.2f}s: test cond {cond.shape}, "
        f"real {real.shape}")
    shown = real[:8] if rehearse else real
    xt = torch.as_tensor(shown).to(dev)
    k0 = ek.expm1_channel_sums.bulk_launches
    out, ref = ek.expm1_channel_sums(xt), ek.expm1_channel_sums_plain(xt)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rel, ok = within_rtol(out, ref, 1e-5)
    err = (out - ref).abs().max().item()
    on_bulk = ek.expm1_channel_sums.bulk_launches == k0 + 1
    ran = (f"on the bulk ring {on_bulk}" if dev.type == "cuda"
           else "plain version on the CPU; the card runs the bulk ring")
    log(phase, f"kernel E {list(xt.shape)} float32 -> {list(out.shape)}: max rel err {rel:.3e} "
        f"(rtol 1e-5: {ok}), max abs err {err:.3e} ({ran})")
    if not ok or not torch.isfinite(out).all():
        fail("kernel E disagrees with its plain version at the neutron gate's shape")
    if dev.type == "cuda" and not on_bulk:
        fail("kernel E at the neutron gate's shape did not run on the bulk ring")

    data = (cond[:REHEARSE_GATE], real[:REHEARSE_GATE]) if rehearse else (cond, real)
    wrappers = kernel_wrappers()
    e_launches = None
    for name in (("student_w0.125",) if rehearse
                 else ("student_w0.125", "student_w0.25", "teacher")):
        reset_counts(wrappers)
        t = time.perf_counter()
        rec = ft.run_gate(NEUTRON[name], "int8", dev, data=data,
                          n_draws=1 if rehearse else ft.N_DRAWS)
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        print(json.dumps(rec), flush=True)
        log(phase, f"gate of the neutron {name} int8: {time.perf_counter() - t:.2f}s, value "
            f"{rec['value']} x floor, vs_baseline {rec['vs_baseline']}, criterion "
            f"{rec['criterion']!r}; kernel launches {counts} [{card}]")
        e = counts.get("expm1_channel_sums", 0)
        if dev.type == "cuda" and (e <= 0 or counts.get("expm1_channel_sums on the bulk ring") != e
                                   or set(counts) - {"expm1_channel_sums",
                                                     "expm1_channel_sums on the bulk ring"}):
            fail(f"the neutron {name} gate ran kernels otherwise than E on the bulk ring: {counts}")
        if not np.isfinite(rec["value"]) or rec["family"] != "neutron":
            fail(f"the neutron {name} gate gave no finite value: {rec}")
        if "teacher_x_floor" in rec and not rec["vs_baseline"] >= 1.0:
            fail(f"the neutron {name} gate did not pass the teacher-relative rule: {rec}")
        if e_launches is None:
            e_launches = e
    return err, e_launches, xt


def time_neutron_e(xt, err, launches, card):
    """Kernel E at the neutron gate's [5120, 44, 44] f32 (phase 16), as
    phase 14 times its cases: replayed in a CUDA graph, the host loop, the
    direct body, the plain version, the library's ``expm1`` then the
    channel-basis matmul, and the bound. Returns the case."""
    import torch

    from zdcsim_torch.ops import epilogue_kernels as ek
    from zdcsim_torch.ops.channels import channel_basis

    b, h, w = xt.shape
    basis = torch.as_tensor(channel_basis((h, w)), device="cuda")
    fn = lambda **kw: ek.expm1_channel_sums(xt, **kw)  # noqa: E731
    bound_ms, bound_by = bound(b * h * w * 4 + b * 5 * 4, 2 * b * h * w, F32_OPS_PER_S)
    reps = []
    c = {"showers": b, "shape": [b, h, w], "dtype": "float32", "where": "neutron gate",
         "launches": launches, "max_abs_err": err, "graph_ms": graph_ms(fn, 50, reps),
         "replays_ms": reps, "eager_ms": time_ms(fn, 50),
         "old_body_ms": graph_ms(lambda: fn(_direct_body=True), 50),
         "plain_ms": time_ms(lambda: ek.expm1_channel_sums_plain(xt), 20),
         "library_ms": time_ms(lambda: torch.expm1(xt).reshape(b, h * w) @ basis, 20),
         "bound_ms": bound_ms, "bound_by": bound_by}
    log("16 neutron", f"expm1_channel_sums [{b}, {h}, {w}] float32 (the neutron gate's real "
        f"side): {c['graph_ms']:.4f} ms replayed in a CUDA graph, "
        f"{100 * bound_ms / c['graph_ms']:.1f}% of its bound {bound_ms:.4f} ms ({bound_by}); "
        f"host loop {c['eager_ms']:.4f} ms; direct body {c['old_body_ms']:.4f} ms; plain "
        f"{c['plain_ms']:.4f} ms; library {c['library_ms']:.4f} ms; {launches} launch a gate; "
        f"a call in each replay {fmt_replays(reps)} [{card}]")
    return c


def neutron(dev, rehearse, card, seed, profile=False):
    """Phase 16: the neutron family served and gated (``neutron_serves``,
    ``neutron_gates``); on the card kernel E's time at the gate's shape,
    returned as a case of E's record."""
    neutron_serves(dev, rehearse, card, seed, profile)
    err, launches, xt = neutron_gates(dev, rehearse, card)
    return time_neutron_e(xt, err, launches, card) if dev.type == "cuda" else None


def time_epilogues(e_counts, f_counts, errs, card):
    """Phase 14: kernels E and F at ``EF_TIME_ROWS`` showers of 56x30 in f32
    and bf16 (E also at the gate's 5120 in f32), replayed in a CUDA graph
    (a launch through the wrapper takes the host about as long as the bulk
    body takes the card), beside the host loop's time, the direct body
    forced on the same input (graph-replayed), their plain versions, the
    library's ``expm1``
    then the channel-basis matmul (F: the routed gather first) and the
    bound. ``e_counts``/``f_counts``: ``(launches, bulk-ring launches)`` of
    their main paths."""
    import torch

    from zdcsim_torch.ops import epilogue_kernels as ek
    from zdcsim_torch.ops.channels import channel_basis

    h, w = 56, 30
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.rand((EF_TIME_ROWS, h, w), generator=gen, device="cuda") * 5
    imgs = torch.rand((3, EF_TIME_ROWS, h, w), generator=gen, device="cuda") * 5
    ids = torch.randint(0, 3, (EF_TIME_ROWS,), generator=gen, device="cuda")
    basis = torch.as_tensor(channel_basis((h, w)), device="cuda")

    def e_case(xd):
        b = xd.shape[0]
        return (lambda **kw: ek.expm1_channel_sums(xd, **kw),
                lambda: ek.expm1_channel_sums_plain(xd),
                lambda: torch.expm1(xd.float()).reshape(b, h * w) @ basis,
                b * h * w * xd.element_size() + b * 5 * 4, b)

    def f_case(imd):
        b = imd.shape[1]
        rows = torch.arange(b, device="cuda")
        return (lambda **kw: ek.routed_expm1_channel_sums(imd, ids, **kw),
                lambda: ek.routed_expm1_channel_sums_plain(imd, ids),
                lambda: torch.expm1(imd[ids, rows].float()).reshape(b, h * w) @ basis,
                # each routed row read once, ids once, sums written once
                b * h * w * imd.element_size() + b * 8 + b * 5 * 4, b)

    cases = {"expm1_channel_sums": [], "routed_expm1_channel_sums": []}
    for dt in (torch.float32, torch.bfloat16):
        cases["expm1_channel_sums"].append((dt, e_case(x.to(dt))))
        cases["routed_expm1_channel_sums"].append((dt, f_case(imgs.to(dt))))
    cases["expm1_channel_sums"].append((torch.float32, e_case(x[:5120].contiguous())))
    clocks = "clocks.sm,clocks.mem,power.draw"
    log("14 epilogue times", f"{clocks} before the first case: {card_line(clocks)} [{card}]")
    rec = []
    for name, replaces, (launches, bulk), err in (
        ("expm1_channel_sums", "zdcsim/ops/pallas_kernels.py:103", e_counts, errs[0]),
        ("routed_expm1_channel_sums", "zdcsim/ops/pallas_kernels.py:62", f_counts, errs[1]),
    ):
        timed_cases = []
        for dt, (fn, plain, lib, n_bytes, b) in cases[name]:
            # expm1 and one add per pixel (the other channels' sums are not the work)
            bound_ms, bound_by = bound(n_bytes, 2 * b * h * w, F32_OPS_PER_S)
            reps = []
            c = {"showers": b, "dtype": str(dt)[6:], "graph_ms": graph_ms(fn, 50, reps),
                 "replays_ms": reps, "eager_ms": time_ms(fn, 50),
                 "old_body_ms": graph_ms(lambda: fn(_direct_body=True), 50),
                 "plain_ms": time_ms(plain, 20), "library_ms": time_ms(lib, 20),
                 "bound_ms": bound_ms, "bound_by": bound_by}
            timed_cases.append(c)
            log("14 epilogue times", f"{name} [{b}, {h}, {w}] {c['dtype']}: {c['graph_ms']:.4f} ms "
                f"replayed in a CUDA graph, {100 * bound_ms / c['graph_ms']:.1f}% of its bound "
                f"{bound_ms:.4f} ms ({bound_by}); host loop {c['eager_ms']:.4f} ms; direct body "
                f"{c['old_body_ms']:.4f} ms; plain {c['plain_ms']:.4f} ms; library "
                f"{c['library_ms']:.4f} ms; a call in each replay {fmt_replays(reps)} [{card}]")
        main = timed_cases[0]
        rec.append({"name": name, "route": "cuda",
                    "source": "zdcsim_torch/csrc/expm1_channel_sums.cu", "replaces": replaces,
                    "launches": launches, "max_abs_err": err, "ms": main["graph_ms"],
                    "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                    "body": "bulk ring" if bulk == launches else "direct",
                    "bulk_launches": bulk, "graph_ms": main["graph_ms"],
                    "eager_ms": main["eager_ms"], "old_body_ms": main["old_body_ms"],
                    "cases": timed_cases})
    # the first case again, last: a reading that depends on its place in the
    # phase shows here
    fn, b = cases["expm1_channel_sums"][0][1][0], EF_TIME_ROWS
    reps = []
    again = rec[0]["cases"][0]["graph_ms_again"] = graph_ms(fn, 50, reps)
    log("14 epilogue times", f"expm1_channel_sums [{b}, {h}, {w}] float32 again after the other "
        f"cases: {again:.4f} ms replayed in a CUDA graph; a call in each replay "
        f"{fmt_replays(reps)} [{card}]")
    log("14 epilogue times", f"{clocks} after: {card_line(clocks)} [{card}]")
    return rec


def fmt_replays(reps):
    """``graph_ms``'s replays as ms a call: the untimed ones (their count,
    the first 3 and the last) | the 5 timed ones."""
    warm, timed = reps[:-5], reps[-5:]
    return (f"{len(warm)} untimed " + " ".join(f"{r:.4f}" for r in warm[:3])
            + f" .. {warm[-1]:.4f} | " + " ".join(f"{r:.4f}" for r in timed))


# The float32 step on the card against the CPU's: Adam's moments are not held.
# The step's gradient jumps where a max pool's window holds near ties (the
# discriminator's first pool on the generator's ReLU zeros): the CPU's own step
# moves them by more than 1e-4 when its noise moves by 1e-6 (PERF.md, PR 14),
# and the card's float32 convs differ from the CPU's by about that much. In
# float64 the two are held on every check.
AGREE_F32 = ("metrics", "params", "sn_stats", "ema", "count")


def step_flops(run):
    """The floating-point operations of ``run()`` (matmuls and convs, forward
    and backward) as ``torch.utils.flop_counter`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run()
    return counter.get_total_flops()


def step_on(step, state, data, draws, device, dtype):
    """``step`` from ``state`` on ``data`` and ``draws`` with every tensor on
    ``device`` in ``dtype`` (the keep masks, tuples of them, stay bool);
    synchronised."""
    import torch

    move = lambda x: x.to(device, dtype)  # noqa: E731
    out = step(state.to(device, dtype), {k: move(v) for k, v in data.items()},
               {k: tuple(m.to(device) for m in v) if isinstance(v, tuple) else move(v)
                for k, v in draws.items()}, 0)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out


def output_leaves(out):
    """Every tensor of a train step's ``(state, metrics)`` by path."""
    state, metrics = out
    leaves = {f"metrics {k}": v for k, v in metrics.items()}
    leaves["step"] = state.step
    leaves.update({f"ema {k}": v for k, v in state.ema_gen_params.items()})
    for name in ("gen", "disc", "aux", "router"):
        c = getattr(state, name)
        leaves[f"{name} count"] = c.opt_state.count
        for tree, t in (("params", c.params), ("stats", c.stats), ("mu", c.opt_state.mu),
                        ("nu", c.opt_state.nu)):
            leaves.update({f"{name} {tree} {k}": v for k, v in t.items()})
    return leaves


def unequal_leaves(a, b):
    """The paths where two train steps' outputs are not ``torch.equal``."""
    import torch

    la, lb = output_leaves(a), output_leaves(b)
    return [k for k in la if not torch.equal(la[k], lb[k])]


def check_repeat(phase, what, a, b, card):
    """F1: two runs of one step from one state on one set of draws must be
    ``torch.equal`` leaf by leaf."""
    bad = unequal_leaves(a, b)
    log(phase, f"{what} run twice from one state: torch.equal leaf by leaf {not bad} "
        f"({len(output_leaves(a)) - len(bad)} of {len(output_leaves(a))} leaves equal) [{card}]")
    if bad:
        fail(f"{what} is not reproducible: {len(bad)} leaves differ, first {bad[:5]}")
    return not bad


def step_agreement(ref, ours, lrs):
    """How far one train step (``ours``: ``(state, metrics)``) is from a
    reference step on the same state and draws, at the CPU tests'
    tolerances (``tests/test_torch_train_step.py``): ``{check: {"ratio":
    worst error over tolerance, "at": where}}``, each ratio at most 1 to
    pass. Metrics rtol 1e-4 (the photon sums' std against the sums' mean);
    parameters ``2 lr``; Adam moments 1e-4 of relative norm error per
    leaf (a leaf under 1% of its component's norm against that 1%);
    spectral-norm stats 1e-4 per expert by norm; the EMA ``0.01 * 2 lr_g``;
    the parameters and the EMA each with ``2^-22`` of their size beside
    (float32's rounding of the update); ``count`` and ``step`` equal."""
    import torch

    (rs, rm), (s, m) = ref, ours
    cpu = lambda t: t.detach().to("cpu")  # noqa: E731
    worst = {}

    def note(what, err, tol, at):
        """The worst ``err / tol`` (0 where ``err`` is 0; a NaN counts as
        infinitely far)."""
        err, tol = torch.as_tensor(err), torch.as_tensor(tol)
        r = torch.where(err == 0, 0.0, err / tol).nan_to_num(nan=float("inf"))
        ratio = float(r.max())
        if what not in worst or ratio > worst[what]["ratio"]:
            worst[what] = {"ratio": ratio, "at": at}

    for k, v in rm.items():
        scale = cpu(v).abs()
        if k == "std_intensities_experts":
            scale = torch.maximum(scale, cpu(rm["mean_intensities_experts"]).abs())
        note("metrics", (cpu(m[k]) - cpu(v)).abs(), 1e-4 * scale, k)
    for name in ("gen", "disc", "aux", "router"):
        a, b = getattr(s, name), getattr(rs, name)
        for k in b.params:
            p = cpu(b.params[k])
            note("params", (cpu(a.params[k]) - p).abs(), 2 * lrs[name] + 2.0 ** -22 * p.abs(),
                 f"{name} {k}")
        for moment in ("mu", "nu"):
            ma, mb = getattr(a.opt_state, moment), getattr(b.opt_state, moment)
            total = float(sum(cpu(v).double().norm() ** 2 for v in mb.values())) ** 0.5
            for k in mb:
                scale = max(float(cpu(mb[k]).norm()), 1e-2 * total)
                note("moments", (cpu(ma[k]) - cpu(mb[k])).norm(), 1e-4 * scale,
                     f"{name} {moment} {k}")
        for k in b.stats:
            e = b.stats[k].shape[0]
            ref_k = cpu(b.stats[k]).reshape(e, -1)
            note("sn_stats", (cpu(a.stats[k]).reshape(e, -1) - ref_k).norm(dim=1),
                 1e-4 * ref_k.norm(dim=1), k)
        note("count", int(a.opt_state.count != b.opt_state.count), 0.0, name)
    for k in rs.ema_gen_params:
        e = cpu(rs.ema_gen_params[k])
        note("ema", (cpu(s.ema_gen_params[k]) - e).abs(), 0.02 * lrs["gen"] + 2.0 ** -22 * e.abs(),
             k)
    note("count", int(s.step != rs.step), 0.0, "step")
    return worst


def fmt_worst(worst):
    """:func:`step_agreement`'s record as ``{check: (ratio, where)}``."""
    return {k: (round(v["ratio"], 4), v["at"]) for k, v in worst.items()}


def check_step(old, new, metrics, batch_size, ema_decay):
    """The phase 17 checks of one step: every metric finite; each active
    expert's (``B_e > 1``) generator, discriminator and aux kernels moved
    and every leaf of an inactive one stayed; EMA equal to ``decay * ema +
    (1 - decay) * params``; each active expert's spectral-norm ``u`` of unit
    norm, and moved where it has more than one element (a layer of one
    output, ``SNDense_2``, has ``u = +-1`` after its first power step).
    Returns the active mask."""
    import torch

    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
    if bad:
        fail(f"non-finite metrics {bad}")
    active = (metrics["n_choosen_experts_mean_epoch"] * batch_size).round() > 1
    for name in ("gen", "disc", "aux"):
        a, b = getattr(new, name).params, getattr(old, name).params
        for k in a:
            changed = (a[k] != b[k]).flatten(1).any(dim=1)
            if bool((changed & ~active).any()):
                fail(f"{name} {k} moved on an inactive expert")
            if k.endswith(".weight") and a[k].ndim >= 3 and not bool(changed[active].all()):
                fail(f"{name} {k} did not move on every active expert ({active.tolist()})")
    for k, e in old.ema_gen_params.items():
        want = ema_decay * e + (1.0 - ema_decay) * new.gen.params[k]
        if not torch.allclose(new.ema_gen_params[k], want, rtol=1e-6, atol=1e-9):
            fail(f"EMA of {k} is not {ema_decay} * ema + {1 - ema_decay:.2f} * params")
    for k, u in new.disc.stats.items():
        if k.endswith("/u"):
            moved = (u != old.disc.stats[k]).flatten(1).any(dim=1)
            norm = u.flatten(1).norm(dim=1)
            if (u[0].numel() > 1 and not bool(moved[active].all())) or bool(moved[~active].any()):
                fail(f"spectral-norm {k} moved otherwise than on the active experts")
            if not bool(((norm[active] - 1).abs() < 1e-5).all()):
                fail(f"spectral-norm {k} is not of unit norm: {norm.tolist()}")
    return active


def train(split, dev, rehearse, card, seed, profile=False):
    """Phase 17: the proton family's dense train step (``zdcsim_torch.train``)
    on the gate's train side through ``DeviceLoader``: ``TRAIN`` steps, half
    at epoch 0 and half at epoch 1, with the checks of :func:`check_step`,
    each step's losses, routing and CUDA-synchronised wall time, the median
    of steps 2 onwards and the peak memory; then one step at
    ``TRAIN_CHECK`` on the card and on the CPU from one state and one set of
    draws, in float32 and float64, within the CPU tests' tolerances
    (:func:`step_agreement`; float32 without the moments, ``AGREE_F32``).
    With ``profile``, one more full-width step under ``torch.profiler``."""
    import numpy as np
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.data.loader import make_loaders, split_to_arrays
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train.state import init_state, make_optimizers
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    phase = "17 train"
    width, n_exp, batch, n_steps = REHEARSE_TRAIN if rehearse else TRAIN
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def setup(width, n_exp, batch, device, state_seed):
        cfg = load_config([f"model.generator.width={width}", f"model.n_experts={n_exp}",
                           f"train.batch_size={batch}", f"train.seed={seed}"])
        mods = build_moe(cfg)
        return cfg, mods, init_state(mods, cfg, state_seed, device), build_train_step(mods, cfg)

    t = time.perf_counter()
    cfg, mods, state, step = setup(width, n_exp, batch, dev, seed)
    sync()
    n_params = {n: sum(v[0].numel() if n != "router" else v.numel() for v in
                       getattr(state, n).params.values()) for n in ("gen", "disc", "aux", "router")}
    log(phase, f"proton MoE width {width}, E={n_exp}, batch {batch}: init_state on {dev.type} in "
        f"{time.perf_counter() - t:.2f}s; parameters an expert {n_params} (router shared); "
        f"matmul/conv precision {step.precision}")
    loader, _ = make_loaders(cfg, split, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wrappers = kernel_wrappers()
    reset_counts(wrappers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, routing, first = [], [], None
    plan = [0] * ((n_steps + 1) // 2) + [1] * (n_steps // 2)
    epochs = {ep: loader.epoch(ep) for ep in (0, 1)}
    for i, epoch in enumerate(plan):
        data = next(epochs[epoch])
        draws = draw_step_noise(gen, mods, batch, dev)
        sync()
        t = time.perf_counter()
        new, metrics = step(state, data, draws, epoch)
        sync()
        times.append(time.perf_counter() - t)
        active = check_step(state, new, metrics, batch, float(cfg.train.ema_decay))
        counts = (metrics["n_choosen_experts_mean_epoch"] * batch).round().int().tolist()
        routing.append(counts)
        losses = {k: round(float(v), 6) for k, v in metrics.items() if v.ndim == 0}
        log(phase, f"step {i + 1} (epoch {epoch}): {times[-1]:.4f}s, routing {counts} (active "
            f"{active.tolist()}), {losses}")
        if i == 0:
            rec_equal = check_repeat(phase, f"the first step (width {width}, batch {batch})",
                                     (new, metrics), step(state, data, draws, epoch), card)
        if rehearse and first is None:
            first = (new, metrics)
        state = new
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    if profile and dev.type == "cuda":
        profile_serve(lambda: step(state, data, draws, plan[-1]),
                      f"one dense step at width {width}, E={n_exp}, batch {batch}", card, phase)
    med = float(np.median(times[1:])) if len(times) > 1 else times[0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else None
    rec = {"width": width, "n_experts": n_exp, "batch": batch, "steps": len(times),
           "step_s": times, "median_step_s_from_2": med, "routing": routing,
           "peak_mem_gib": peak, "kernel_launches": counts, "precision": step.precision,
           "first_step_repeats_equal": rec_equal, "card": card}
    log(phase, f"{len(times)} steps, median of steps 2 onwards {med:.4f}s, peak memory "
        f"{'not measured on the CPU' if peak is None else f'{peak:.3f} GiB'}; kernel launches "
        f"{counts or 'none of A-H'} [{card}]")
    if dev.type == "cuda":  # one more step, counted (the counter's host cost is not timed)
        flops = step_flops(lambda: step(state, data, draws, plan[-1]))
        rec.update(tflop=flops / 1e12, bound_s=flops / F32_OPS_PER_S,
                   tflop_per_s=flops / med / 1e12)
        log(phase, f"{flops / 1e12:.2f} TFLOP a step (torch.utils.flop_counter): bound "
            f"{rec['bound_s']:.4f}s at the f32 peak, {rec['tflop_per_s']:.2f} TFLOP/s at the "
            f"median, {100 * rec['bound_s'] / med:.1f}% of the bound [{card}]")

    # the card against the CPU: one step from one state and one set of draws,
    # in float32 and in float64
    t = time.perf_counter()
    if rehearse:  # no card: the first step against itself runs the comparison
        width, n_exp, batch = REHEARSE_TRAIN[:3]
        pairs = [(torch.float32, first, first)]
    else:
        width, n_exp, batch = TRAIN_CHECK
        cfg, mods, state0, step = setup(width, n_exp, batch, "cpu", seed + 1)
        data = {k: torch.as_tensor(v[:batch]) for k, v in split_to_arrays(split, True).items()}
        draws = draw_step_noise(torch.Generator().manual_seed(seed + 1), mods, batch, "cpu")
        pairs = [(dt, step_on(step, state0, data, draws, "cpu", dt),
                  step_on(step, state0, data, draws, dev, dt))
                 for dt in (torch.float32, torch.float64)]
    rec["against_cpu"] = {"width": width, "n_experts": n_exp, "batch": batch}
    if not rehearse:
        rec["against_cpu"]["card_repeats_equal"] = check_repeat(
            phase, f"the float32 step at width {width}, batch {batch} on {dev.type}",
            pairs[0][2], step_on(step, state0, data, draws, dev, torch.float32), card)
    if not rehearse:  # what 1e-6 of noise does to the CPU's own float32 step
        z = draws["noise_1"]
        jitter = torch.randn(z.shape, generator=torch.Generator().manual_seed(seed + 2))
        moved = step_on(step, state0, data, {**draws, "noise_1": z * (1 + 1e-6 * jitter)},
                        "cpu", torch.float32)
        sens = step_agreement(pairs[0][1], moved, make_optimizers(cfg))
        rec["against_cpu"]["cpu_noise_1e-6"] = sens
        log(phase, f"the CPU's float32 step against itself with noise_1 moved by 1e-6 of its "
            f"size: {fmt_worst(sens)} [{card}]")
    for dtype, ref, ours in pairs:
        worst = step_agreement(ref, ours, make_optimizers(cfg))
        gated = AGREE_F32 if dtype == torch.float32 and not rehearse else tuple(worst)
        name = str(dtype)[6:]
        rec["against_cpu"][name] = worst
        how = " (no card: the first step against itself)" if rehearse else ""
        log(phase, f"one step at width {width}, E={n_exp}, batch {batch} in {name} on "
            f"{dev.type} against the CPU{how}: worst error / tolerance {fmt_worst(worst)}, held: "
            f"{', '.join(gated)} ({time.perf_counter() - t:.2f}s) [{card}]")
        bad = {k: worst[k] for k in gated if worst[k]["ratio"] > 1.0}
        if bad:
            fail(f"the {name} train step on {dev.type} disagrees with the CPU's: {bad}")
    print(json.dumps({"train": rec}), flush=True)
    return rec


SWITCH_METRICS = ("gen_loss", "disc_loss", "div_loss", "intensity_loss", "aux_reg_loss",
                  "router_loss", "gan_loss")
# phase 19's switch step against the dense step at full width: the share of
# the parameters' elements that may lie outside JAX's tolerance (read on an
# H100: 68 of 81337215, 8.4e-7), and the worst relative norm error of a leaf
# of Adam's first moments (read: 6.973e-3, a bias of the discriminator)
SWITCH_BEYOND_SHARE = 1e-5
SWITCH_MU_RTOL = 2e-2


def switch_against_dense(dense, switch, lrs):
    """The switch step against the dense step from one state on one set of
    draws: metrics at JAX's rtol 2e-4 / atol 1e-5
    (``tests/test_train_step.py:237-281``) as worst error over tolerance,
    and the shares equal; ``beyond_jax_tol``, the elements of the
    parameters outside JAX's rtol 2e-3 / atol 2e-5, of which at most
    ``SWITCH_BEYOND_SHARE`` may be, each within ``2 lr`` (``params``, worst
    error over ``2 lr``): Adam moves a parameter whose gradient is zero up
    to rounding by about ``lr`` to one side or the other, whichever way the
    two steps' sums round (JAX's test runs tiny modules, whose gradients
    have no such elements); and ``mu``, Adam's first moments (the
    gradients) leaf by leaf, the worst relative norm error as
    ``tests/test_torch_switch_step.py::test_switch_state_matches_jax``
    takes it (a leaf under 1% of its component's norm against that 1%),
    which must be at most ``SWITCH_MU_RTOL``. The spectral-norm stats
    differ by design (the switch step's power iteration takes 2 steps, the
    dense step's 4), and with them the discriminator's gradients a
    little."""
    import torch

    (sd, md), (ss, ms) = dense, switch
    worst = {k: (0.0, None) for k in ("metrics", "params", "mu")}
    beyond, total = 0, 0

    def note(what, r, at):
        if r > worst[what][0]:
            worst[what] = (r, at)

    for k in SWITCH_METRICS:
        note("metrics", float(((ms[k] - md[k]).abs() / (1e-5 + 2e-4 * md[k].abs())).max()), k)
    for name in ("gen", "disc", "aux", "router"):
        a, b = getattr(ss, name), getattr(sd, name)
        for k in b.params:
            err = (a.params[k] - b.params[k]).abs()
            beyond += int((err > 2e-5 + 2e-3 * b.params[k].abs()).sum())
            total += err.numel()
            note("params", float(err.max()) / (2 * lrs[name]), f"{name} {k}")
        mu_a, mu_b = a.opt_state.mu, b.opt_state.mu
        norm = float(sum(v.double().norm() ** 2 for v in mu_b.values())) ** 0.5
        for k in mu_b:
            note("mu", float((mu_a[k] - mu_b[k]).double().norm())
                 / max(float(mu_b[k].double().norm()), 1e-2 * norm), f"{name} {k}")
    worst["beyond_jax_tol"] = (beyond, total)
    worst["shares_equal"] = bool(torch.equal(md["n_choosen_experts_mean_epoch"],
                                             ms["n_choosen_experts_mean_epoch"]))
    return worst


def options(split, dev, rehearse, card, seed, profile=False):
    """Phase 19: the switch step, bf16 and ``fast_generator`` at ``SWITCH``
    (see the module docstring), then the switch step at ``TRAIN_CHECK`` on
    the card against the CPU. With ``profile``, one more step of each bf16
    variant under ``torch.profiler``."""
    import numpy as np
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.data.loader import split_to_arrays
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train.state import init_state, make_optimizers
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    phase = "19 options"
    width, n_exp, batch, tile = REHEARSE_SWITCH if rehearse else SWITCH
    runs = 0 if rehearse else STEP_RUNS
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def build(*over, width=width, n_exp=n_exp, batch=batch):
        cfg = load_config([f"model.generator.width={width}", f"model.n_experts={n_exp}",
                           f"train.batch_size={batch}", f"train.seed={seed}",
                           "model.router.differentiable_gan_term=false", *over])
        mods = build_moe(cfg)
        return cfg, mods, build_train_step(mods, cfg)

    # the rehearsal leaves out the remat (its first call imports torch._dynamo)
    switch_over = ("train.dispatch=switch", f"train.dispatch_tile={tile}",
                   f"train.dispatch_remat={not rehearse}")
    cfg, mods, dense = build()
    data = {k: torch.as_tensor(v[:batch]).to(dev)
            for k, v in split_to_arrays(split, True).items()}
    rows = draw_step_noise(torch.Generator(device=dev).manual_seed(seed + 4), mods, batch, dev,
                           switch=True)
    # the dense step's keep masks: each row's own in its routed expert's row
    per_expert = {**rows, "aux_keep": tuple(k[None].expand(n_exp, *k.shape)
                                            for k in rows["aux_keep"])}
    state = init_state(mods, cfg, seed + 3, dev)
    variants = {"switch f32": (build(*switch_over)[2], rows)}
    if not rehearse:  # the rehearsal holds the switch step against itself
        state, _ = dense(state, data, per_expert, 0)
        sync()
        variants.update({
            "dense f32": (dense, per_expert),
            "switch bf16": (build(*switch_over, "train.precision=bf16")[2], rows),
            "dense bf16": (build("train.precision=bf16")[2], per_expert),
            "dense fast_generator": (build("train.fast_generator=true")[2], per_expert),
        })
    wrappers = kernel_wrappers()
    reset_counts(wrappers)
    rec, outs = {"width": width, "n_experts": n_exp, "batch": batch, "tile": tile,
                 "card": card}, {}
    for name, (step, draws) in variants.items():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        times, last = [], []
        for _ in range(1 + runs):
            sync()
            t = time.perf_counter()
            out = step(state, data, draws, 0)
            sync()
            times.append(time.perf_counter() - t)
            last = (last + [out])[-2:]
        if runs:
            check_repeat(phase, name, *last, card)
        bad = [k for k, v in out[1].items() if not bool(torch.isfinite(v).all())]
        if bad:
            fail(f"{name}: non-finite metrics {bad}")
        med = float(np.median(times[1:] or times))
        r = {"step_s": times, "median_step_s": med, "repeats_equal": bool(runs) or None,
             "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                              if dev.type == "cuda" else None),
             "precision": step.precision["train.precision"], "switch": step.switch}
        if dev.type == "cuda":  # one more step, counted
            flops = step_flops(lambda: step(state, data, draws, 0))
            r.update(tflop=flops / 1e12, tflop_per_s=flops / med / 1e12)
            if profile and name.endswith("bf16"):
                profile_serve(lambda: step(state, data, draws, 0),
                              f"one {name} step at width {width}, E={n_exp}, batch {batch}",
                              card, phase)
        rec[name] = r
        outs[name] = out
        log(phase, f"{name}: median of {runs} {med:.4f}s (warm run {times[0]:.4f}s), peak "
            + ("not measured on the CPU" if r["peak_mem_gib"] is None else
               f"{r['peak_mem_gib']:.3f} GiB")
            + (f", {r['tflop']:.2f} TFLOP ({r['tflop_per_s']:.2f} TFLOP/s)" if "tflop" in r else "")
            + f"; gen_loss {float(out[1]['gen_loss']):.6f}, disc_loss "
            f"{float(out[1]['disc_loss']):.6f} [{card}]")
        del out, last
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    rec["kernel_launches"] = counts
    log(phase, f"kernel launches {counts or 'none of A-H'}")
    if counts:
        fail(f"the train steps launched hand-written kernels: {counts}")

    agree = switch_against_dense(outs.get("dense f32", outs["switch f32"]), outs["switch f32"],
                                 make_optimizers(cfg))
    rec["switch_against_dense"] = agree
    n, total = agree["beyond_jax_tol"]
    ref = "dense f32 (constant GAN term)" if "dense f32" in outs else "itself (no card)"
    log(phase, f"switch f32 against {ref}: worst error / tolerance "
        f"{ {k: agree[k] for k in ('metrics', 'params')} }; parameters beyond JAX's "
        f"tolerance {n} of {total} ({n / total:.3e}, at most {SWITCH_BEYOND_SHARE:.0e}), each "
        f"within 2 lr; Adam's first moments' worst relative norm error {agree['mu'][0]:.3e} at "
        f"{agree['mu'][1]} (at most {SWITCH_MU_RTOL:.0e}); shares equal {agree['shares_equal']}")
    if (agree["metrics"][0] > 1 or agree["params"][0] > 1 or n > SWITCH_BEYOND_SHARE * total
            or agree["mu"][0] > SWITCH_MU_RTOL or not agree["shares_equal"]):
        fail(f"the switch step disagrees with the dense step: {agree}")
    for lo, hi in (("dense bf16", "dense f32"), ("switch bf16", "switch f32")):
        if lo not in outs:  # the rehearsal
            continue
        a, b = float(outs[lo][1]["disc_loss"]), float(outs[hi][1]["disc_loss"])
        ok = abs(a - b) <= 0.05 + 0.1 * abs(b)
        rec[f"{lo} disc_loss against f32"] = (a, b)
        log(phase, f"{lo} disc_loss {a:.6f} against {hi}'s {b:.6f}: within rtol 0.1 / atol "
            f"0.05 {ok}")
        if not ok:
            fail(f"{lo}'s disc_loss is not within rtol 0.1 / atol 0.05 of {hi}'s")
    # the switch step on the card against the CPU, as phase 17 holds the dense one
    t = time.perf_counter()
    if rehearse:  # no card: the switch step against itself runs the comparison
        pairs = [(torch.float32, outs["switch f32"], outs["switch f32"])]
    else:
        del outs
        width, n_exp, batch = TRAIN_CHECK
        cfg, mods, step = build("train.dispatch=switch", f"train.dispatch_tile={CHECK_TILE}",
                                width=width, n_exp=n_exp, batch=batch)
        state0 = init_state(mods, cfg, seed + 1, "cpu")
        data = {k: torch.as_tensor(v[:batch]) for k, v in split_to_arrays(split, True).items()}
        draws = draw_step_noise(torch.Generator().manual_seed(seed + 1), mods, batch, "cpu",
                                switch=True)
        pairs = [(dt, step_on(step, state0, data, draws, "cpu", dt),
                  step_on(step, state0, data, draws, dev, dt))
                 for dt in (torch.float32, torch.float64)]
    rec["against_cpu"] = {"width": width, "n_experts": n_exp, "batch": batch}
    for dtype, ref, ours in pairs:
        worst = step_agreement(ref, ours, make_optimizers(cfg))
        gated = AGREE_F32 if dtype == torch.float32 and not rehearse else tuple(worst)
        name = str(dtype)[6:]
        rec["against_cpu"][name] = worst
        how = " (no card: the step against itself)" if rehearse else ""
        log(phase, f"one switch step at width {width}, E={n_exp}, batch {batch} in {name} on "
            f"{dev.type} against the CPU{how}: worst error / tolerance {fmt_worst(worst)}, "
            f"held: {', '.join(gated)} ({time.perf_counter() - t:.2f}s) [{card}]")
        bad = {k: worst[k] for k in gated if worst[k]["ratio"] > 1.0}
        if bad:
            fail(f"the {name} switch step on {dev.type} disagrees with the CPU's: {bad}")
    print(json.dumps({"options": rec}), flush=True)
    return rec


class TimeSplits(logging.Handler):
    """Collects the loop's ``epoch <n> time split`` records
    (``zdcsim_torch/train/loop.py``): ``{epoch: {part: seconds}}``."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.splits = {}

    def emit(self, record):
        if "time split" in str(record.msg):
            epoch, times = record.args
            self.splits[epoch] = dict(times)


def checked_evaluator(evals, states, dev):
    """A stand-in for the loop's ``build_evaluator``: the loop's evaluator
    (kernel E with ``eval.fused_epilogue``), timed and counted, then the
    same evaluation with the plain epilogue on the same state and a replay
    of the same draws; each record goes to ``evals``, and a host copy of
    each evaluated state (the state its epoch's checkpoint saves) to
    ``states``."""
    import dataclasses

    import numpy as np
    import torch

    from zdcsim_torch.ops import epilogue_kernels as ek
    from zdcsim_torch.train.checkpoint import host_copy
    from zdcsim_torch.train.evaluate import build_evaluator

    e = ek.expm1_channel_sums
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def build(modules, cfg, chunk_size=None):
        fused = build_evaluator(modules, cfg, chunk_size)
        plain = build_evaluator(modules, dataclasses.replace(
            cfg, eval=dataclasses.replace(cfg.eval, fused_epilogue=False)), chunk_size)

        def evaluate(state, arrays, epoch, generator=None, **kw):
            draws = generator.get_state()
            launches, bulk = e.launches, e.bulk_launches
            sync()
            t = time.perf_counter()
            m = fused(state, arrays, epoch, generator, **kw)
            sync()
            rec = {"epoch": epoch, "eval_s": time.perf_counter() - t,
                   "E_launches": e.launches - launches, "E_on_bulk_ring": e.bulk_launches - bulk}
            replay = torch.Generator(device=dev)
            replay.set_state(draws)
            mp = plain(state, arrays, epoch, replay, **kw)
            rec.update(ws_mean=m["ws_mean"], ws_mean_plain=mp["ws_mean"],
                       rel=abs(m["ws_mean"] - mp["ws_mean"]) / abs(mp["ws_mean"]),
                       routing=m["eval_expert_counts"].tolist(),
                       routing_identical=bool(np.array_equal(m["eval_expert_counts"],
                                                             mp["eval_expert_counts"])
                                              and m.get("router_accuracy")
                                              == mp.get("router_accuracy")))
            evals.append(rec)
            states[epoch] = host_copy(state)
            return m

        return evaluate

    return build


def loop(dev, rehearse, card, seed, keep_run=False):
    """Phase 18: the training loop (``zdcsim_torch.train.loop.train``) at
    ``LOOP`` on a synthetic split of its own (seed 7): 2 epochs, an eval each
    epoch on kernel E, the split and the checkpoints saved (every eval under
    the threshold, ``keep_best`` 1, async) under a temporary directory
    removed at the end. Fails unless each eval launched E on the bulk ring
    and agrees with the plain epilogue on the same state and draws (rel
    1e-4, routing identical), keep_best left the checkpoint of the lower
    ``ws_mean`` alone on disk, the restored checkpoint equals the evaluated
    state bit for bit, a resume from it trains from its epoch with finite
    losses, ``FastSim.from_checkpoint`` serves it on ``int8``,
    ``int8_pallas`` (A-D) and ``int8_fused`` (H) behind a router drawn from
    ``--seed`` in agreement with ``int8``, and the CLI's ``--eval
    --checkpoint-epoch`` prints the evaluator's keys. Prints each epoch's
    seconds of steps, metrics sync, eval and callbacks, a synchronous
    checkpoint write's, and the peak memory. With ``keep_run`` the temporary
    directory stays (``rec["tmp"]``; phase 21 gates the run directory,
    ``rec["run_dir"]``, and removes it)."""
    import contextlib
    import io
    import logging
    import shutil
    import tempfile

    import numpy as np
    import torch

    import zdcsim_torch.train.loop as loop_mod
    from zdcsim_torch.cli import main as cli_main
    from zdcsim_torch.config import load_config
    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.train.checkpoint import (
        CKPT_PREFIX, host_copy, restore_checkpoint, save_checkpoint)

    phase = "18 loop"
    width, n_exp, batch, n_events = REHEARSE_LOOP if rehearse else LOOP
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tmp = tempfile.mkdtemp(prefix="zdcsim_loop_")
    data = [f"model.generator.width={width}", f"model.n_experts={n_exp}",
            f"train.batch_size={batch}", "dataset.synthetic=true",
            f"dataset.synthetic_n_samples={n_events}", "train.seed=7", "eval.fused_epilogue=true",
            f"train.save_experiments_dir={tmp}/"]
    rec = {"width": width, "n_experts": n_exp, "batch": batch, "events": n_events, "card": card}
    wrappers = kernel_wrappers()
    try:
        # -- the loop: 2 epochs, an eval and a checkpoint each ----------------
        cfg = load_config([*data, "train.epochs=2", "train.eval_every=1", "config.run_name=smoke",
                           "train.save_experiment_data=true", "train.ws_threshold_model_save=1e30",
                           "train.checkpoint_keep_best=1", "train.async_checkpointing=true"])
        evals, states = [], {}
        splits = TimeSplits()
        logger = logging.getLogger(loop_mod.__name__)
        level = logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(splits)
        build = loop_mod.build_evaluator
        loop_mod.build_evaluator = checked_evaluator(evals, states, dev)
        reset_counts(wrappers)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            history, state = loop_mod.train(cfg, return_state=True, device=dev)
            sync()
        finally:
            loop_mod.build_evaluator = build
            logger.removeHandler(splits)
            logger.setLevel(level)
        rec["train_s"] = time.perf_counter() - t
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
        rec["kernel_launches"] = counts
        rec["epochs"] = []
        for h, ev in zip(history, evals):
            ep = h["epoch"]
            times = {**splits.splits.get(ep, {}), "eval_fused": ev["eval_s"]}
            rec["epochs"].append({"epoch": ep, "times_s": times, **{k: h[k] for k in (
                "gen_loss", "disc_loss", "router_loss", "ws_mean")}, "eval": ev})
            log(phase, f"epoch {ep}: steps {times.get('steps', float('nan')):.4f}s, metrics sync "
                f"{times.get('sync', float('nan')):.4f}s, eval {ev['eval_s']:.4f}s (E, the loop's "
                f"eval with its plain comparison {times.get('eval', float('nan')):.4f}s), callbacks "
                f"{times.get('callbacks', float('nan')):.4f}s (the checkpoint's host copy, async "
                f"write); gen_loss {h['gen_loss']:.4f}, disc_loss {h['disc_loss']:.4f}, ws_mean "
                f"{h['ws_mean']:.4f} [{card}]")
            log(phase, f"epoch {ep} eval: E launched {ev['E_launches']} times, "
                f"{ev['E_on_bulk_ring']} on the bulk ring; ws_mean {ev['ws_mean']!r} against "
                f"{ev['ws_mean_plain']!r} with the plain epilogue (rel {ev['rel']:.3e}, limit "
                f"1e-4); routing {ev['routing']}, identical {ev['routing_identical']}")
            if cuda and (ev["E_launches"] < 1 or ev["E_on_bulk_ring"] != ev["E_launches"]):
                fail(f"epoch {ep}'s eval did not launch E on the bulk ring: {ev}")
            if not (ev["rel"] <= 1e-4 and ev["routing_identical"]):
                fail(f"epoch {ep}'s eval on kernel E disagrees with the plain epilogue: {ev}")
            if not all(np.isfinite(h[k]) for k in ("gen_loss", "disc_loss", "ws_mean")):
                fail(f"epoch {ep}: non-finite losses {h}")
        if [h["epoch"] for h in history] != [0, 1] or len(evals) != 2:
            fail(f"the loop ran epochs {[h['epoch'] for h in history]}, evals {len(evals)}")
        peak = "not measured on the CPU" if not cuda else f"{rec['peak_mem_gib']:.3f} GiB"
        log(phase, f"train() of 2 epochs in {rec['train_s']:.2f}s; kernel launches {counts}; "
            f"peak memory {peak} [{card}]")
        if counts.get("expm1_channel_sums", 0) != sum(ev["E_launches"] for ev in evals):
            fail(f"E launched outside the evals: {counts}")
        # -- keep_best, restore ------------------------------------------------
        exp_dir = cfg.config.experiment_dir
        models = f"{exp_dir}/models"
        kept = min(history, key=lambda h: h["ws_mean"])["epoch"]
        on_disk = sorted(int(d[len(CKPT_PREFIX):]) for d in os.listdir(models)
                         if d.startswith(CKPT_PREFIX))
        rec.update(kept=kept, on_disk=on_disk)
        log(phase, f"checkpoints on disk {on_disk}: keep_best=1 kept epoch {kept} (the lower "
            f"ws_mean) and deleted epoch {1 - kept}; the epoch-0 checkpoint deleted: "
            f"{0 not in on_disk}")
        if on_disk != [kept]:
            fail(f"keep_best=1 left {on_disk}, not [{kept}]")
        restored = restore_checkpoint(models, kept, state)
        flat, saved = host_copy(restored), states[kept]
        same = set(flat) == set(saved) and all(
            flat[k].dtype == saved[k].dtype and torch.equal(flat[k], saved[k]) for k in flat)
        log(phase, f"restored checkpoint of epoch {kept}: {len(flat)} tensors, "
            f"{sum(v.numel() * v.element_size() for v in flat.values()) / 2 ** 30:.3f} GiB, "
            f"torch.equal to the evaluated state {same}; step {int(restored.step)}")
        if not same:
            fail("the restored checkpoint differs from the state it saved")
        if cuda:  # the time of one write, as the loop makes it without async_checkpointing
            sync()
            t = time.perf_counter()
            path = save_checkpoint(os.path.join(tmp, "timing"), kept, restored)
            rec["checkpoint_write_s"] = time.perf_counter() - t
            rec["checkpoint_bytes"] = os.path.getsize(os.path.join(path, "state.pt"))
            shutil.rmtree(os.path.join(tmp, "timing"), ignore_errors=True)
            log(phase, f"one synchronous checkpoint write (host copy + torch.save of "
                f"{rec['checkpoint_bytes']} bytes): {rec['checkpoint_write_s']:.4f}s [{card}]")
        del state, restored, flat, saved, states
        if cuda:
            torch.cuda.empty_cache()

        # -- resume from the kept epoch -----------------------------------------
        cfg2 = load_config([*data, "train.epochs=2", f"train.checkpoint_experiment_dir={exp_dir}",
                            f"train.epoch_to_load={kept}", "config.run_name=resumed"])
        t = time.perf_counter()
        history2 = loop_mod.train(cfg2, device=dev)
        ran = [h["epoch"] for h in history2]
        log(phase, f"resumed from epoch {kept}: trained epochs {ran} in "
            f"{time.perf_counter() - t:.2f}s, gen_loss "
            f"{[round(h['gen_loss'], 4) for h in history2]}, ws_mean "
            f"{[round(h['ws_mean'], 4) for h in history2]}")
        if ran != list(range(kept, 2)) or not all(
                np.isfinite(h[k]) for h in history2 for k in ("gen_loss", "disc_loss")):
            fail(f"the resume from epoch {kept} ran {ran}: {history2}")
        rec["resumed_epochs"] = ran

        # -- serve the checkpoint --------------------------------------------------
        n, serve_batch, tile = REHEARSE_LOOP_SERVE if rehearse else LOOP_SERVE
        rng = np.random.default_rng([seed, 18])
        cond = rng.standard_normal((n, 9), dtype="float32")
        noise = rng.standard_normal((n, 10), dtype="float32")
        router = to_state_dict(seeded_router(rng, n_exp))
        ref = None
        rec["serves"] = {}
        for precision in ("int8", "int8_pallas") + (() if rehearse else ("int8_fused",)):
            names = KERNEL_PATHS.get(precision, ())
            eng = FastSim.from_checkpoint(cfg, models, kept, precision=precision,
                                          batch_size=serve_batch, device=dev)
            eng.router.load_state_dict(router)
            eng._build_switch(tile=tile)
            reset_counts(wrappers)
            t = time.perf_counter()
            imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
            sync()
            dt = time.perf_counter() - t
            c = {k: v for k, v in read_counts(wrappers).items() if v}
            used = torch.bincount(ids, minlength=n_exp).tolist()
            rec["serves"][precision] = {"launches": c, "routing": used, "s": dt}
            log(phase, f"FastSim.from_checkpoint(epoch {kept}) {precision}: {n} showers in "
                f"{dt:.3f}s, routing {used}, kernel launches {c or 'none'} [{card}]")
            if tuple(imgs.shape) != (n, *eng.image_shape):
                fail(f"{precision}: served shape {tuple(imgs.shape)}")
            if cuda and min((c.get(k, 0) for k in names), default=1) <= 0:
                fail(f"the {precision} serve of the checkpoint did not launch {names}: {c}")
            if ref is None:
                imgs_np = imgs.cpu().numpy()
                if not np.isfinite(imgs_np).all() or imgs_np.min() < 0:
                    fail("int8: served showers not finite and non-negative")
                ref = (log1p_sums(imgs), ids.cpu().numpy())
            else:
                check_agrees(phase, f"{precision} from the checkpoint", imgs, ids, *ref,
                             ref_name="its int8 serve")
            del eng, imgs, ids

        # -- the CLI twin -------------------------------------------------------------
        out = io.StringIO()
        argv = ["--eval", "--checkpoint-epoch", str(kept), "--override", *data,
                f"train.checkpoint_experiment_dir={exp_dir}"] + (["--cpu"] if rehearse else [])
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        printed = json.loads(out.getvalue().strip().splitlines()[-1])
        log(phase, f"cli_torch.py {' '.join(argv[:3])} ...: exit {rc} in "
            f"{time.perf_counter() - t:.2f}s, printed {sorted(printed)}; ws_mean "
            f"{printed.get('ws_mean')!r}")
        if rc != 0 or set(printed) != EVAL_KEYS:
            fail(f"the CLI's --eval printed {sorted(printed)}, not the evaluator's keys")
        rec.update(run_dir=exp_dir, tmp=tmp)
    finally:
        if not keep_run:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"loop": rec}), flush=True)
    return rec


def stats_moved(old, new, active, what):
    """Fail unless each BatchNorm running statistic of ``new`` (the
    generator's or the aux regressor's ``stats``) moved from ``old`` on every
    active expert and stayed on every inactive one."""
    import torch

    for k, v in new.items():
        moved = (v != old[k]).flatten(1).any(dim=1)
        if not bool(moved[active].all()) or bool(moved[~active].any()):
            fail(f"{what} running statistic {k} moved on experts {moved.tolist()}, active "
                 f"{active.tolist()}")


def switch_draws_as_dense(rows, n_exp, batch):
    """Draws on which the switch step and the dense step compute the same
    thing: the switch G phase's first B rows on the D phase's masks (the
    dense step draws the D phase and the G phase's first forward on one
    key), and the dense masks each row's own in its routed expert's row.
    Returns ``(switch draws, dense draws)``."""
    import torch

    rows = {**rows, "gen_keep_2": tuple(torch.cat([a, b[batch:]]) for a, b in
                                        zip(rows["gen_keep_1"], rows["gen_keep_2"]))}
    dense = {**rows, **{k: tuple(m[None].expand(n_exp, *m.shape) for m in rows[k])
                        for k in ("aux_keep", "gen_keep_1")},
             "gen_keep_2": tuple(m[None, batch:].expand(n_exp, *m[batch:].shape)
                                 for m in rows["gen_keep_2"])}
    return rows, dense


def neutron_train(dev, rehearse, card, seed, profile=False):
    """Phase 20: the neutron family's training. At ``NEUTRON_TRAIN`` (the
    preset: ``GeneratorNeutron`` v1, ``norm=group``, width 1, E=3, batch
    512; the constant router GAN term, so that the switch step computes the
    dense step's function) from the state after one dense float32 step on a
    synthetic neutron split of its own: the dense float32 step, the switch
    float32 step (tile 128, ``dispatch_remat``), the dense bf16 step, and
    the dense float32 step under ``norm=batch`` from a state of its own;
    each run once warm and ``NEUTRON_STEP_RUNS`` times timed (median, peak
    memory, FLOPs), its last two runs ``torch.equal`` leaf by leaf, every
    metric finite, every active expert's kernels (and under ``norm=batch``
    its running statistics) moved and every inactive one's stayed
    (``check_step``, ``stats_moved``), none of A-H launched; the switch
    step against the dense step (``switch_against_dense``) and bf16's
    ``disc_loss`` within rtol 0.1 / atol 0.05 of float32's. Then the dense
    ``group`` and ``batch`` steps and the switch ``group`` step at
    ``TRAIN_CHECK`` on the card against the CPU (float32 on ``AGREE_F32``,
    float64 on every check). Then ``train()`` on the preset for one epoch
    (``NEUTRON_LOOP`` events) with ``eval.fused_epilogue``: its eval
    launches kernel E on 44x44 showers, on the bulk ring, equal to the
    plain epilogue (``checked_evaluator``); its checkpoint is served by
    ``FastSim.from_checkpoint`` on ``f32`` behind a router drawn from
    ``--seed`` that reads every expert (``spread_router``). Returns E's
    ``(launches, bulk-ring launches)``."""
    import logging
    import shutil
    import tempfile

    import numpy as np
    import torch

    import zdcsim_torch.train.loop as loop_mod
    from zdcsim_torch.config import NEUTRON_OVERRIDES, load_config
    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.data.dataset import get_train_test_data
    from zdcsim_torch.data.loader import split_to_arrays
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train.state import init_state, make_optimizers
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    phase = "20 neutron train"
    width, n_exp, batch, tile = REHEARSE_NEUTRON_TRAIN if rehearse else NEUTRON_TRAIN
    runs = 0 if rehearse else NEUTRON_STEP_RUNS
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n_events = REHEARSE_NEUTRON_LOOP if rehearse else NEUTRON_LOOP
    data_over = [*NEUTRON_OVERRIDES, "dataset.synthetic=true",
                 f"dataset.synthetic_n_samples={n_events}", "train.seed=7"]

    def build(*over, width=width, n_exp=n_exp, batch=batch):
        cfg = load_config([*NEUTRON_OVERRIDES, f"model.generator.width={width}",
                           f"model.n_experts={n_exp}", f"train.batch_size={batch}",
                           f"train.seed={seed}", "model.router.differentiable_gan_term=false",
                           *over])
        mods = build_moe(cfg)
        return cfg, mods, build_train_step(mods, cfg)

    split = get_train_test_data(load_config(data_over))
    train_side = split_to_arrays(split, True)
    data = {k: torch.as_tensor(v[:batch]).to(dev) for k, v in train_side.items()}
    cfg, mods, dense = build()
    rows, per_expert = switch_draws_as_dense(
        draw_step_noise(torch.Generator(device=dev).manual_seed(seed + 20), mods, batch, dev,
                        switch=True), n_exp, batch)
    state = init_state(mods, cfg, seed + 20, dev)
    switch_over = ("train.dispatch=switch", f"train.dispatch_tile={tile}",
                   f"train.dispatch_remat={not rehearse}")
    cfg_b, _, dense_b = build("model.norm=batch")
    state_b = init_state(build_moe(cfg_b), cfg_b, seed + 21, dev)
    # the rehearsal runs one step, under norm=batch (the loop below steps
    # the preset); the card, each variant after a step, Adam's moments not 0
    variants = {"dense f32 norm=batch": (dense_b, per_expert, state_b)}
    if not rehearse:
        state, _ = dense(state, data, per_expert, 0)
        state_b, _ = dense_b(state_b, data, per_expert, 0)
        sync()
        variants = {"dense f32": (dense, per_expert, state),
                    "switch f32": (build(*switch_over)[2], rows, state),
                    "dense bf16": (build("train.precision=bf16")[2], per_expert, state),
                    "dense f32 norm=batch": (dense_b, per_expert, state_b)}
    n_params = sum(v[0].numel() for v in state.gen.params.values())
    log(phase, f"neutron MoE (GeneratorNeutron v1, norm=group) width {width}, E={n_exp}, batch "
        f"{batch}: generator {n_params} parameters an expert; {len(train_side['cond'])} train "
        f"events of 44x44 [{card}]")
    wrappers = kernel_wrappers()
    reset_counts(wrappers)
    rec, outs = {"width": width, "n_experts": n_exp, "batch": batch, "tile": tile,
                 "card": card}, {}
    ema = float(cfg.train.ema_decay)
    for name, (step, draws, start) in variants.items():
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        times, last = [], []
        for _ in range(1 + runs):
            sync()
            t = time.perf_counter()
            out = step(start, data, draws, 0)
            sync()
            times.append(time.perf_counter() - t)
            last = (last + [out])[-2:]
        if runs:
            check_repeat(phase, name, *last, card)
        active = check_step(start, out[0], out[1], batch, ema)
        stats_moved(start.gen.stats, out[0].gen.stats, active, f"{name}: the generator's")
        stats_moved(start.aux.stats, out[0].aux.stats, active, f"{name}: the aux regressor's")
        if name.endswith("norm=batch") and not (out[0].gen.stats and out[0].aux.stats):
            fail(f"{name}: no BatchNorm running statistics in the state")
        med = float(np.median(times[1:] or times))
        r = {"step_s": times, "median_step_s": med, "repeats_equal": bool(runs) or None,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
             "precision": step.precision["train.precision"], "switch": step.switch,
             "routing": (out[1]["n_choosen_experts_mean_epoch"] * batch).round().int().tolist()}
        if cuda:  # one more step, counted
            flops = step_flops(lambda: step(start, data, draws, 0))
            peak = BF16_OPS_PER_S if r["precision"] == "bf16" else F32_OPS_PER_S
            r.update(tflop=flops / 1e12, tflop_per_s=flops / med / 1e12,
                     bound_s=flops / peak)
            if profile and name in ("dense f32", "dense bf16"):
                profile_serve(lambda: step(start, data, draws, 0),
                              f"one neutron {name} step at width {width}, E={n_exp}, batch "
                              f"{batch}", card, phase)
        rec[name] = r
        outs[name] = out
        log(phase, f"{name}: median of {runs} {med:.4f}s (warm run {times[0]:.4f}s), peak "
            + ("not measured on the CPU" if r["peak_mem_gib"] is None else
               f"{r['peak_mem_gib']:.3f} GiB")
            + (f", {r['tflop']:.2f} TFLOP ({r['tflop_per_s']:.2f} TFLOP/s, "
               f"{100 * r['bound_s'] / med:.1f}% of the {r['precision']} bound)"
               if "tflop" in r else "")
            + f"; routing {r['routing']}; gen_loss {float(out[1]['gen_loss']):.6f}, disc_loss "
            f"{float(out[1]['disc_loss']):.6f} [{card}]")
        del out, last
    counts = {k: v for k, v in read_counts(wrappers).items() if v}
    rec["kernel_launches"] = counts
    log(phase, f"kernel launches {counts or 'none of A-H'}")
    if counts:
        fail(f"the neutron train steps launched hand-written kernels: {counts}")
    if not rehearse:  # phase 19's rehearsal runs the comparison
        agree = switch_against_dense(outs["dense f32"], outs["switch f32"],
                                     make_optimizers(cfg))
        rec["switch_against_dense"] = agree
        n, total = agree["beyond_jax_tol"]
        log(phase, f"switch f32 against dense f32 (constant GAN term): worst error / "
            f"tolerance { {k: agree[k] for k in ('metrics', 'params')} }; parameters beyond "
            f"JAX's tolerance {n} of {total} ({n / total:.3e}, at most "
            f"{SWITCH_BEYOND_SHARE:.0e}), each within 2 lr; Adam's first moments' worst relative "
            f"norm error {agree['mu'][0]:.3e} at {agree['mu'][1]} (at most "
            f"{SWITCH_MU_RTOL:.0e}); shares equal {agree['shares_equal']}")
        if (agree["metrics"][0] > 1 or agree["params"][0] > 1 or n > SWITCH_BEYOND_SHARE * total
                or agree["mu"][0] > SWITCH_MU_RTOL or not agree["shares_equal"]):
            fail(f"the neutron switch step disagrees with the dense step: {agree}")
    if "dense bf16" in outs:
        a, b = float(outs["dense bf16"][1]["disc_loss"]), float(outs["dense f32"][1]["disc_loss"])
        rec["dense bf16 disc_loss against f32"] = (a, b)
        log(phase, f"dense bf16 disc_loss {a:.6f} against dense f32's {b:.6f}: within rtol 0.1 "
            f"/ atol 0.05 {abs(a - b) <= 0.05 + 0.1 * abs(b)}")
        if abs(a - b) > 0.05 + 0.1 * abs(b):
            fail("the neutron bf16 step's disc_loss is not within rtol 0.1 / atol 0.05 of f32's")
    del outs, variants, state, state_b, per_expert, rows, data
    if cuda:
        torch.cuda.empty_cache()

    # -- the card against the CPU at TRAIN_CHECK -------------------------------
    rec["against_cpu"] = {}
    checks = (("dense group", ()), ("dense batch", ("model.norm=batch",)),
              ("switch group", ("train.dispatch=switch", f"train.dispatch_tile={CHECK_TILE}")))
    # no card: phases 17 and 19 rehearse the comparison, this one leaves it out
    for name, over in () if rehearse else checks:
        t = time.perf_counter()
        cw, ce, cb = TRAIN_CHECK
        c_cfg, c_mods, c_step = build(*over, width=cw, n_exp=ce, batch=cb)
        state0 = init_state(c_mods, c_cfg, seed + 1, "cpu")
        c_data = {k: torch.as_tensor(v[:cb]) for k, v in train_side.items()}
        c_draws = draw_step_noise(torch.Generator().manual_seed(seed + 1), c_mods, cb, "cpu",
                                  switch=c_step.switch)
        got = {}
        for dt in (torch.float32, torch.float64):
            ref = step_on(c_step, state0, c_data, c_draws, "cpu", dt)
            ours = step_on(c_step, state0, c_data, c_draws, dev, dt)
            worst = step_agreement(ref, ours, make_optimizers(c_cfg))
            gated = AGREE_F32 if dt == torch.float32 else tuple(worst)
            got[str(dt)[6:]] = worst
            log(phase, f"one {name} step at width {cw}, E={ce}, batch {cb} in {str(dt)[6:]} on "
                f"{dev.type} against the CPU: worst error / tolerance {fmt_worst(worst)}, "
                f"held: {', '.join(gated)} ({time.perf_counter() - t:.2f}s) [{card}]")
            bad = {k: worst[k] for k in gated if worst[k]["ratio"] > 1.0}
            if bad:
                fail(f"the {str(dt)[6:]} neutron {name} step on {dev.type} disagrees with the "
                     f"CPU's: {bad}")
            if dt == torch.float32:
                got["card_repeats_equal"] = check_repeat(
                    phase, f"the float32 {name} step at width {cw} on {dev.type}", ours,
                    step_on(c_step, state0, c_data, c_draws, dev, dt), card)
        rec["against_cpu"][name] = got

    # -- the loop on the preset: one epoch, an eval on E, a checkpoint, a serve --
    tmp = tempfile.mkdtemp(prefix="zdcsim_neutron_loop_")
    try:
        cfg_l = load_config([*data_over, f"model.generator.width={width}",
                             f"model.n_experts={n_exp}", f"train.batch_size={batch}",
                             "eval.fused_epilogue=true", "train.epochs=1", "train.eval_every=1",
                             "config.run_name=neutron_smoke", "train.save_experiment_data=true",
                             "train.ws_threshold_model_save=1e30",
                             f"train.save_experiments_dir={tmp}/"])
        evals, states = [], {}
        build_eval = loop_mod.build_evaluator
        loop_mod.build_evaluator = checked_evaluator(evals, states, dev)
        logger = logging.getLogger(loop_mod.__name__)
        level = logger.level
        logger.setLevel(logging.INFO)
        splits = TimeSplits()
        logger.addHandler(splits)
        reset_counts(wrappers)
        t = time.perf_counter()
        try:
            history, state = loop_mod.train(cfg_l, return_state=True, device=dev)
            sync()
        finally:
            loop_mod.build_evaluator = build_eval
            logger.removeHandler(splits)
            logger.setLevel(level)
        train_s = time.perf_counter() - t
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        e_counts = (counts.get("expm1_channel_sums", 0),
                    counts.get("expm1_channel_sums on the bulk ring", 0))
        (h,), (ev,) = history, evals
        times = splits.splits.get(0, {})
        rec["loop"] = {"events": n_events, "train_s": train_s, "times_s": times, "eval": ev,
                       "kernel_launches": counts, "history": {k: h[k] for k in (
                           "gen_loss", "disc_loss", "router_loss", "ws_mean")}}
        log(phase, f"train() on the preset, 1 epoch of {len(train_side['cond']) // batch} steps "
            f"in {train_s:.2f}s (steps {times.get('steps', float('nan')):.4f}s, eval "
            f"{times.get('eval', float('nan')):.4f}s with its plain comparison, callbacks "
            f"{times.get('callbacks', float('nan')):.4f}s); eval of "
            f"{len(split.y_test)} showers [{len(split.y_test)}, 44, 44]: E launched "
            f"{ev['E_launches']} times, {ev['E_on_bulk_ring']} on the bulk ring, in "
            f"{ev['eval_s']:.4f}s; ws_mean {ev['ws_mean']!r} against {ev['ws_mean_plain']!r} "
            f"with the plain epilogue (rel {ev['rel']:.3e}, limit 1e-4); gen_loss "
            f"{h['gen_loss']:.4f}, disc_loss {h['disc_loss']:.4f}; kernel launches {counts} "
            f"[{card}]")
        if cuda and (ev["E_launches"] < 1 or ev["E_on_bulk_ring"] != ev["E_launches"]):
            fail(f"the neutron eval did not launch E on the bulk ring: {ev}")
        if not (ev["rel"] <= 1e-4 and ev["routing_identical"]):
            fail(f"the neutron eval on kernel E disagrees with the plain epilogue: {ev}")
        if (set(counts) - {"expm1_channel_sums", "expm1_channel_sums on the bulk ring"}
                or e_counts[0] != ev["E_launches"]):
            fail(f"the neutron loop launched kernels outside its eval's E: {counts}")
        if not all(np.isfinite(h[k]) for k in ("gen_loss", "disc_loss", "ws_mean")):
            fail(f"the neutron loop's losses are not finite: {h}")
        models = f"{cfg_l.config.experiment_dir}/models"
        if not os.path.isfile(os.path.join(models, "state_epoch_0", "state.pt")):
            fail(f"the neutron loop wrote no checkpoint under {models}")
        del state, states
        n, serve_batch, serve_tile = (REHEARSE_NEUTRON_LOOP_SERVE if rehearse
                                      else NEUTRON_LOOP_SERVE)
        rng = np.random.default_rng([seed, 20])
        cond = rng.standard_normal((n, 9), dtype="float32")
        noise = rng.standard_normal((n, 10), dtype="float32")
        eng = FastSim.from_checkpoint(cfg_l, models, 0, precision="f32", batch_size=serve_batch,
                                      device=dev)
        eng.router.load_state_dict(to_state_dict(spread_router(rng)))
        eng._build_switch(tile=serve_tile)
        t = time.perf_counter()
        imgs, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
        sync()
        dt = time.perf_counter() - t
        used = torch.bincount(ids, minlength=n_exp).tolist()
        imgs_np = imgs.cpu().numpy()
        rec["loop"]["serve"] = {"showers": n, "s": dt, "routing": used}
        log(phase, f"FastSim.from_checkpoint(epoch 0) f32 on the module (norm=group): {n} "
            f"showers in {dt:.3f}s, routing {used}, finite {bool(np.isfinite(imgs_np).all())} "
            f"[{card}]")
        # every expert read: on the card (the rehearsal's 6 showers may miss one)
        if (tuple(imgs.shape) != (n, 44, 44) or not np.isfinite(imgs_np).all()
                or imgs_np.min() < 0 or (cuda and min(used) == 0)):
            fail(f"the neutron checkpoint's serve: shape {tuple(imgs.shape)}, routing {used}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"neutron_train": rec}), flush=True)
    return e_counts



def seeded_attention_router(rng, n_experts=3, embed_dim=64):
    """An ``AttentionRouterNetwork`` in the Flax layout, drawn from ``rng``:
    LeCun normal kernels and zero biases as Flax initialises ``nn.Dense``,
    the norm's scale 1 and bias 0, and N(0, 1) queries (Flax draws them at
    0.02; at unit scale the logits spread and every expert is read)."""
    import numpy as np

    def dense(n_in, n_out):
        return {"kernel": (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype("float32"),
                "bias": np.zeros(n_out, "float32")}

    return {"Dense_0": dense(9, 128), "Dense_1": dense(128, embed_dim),
            "LayerNorm_0": {"scale": np.ones(embed_dim, "float32"),
                            "bias": np.zeros(embed_dim, "float32")},
            "expert_queries": rng.standard_normal((n_experts, embed_dim)).astype("float32")}


def attention_router(gp, split, dev, rehearse, card, seed):
    """Phase 21 (a): the full-width teacher (the w=0.125 student in the
    rehearsal) served on ``int8`` behind a
    seeded ``AttentionRouterNetwork`` (``model.router.version=
    router_attention``), its routing against the router's own argmax on the
    CPU (a difference allowed only at a near tie, ``NEAR_TIE``); then, on the
    card, one dense float32 train step with that router at ``TRAIN_CHECK``
    against the CPU at phase 17's limits (``AGREE_F32``)."""
    import numpy as np
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.convert import to_state_dict
    from zdcsim_torch.data.loader import split_to_arrays
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.models.router import AttentionRouterNetwork
    from zdcsim_torch.train.state import init_state, make_optimizers
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    phase = "21 distill"
    attn = "model.router.version=router_attention"
    n, batch, tile = REHEARSE_ROUTER_SERVE if rehearse else ROUTER_SERVE
    rng = np.random.default_rng([seed, 21])
    cond = rng.standard_normal((n, 9), dtype="float32")
    noise = rng.standard_normal((n, 10), dtype="float32")
    router = seeded_attention_router(rng)
    over = [attn]
    if rehearse:  # the w=0.125 student: the rehearsal's train part loads no teacher
        from zdcsim_torch.utils.artifact import load_serving_artifact

        gp, _, _, meta = load_serving_artifact(STUDENT)
        over.append(f"model.generator.width={meta['width']}")
    eng = FastSim(gp, router, batch_size=batch, precision="int8", device=dev,
                  cfg=load_config(over))
    eng._build_switch(tile=tile)
    if type(eng.router) is not AttentionRouterNetwork:
        fail(f"FastSim built {type(eng.router).__name__} for {attn}")
    t = time.perf_counter()
    imgs, ids = eng.simulate_bulk(cond, noise=noise, return_experts=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t
    net = AttentionRouterNetwork(3)
    net.load_state_dict(to_state_dict(router))
    with torch.no_grad():
        logits = net(torch.as_tensor(cond))[1]
    top = logits.topk(2, dim=-1).values
    gap = (top[:, 0] - top[:, 1]).numpy()
    ids_np, ref = ids.cpu().numpy(), logits.argmax(-1).numpy()
    differ = ids_np != ref
    used = np.bincount(ids_np, minlength=3).tolist()
    imgs_np = imgs.cpu().numpy()
    rec = {"serve": {"showers": n, "batch": batch, "tile": tile, "s": dt, "routing": used,
                     "differs_from_cpu": int(differ.sum()),
                     "min_gap": float(gap.min())}}
    log(phase, f"int8 serve behind a seeded AttentionRouterNetwork: {n} showers in {dt:.3f}s, "
        f"routing {used}; equal to the CPU router's argmax at {n - int(differ.sum())} of {n} "
        f"(differences only where the top two logits are within {NEAR_TIE}: smallest gap "
        f"{gap.min():.3e}) [{card}]")
    if differ.any() and float(gap[differ].max()) > NEAR_TIE:
        fail(f"the attention router's routing on {dev.type} differs from its argmax on the CPU "
             f"away from a tie: gaps {gap[differ].tolist()[:5]}")
    if not rehearse and min(used) <= 0:
        fail(f"the attention router left an expert unread: {used}")
    if imgs_np.shape != (n, 56, 30) or not np.isfinite(imgs_np).all() or imgs_np.min() < 0:
        fail("the attention router's serve: showers not finite/non-negative of shape (n, 56, 30)")
    del eng, imgs
    if rehearse:  # phase 17 rehearses the comparison; the CPU tests hold this step against JAX
        return rec

    # one dense float32 step with the attention router, the card against the CPU
    width, n_exp, b = TRAIN_CHECK
    cfg = load_config([f"model.generator.width={width}", f"model.n_experts={n_exp}",
                       f"train.batch_size={b}", f"train.seed={seed}", attn])
    mods = build_moe(cfg)
    state0 = init_state(mods, cfg, seed + 3, "cpu")
    step = build_train_step(mods, cfg)
    data = {k: torch.as_tensor(v[:b]) for k, v in split_to_arrays(split, True).items()}
    draws = draw_step_noise(torch.Generator().manual_seed(seed + 3), mods, b, "cpu")
    t = time.perf_counter()
    ref = step_on(step, state0, data, draws, "cpu", torch.float32)
    ours = step_on(step, state0, data, draws, dev, torch.float32)
    worst = step_agreement(ref, ours, make_optimizers(cfg))
    gated = AGREE_F32
    moved = [k for k, v in ours[0].router.params.items()
             if not torch.equal(v.cpu(), state0.router.params[k])]
    finite = all(bool(torch.isfinite(v).all()) for v in ours[1].values())
    rec["train"] = {"width": width, "n_experts": n_exp, "batch": b, "against_cpu": worst,
                    "router_leaves_moved": len(moved)}
    log(phase, f"one dense float32 step with the attention router at width {width}, E={n_exp}, "
        f"batch {b} on {dev.type} against the CPU: worst error / tolerance "
        f"{fmt_worst(worst)}, held: {', '.join(gated)}; router leaves moved {len(moved)} of "
        f"{len(state0.router.params)}, metrics finite {finite} "
        f"({time.perf_counter() - t:.2f}s) [{card}]")
    bad = {k: worst[k] for k in gated if worst[k]["ratio"] > 1.0}
    if bad or not finite or len(moved) != len(state0.router.params):
        fail(f"the attention router's train step on {dev.type}: {bad or ''} finite {finite}, "
             f"moved {moved}")
    return rec


def distill_agreement(ref, ours, lr, k):
    """How far one distill call (``ours``: ``(params, opt_state, metrics)``)
    is from a reference call on the same state and draws:
    ``{check: {"ratio", "at"}}``, each ratio at most 1 to pass. Metrics rtol
    1e-4; Adam's moments rtol 1e-4 / atol 1e-6 elementwise; the parameters
    within ``2 lr k`` (Adam moves an element whose gradient is at its
    float32 rounding by up to ``lr`` a step either way, as phase 17 holds
    the train step's). ``params_outside`` (a share, not held) counts the
    parameters beyond rtol 1e-4 / atol 1e-6."""
    import torch

    (rp, ro, rm), (p, o, m) = ref, ours
    cpu = lambda t: t.detach().to("cpu", torch.float32)  # noqa: E731
    worst = {}

    def note(what, err, tol, at):
        r = torch.where(err == 0, 0.0, err / tol).nan_to_num(nan=float("inf"))
        ratio = float(r.max())
        if what not in worst or ratio > worst[what]["ratio"]:
            worst[what] = {"ratio": ratio, "at": at}

    for key, v in rm.items():
        note("metrics", (cpu(m[key]) - cpu(v)).abs(), 1e-4 * cpu(v).abs(), key)
    outside = total = 0
    for key, v in rp.items():
        err = (cpu(p[key]) - cpu(v)).abs()
        note("params", err, torch.full_like(err, 2 * lr * k), key)
        outside += int((err > 1e-6 + 1e-4 * cpu(v).abs()).sum())
        total += err.numel()
    for moment in ("mu", "nu"):
        for key, v in getattr(ro, moment).items():
            note("moments", (cpu(getattr(o, moment)[key]) - cpu(v)).abs(),
                 1e-6 + 1e-4 * cpu(v).abs(), f"{moment} {key}")
    note("count", torch.tensor(float(int(o.count) != int(ro.count))), torch.tensor(0.0), "count")
    worst["params_outside"] = {"ratio": 0.0, "at": f"{outside / total:.3e} of {total}"}
    return worst


def distill_family(family, teacher_trees, cond_pool, dev, rehearse, card, seed):
    """Phase 21 (b) for one family: the committed teacher (the proton
    artifact's bf16 ``fast_generator_apply``, or the neutron teacher's
    ``GeneratorNeutron(norm="group")`` module in bf16) distilled into a
    w=0.125 student at ``DISTILL`` for two calls from one state on one
    seed: ``torch.equal``, every metric finite, the loss on the call's first
    draw lower after the call than before; the median call time, the peak memory and the student's parameter
    count; then one call at ``DISTILL_CHECK`` on the card against the CPU
    (the float32 teacher in both), ``distill_agreement``. ``teacher_trees``:
    the teacher's ``(gen_params, router_params)``, or ``None`` to load the
    family's artifact. Returns ``(student
    params, the teacher's router, the student's config, record)``."""
    import numpy as np
    import torch

    import distill_torch as dt
    from fidelity_torch import GATE_OVERRIDES
    from zdcsim_torch.config import load_config
    from zdcsim_torch.convert import from_jax_params, to_state_dict
    from zdcsim_torch.inference.distill import (
        build_distill_step, distill_loss, draw_distill, module_teacher, proton_teacher,
        router_argmax,
    )
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train.state import _init_params, adam_init, cosine_decay_schedule
    from zdcsim_torch.utils.artifact import load_serving_artifact

    phase = "21 distill"
    width, batch, inner = REHEARSE_DISTILL if rehearse else DISTILL
    lr, decay = DISTILL_LR
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gp, rp = teacher_trees or load_serving_artifact(dt.TEACHERS[family])[::2]
    base = [*dt.family_overrides(family), *GATE_OVERRIDES]
    cfg = load_config(base)
    cfg_w = load_config([*base, f"model.generator.width={width}",
                         *(["model.norm=none"] if family == "neutron" else [])])
    gen, router_sd = from_jax_params(gp, rp)
    teacher_mods = build_moe(cfg) if family == "neutron" else None
    t_sd = to_state_dict(gp, stacked=True) if family == "neutron" else None

    def teacher_on(device, dtype):
        if family == "proton":
            return proton_teacher(gen, device, dtype)
        return module_teacher(teacher_mods, {k: v.to(device) for k, v in t_sd.items()},
                              dtype=dtype)

    student = build_moe(cfg_w)
    s0 = _init_params(student.generator, student.n_experts,
                      torch.Generator(device=dev).manual_seed(seed), dev)
    n_params = sum(int(v.numel()) for v in s0.values())
    teacher, router = teacher_on(dev, torch.bfloat16), router_argmax(cfg.model, router_sd, dev)
    step = build_distill_step(student.generate, teacher, router,
                              cosine_decay_schedule(lr, decay), student.noise_dim,
                              inner_steps=inner)
    pool = torch.as_tensor(np.asarray(cond_pool, np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows, z = draw_distill(torch.Generator(device=dev).manual_seed(seed + 1), len(pool), batch,
                           student.noise_dim, 1, dev)[0]  # the call's first draw

    def loss_on_first(params):
        with torch.no_grad():
            c = pool[rows]
            return float(distill_loss(student.generate(params, z, c), teacher(z, c),
                                      router(c))[0])

    loss0 = loss_on_first(s0)
    outs, times = [], []
    for _ in range(2):
        sync()
        t = time.perf_counter()
        outs.append(step(s0, adam_init(s0), pool, batch,
                         torch.Generator(device=dev).manual_seed(seed + 1)))
        sync()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else None
    (p1, o1, m1), (p2, o2, m2) = outs
    equal = all(torch.equal(p1[k], p2[k]) and torch.equal(o1.mu[k], o2.mu[k])
                and torch.equal(o1.nu[k], o2.nu[k]) for k in p1) and all(
        torch.equal(m1[k], m2[k]) for k in m1)
    metrics = {k: float(v) for k, v in m1.items()}
    loss1 = loss_on_first(p1)
    finite = all(np.isfinite(v) for v in metrics.values())
    med = float(np.median(times))
    rec = {"family": family, "width": width, "batch": batch, "inner_steps": inner,
           "call_s": times, "median_call_s": med, "peak_mem_gib": peak,
           "student_params": n_params, "student_params_per_expert": n_params // student.n_experts,
           "loss_before": loss0, "loss_after": loss1, "metrics": metrics, "calls_equal": equal,
           "card": card}
    mem = "not measured on the CPU" if peak is None else f"{peak:.3f} GiB"
    log(phase, f"{family} distillation into a w={width} student ({n_params} parameters, "
        f"{n_params // student.n_experts} an expert), batch {batch}, {inner} inner steps a call: "
        f"calls {[round(x, 4) for x in times]}s, median {med:.4f}s ({med / inner * 1e3:.2f} ms "
        f"an update), peak memory {mem}; two calls from one state torch.equal {equal}; loss "
        f"on the call's first draw {loss0:.5f} before the call, {loss1:.5f} after; the last "
        f"update's metrics {metrics} [{card}]")
    if not (equal and finite and loss1 < loss0):
        fail(f"{family} distillation: calls equal {equal}, finite {finite}, loss {loss0} -> "
             f"{loss1}")

    # one call on the card against the CPU, from one state on one set of draws
    # (no card: left out; tests/test_torch_distill.py holds distill_agreement)
    if not rehearse:
        b, k = DISTILL_CHECK
        t = time.perf_counter()
        s0_cpu = _init_params(student.generator, student.n_experts,
                              torch.Generator().manual_seed(seed + 2), "cpu")
        draws = draw_distill(torch.Generator().manual_seed(seed + 3), len(pool), b,
                             student.noise_dim, k, "cpu")

        def call(device):
            st = build_distill_step(student.generate, teacher_on(device, torch.float32),
                                    router_argmax(cfg.model, router_sd, device),
                                    cosine_decay_schedule(lr, decay), student.noise_dim,
                                    inner_steps=k)
            p = {n: v.to(device) for n, v in s0_cpu.items()}
            return st(p, adam_init(p), pool.to(device), b,
                      draws=[(r.to(device), z.to(device)) for r, z in draws])

        worst = distill_agreement(call(torch.device("cpu")), call(dev), lr, k)
        rec["against_cpu"] = {"batch": b, "inner_steps": k, **worst}
        log(phase, f"{family}: one call of {k} update(s) at batch {b} (float32 teacher) on "
            f"{dev.type} against the CPU: worst error / tolerance {fmt_worst(worst)} "
            f"({time.perf_counter() - t:.2f}s) [{card}]")
        bad = {key: v for key, v in worst.items() if v["ratio"] > 1.0}
        if bad:
            fail(f"the {family} distill call on {dev.type} disagrees with the CPU's: {bad}")
    return p1, rp, cfg_w, rec


def round_trip(family, params, rp, cfg_w, rng, dev, rehearse, card):
    """Phase 21 (c): the student written by ``save_serving_artifact`` into a
    temporary directory, read back by ``load_serving_artifact`` and served by
    ``FastSim`` on ``int8`` against the in-memory student (the same trees,
    not quantised by the codec), both behind one seeded router: routing
    identical and per-shower log1p sums within rtol 0.15 (phase 16's
    ``int8`` rule). The file is removed afterwards. Returns its size."""
    import tempfile

    import torch

    from zdcsim_torch.convert import from_state_dict, to_state_dict, tree_to_torch
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.utils.artifact import load_serving_artifact, save_serving_artifact

    phase = "21 distill"
    n, batch, tile = REHEARSE_LOOP_SERVE if rehearse else LOOP_SERVE
    gp = from_state_dict(params, stacked=True)
    meta = {"weights": "distilled-student", "width": cfg_w.model.generator.width,
            **({"family": "neutron", "norm": "none"} if family == "neutron" else {})}
    with tempfile.TemporaryDirectory(prefix="zdcsim_distill_") as tmp:
        path = os.path.join(tmp, f"{family}_student_serving_weights.npz")
        save_serving_artifact(path, tree_to_torch(gp), {}, to_state_dict(rp), meta=meta)
        size = os.path.getsize(path)
        gp2, _, rp2, meta = load_serving_artifact(path)
    cond = rng.standard_normal((n, 9), dtype="float32")
    noise = rng.standard_normal((n, 10), dtype="float32")
    router = to_state_dict(seeded_router(rng))
    served = []
    for what, tree in (("in memory", gp), ("read back", gp2)):
        eng = FastSim(tree, rp2, batch_size=batch, precision="int8", device=dev, cfg=cfg_w)
        eng.router.load_state_dict(router)
        eng._build_switch(tile=tile)
        served.append(eng.simulate_bulk(cond, noise=noise, return_experts=True))
        del eng
    (ref_imgs, ref_ids), (imgs, ids) = served
    log(phase, f"{family} student written by save_serving_artifact ({size} bytes, meta "
        f"{meta}) and read back; both served on int8, {n} showers, routing "
        f"{torch.bincount(ids.cpu(), minlength=3).tolist()} [{card}]")
    check_agrees(phase, f"the {family} student read back", imgs, ids, log1p_sums(ref_imgs),
                 ref_ids.cpu().numpy(), ref_name="the in-memory student")
    return size


def rundir_gate(loop_rec, cond, real, dev, rehearse, card):
    """Phase 21 (d): phase 18's run directory gated by
    ``fidelity_torch.run_gate`` on the first ``RUNDIR_GATE`` conditions of
    the gate's split, one draw, on ``int8_pallas`` and ``int8_fused``
    (``int8_pallas`` alone in the rehearsal, whose run is not full width),
    counts set to 0 before each: the value finite, ``fidelity.py``'s record
    keys with the short-training warning, E on the bulk ring and the path's
    decode kernels launched. Returns ``(launches by kernel, records)``."""
    import numpy as np
    import torch

    import fidelity_torch as ft

    phase = "21 distill"
    n = REHEARSE_RUNDIR_GATE if rehearse else RUNDIR_GATE
    over = [f"model.generator.width={loop_rec['width']}", f"model.n_experts={loop_rec['n_experts']}"]
    wrappers = kernel_wrappers()
    launches, recs = {}, {}
    for precision in ("int8_pallas",) + (() if rehearse else ("int8_fused",)):
        reset_counts(wrappers)
        t = time.perf_counter()
        rec = ft.run_gate(loop_rec["run_dir"], precision, dev, data=(cond[:n], real[:n]),
                          n_draws=1, overrides=over)
        wall = time.perf_counter() - t
        c = {k: v for k, v in read_counts(wrappers).items() if v}
        recs[precision] = {**rec, "wall_s": wall, "launches": c}
        log(phase, f"run_gate({loop_rec['run_dir']}, {precision}) on {n} test conditions, one "
            f"draw: {wall:.2f}s wall (the checkpoint restored and served), value {rec['value']}, "
            f"checkpoint {rec['checkpoint']}, kernel launches {c or 'none'} [{card}]")
        keys = set(rec) - {"device"}
        if keys != set(ft.RECORD_KEYS) | {"warning"} or not np.isfinite(rec["value"]):
            fail(f"the run directory's gate record: keys {sorted(keys)}, value {rec['value']}")
        if dev.type == "cuda":
            e = c.get("expm1_channel_sums", 0)
            names = KERNEL_PATHS[precision]
            if e < 1 or c.get("expm1_channel_sums on the bulk ring", 0) != e or \
                    min(c.get(k, 0) for k in names) <= 0:
                fail(f"the {precision} gate of the run directory did not launch E on the bulk "
                     f"ring and {names}: {c}")
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    return launches, recs


def distill_phase(gp, rp, split, cond, real, loop_rec, dev, rehearse, card, seed):
    """Phase 21: the attention router (a), the distillation of both families
    (b) on the gate split's train conditions (the neutron split's are the
    same rows, ``tests/test_torch_distill.py``), their artifacts' round trip
    (c) and the run directory's gate (d); a ``{"distill": ...}`` line
    records it. Returns the kernel launches of (d)."""
    import numpy as np

    phase = "21 distill"
    rec = {"router_attention": attention_router(gp, split, dev, rehearse, card, seed)}
    rng = np.random.default_rng([seed, 212])
    # the rehearsal distils the neutron family alone (the proton teacher's
    # forward is the serving path's; tests/test_torch_distill.py holds its step)
    for family in ("neutron",) if rehearse else ("proton", "neutron"):
        params, t_rp, cfg_w, r = distill_family(
            family, (gp, rp) if family == "proton" else None, split.y_train, dev, rehearse,
            card, seed)
        r["artifact_bytes"] = round_trip(family, params, t_rp, cfg_w, rng, dev, rehearse, card)
        rec[family] = r
        del params
    launches, rec["rundir_gate"] = rundir_gate(loop_rec, cond, real, dev, rehearse, card)
    log(phase, f"the run directory's gates launched {launches} [{card}]")
    print(json.dumps({"distill": rec}), flush=True)
    return launches


def real_data(dev, rehearse, card, seed):
    """Phase 22: the reference-format fixtures (``tests/fixtures/real_pickles``)
    without pandas. (a) The three pickles through
    ``zdcsim_torch.data.pickles``, the split through ``get_dataset`` and
    ``transform_data_for_training`` (``train.seed=7``) against
    ``expected.npz`` at rtol / atol 1e-6, the dataset report; (b)
    ``cli_torch.py``'s main on the default config pointed at them
    (``REAL_DATA``: the proton MoE, E=3, one epoch, one eval on kernel E,
    the split and a checkpoint saved), then resumed from it with the saved
    split read back; (c) the eval figures: with matplotlib absent
    ``train.save_eval_plots`` raises before the first step, with it the
    PNGs are written; the device half of ``generate_eval_figures`` on the
    checkpoint routes as the CPU and its showers match the CPU's. Returns
    E's launches and those on the bulk ring; a ``{"real_data": ...}`` line
    records the phase."""
    import tempfile

    import numpy as np
    import torch

    import zdcsim_torch.train.loop as loop_mod
    from zdcsim_torch.cli import main as cli_main
    from zdcsim_torch.config import load_config
    from zdcsim_torch.data.dataset import get_dataset, transform_data_for_training
    from zdcsim_torch.data.pickles import read_pickle
    from zdcsim_torch.evals.report import dataset_analysis_report
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.train import eval_plots
    from zdcsim_torch.train.checkpoint import restore_checkpoint
    from zdcsim_torch.train.state import init_state
    from zdcsim_torch.utils.io import DIR_MODELS
    from zdcsim_torch.utils.prng import figure_generator

    phase = "22 real data"
    cuda = dev.type == "cuda"
    width, n_exp, batch = REHEARSE_REAL_DATA if rehearse else REAL_DATA
    paths = [f"dataset.DATA_IMAGES_PATH={FIXTURES}/data_proton_fixture.pkl",
             f"dataset.DATA_COND_PATH={FIXTURES}/data_cond_fixture.pkl",
             f"dataset.DATA_POSITIONS_PATH={FIXTURES}/data_coord_fixture.pkl", "train.seed=7"]
    rec = {"width": width, "n_experts": n_exp, "batch": batch, "card": card}

    # -- (a) the pickles and the split ------------------------------------------
    t = time.perf_counter()
    frames = {name: read_pickle(f"{FIXTURES}/{name}.pkl")
              for name in ("data_proton_fixture", "data_cond_fixture", "data_coord_fixture")}
    cfg = load_config([*paths, "train.save_experiment_data=false"])
    ds = get_dataset(cfg)
    split = transform_data_for_training(cfg, ds)
    rec["read_split_s"] = time.perf_counter() - t
    exp = np.load(f"{FIXTURES}/expected.npz")
    keys = [k for k in exp.files if k not in ("n_events", "photon_sum_min", "photon_sum_max",
                                               "scaler_cond_mean", "scaler_cond_scale")]
    bad = [k for k in keys if not np.allclose(getattr(split, k), exp[k], rtol=1e-6, atol=1e-6)]
    bad += [k for k, v in (("scaler_cond_mean", split.scaler_cond.mean_),
                           ("scaler_cond_scale", split.scaler_cond.scale_),
                           ("photon_sum_min", cfg.photon_sum_min),
                           ("photon_sum_max", cfg.photon_sum_max))
            if not np.allclose(v, exp[k], rtol=1e-6, atol=1e-6)]
    log(phase, f"read {', '.join(f'{k} {type(v).__name__}' for k, v in frames.items())} "
        f"without pandas; {ds.n_events} events kept of {len(frames['data_proton_fixture'])}, "
        f"photon sums [{cfg.photon_sum_min!r}, {cfg.photon_sum_max!r}]; split "
        f"{len(split.x_train)}/{len(split.x_test)} in {rec['read_split_s']:.2f}s; equal to "
        f"expected.npz at rtol/atol 1e-6: {not bad} ({len(keys) + 4} arrays)")
    if ds.n_events != int(exp["n_events"]) or bad:
        fail(f"the fixtures' split differs from expected.npz: {bad}")
    print(dataset_analysis_report(
        np.expm1(ds.images), photon_sums=ds.cond["proton_photon_sum"],
        n_before_filter=len(frames["data_proton_fixture"]),
        title="zdcsim proton dataset analysis (tests/fixtures/real_pickles)"), flush=True)

    # -- (b) cli_torch.py on the default config, then resumed --------------------
    tmp = tempfile.mkdtemp(prefix="zdcsim_real_")
    run = [*paths, f"model.generator.width={width}", f"model.n_experts={n_exp}",
           f"train.batch_size={batch}", "train.epochs=1", "eval.fused_epilogue=true",
           "config.run_name=real", f"train.save_experiments_dir={tmp}/"]
    cpu = [] if cuda else ["--cpu"]
    splits = []
    get_split = loop_mod.get_train_test_data
    loop_mod.get_train_test_data = lambda c: splits.append(get_split(c)) or splits[-1]
    wrappers = kernel_wrappers()
    try:
        reset_counts(wrappers)
        t = time.perf_counter()
        rc = cli_main([*cpu, "--override", *run, "train.save_experiment_data=true",
                       "train.ws_threshold_model_save=1e30"])
        if cuda:
            torch.cuda.synchronize()
        rec["train_s"] = time.perf_counter() - t
        run_dir = os.path.join(tmp, os.listdir(tmp)[0])
        t = time.perf_counter()
        rc_resume = cli_main([*cpu, "--override", *run, "train.save_experiment_data=false",
                              f"train.checkpoint_experiment_dir={run_dir}",
                              "train.epoch_to_load=0"])
        if cuda:
            torch.cuda.synchronize()
        rec["resume_s"] = time.perf_counter() - t
        counts = {k: v for k, v in read_counts(wrappers).items() if v}
        e, e_bulk = (counts.get("expm1_channel_sums", 0),
                     counts.get("expm1_channel_sums on the bulk ring", 0))
        same = len(splits) == 2 and all(
            np.array_equal(getattr(splits[1], k), exp[k]) for k in ("train_indices",
                                                                    "test_indices"))
        rec.update(rc=rc, rc_resume=rc_resume, E_launches=e, E_on_bulk_ring=e_bulk,
                   resumed_split_equal=same)
        log(phase, f"cli_torch.py main, default config on the fixtures (proton MoE width "
            f"{width}, E={n_exp}, batch {batch}, one epoch, eval on E): exit {rc} in "
            f"{rec['train_s']:.2f}s; resumed from its epoch 0 checkpoint: exit {rc_resume} in "
            f"{rec['resume_s']:.2f}s, the saved split read back {same}; kernel launches "
            f"{counts or 'none'} [{card}]")
        if rc or rc_resume or not same:
            fail("phase 22's cli_torch.py runs failed or the resume drew another split")
        if cuda and (e < 2 or e_bulk != e or set(counts) - {
                "expm1_channel_sums", "expm1_channel_sums on the bulk ring"}):
            fail(f"the fixtures' evals did not launch E, all on the bulk ring: {counts}")
    finally:
        loop_mod.get_train_test_data = get_split

    # -- (c) the eval figures ------------------------------------------------------
    try:
        try:
            eval_plots.require_matplotlib()
            have_mpl = True
        except ImportError:
            have_mpl = False
        cfg_p = load_config([*run, "train.save_eval_plots=true"])
        if not have_mpl:
            t = time.perf_counter()
            try:
                loop_mod.train(cfg_p, device=dev)
                fail("train.save_eval_plots=true without matplotlib did not raise")
            except ImportError as err:
                log(phase, f"train.save_eval_plots=true without matplotlib raised before the "
                    f"first step in {time.perf_counter() - t:.3f}s: {err}")
        cfg_r = load_config([*run, f"train.checkpoint_experiment_dir={run_dir}",
                             "train.epoch_to_load=0"])
        modules = build_moe(cfg_r)
        models = DIR_MODELS.format(EXPERIMENT_DIR_NAME=run_dir)
        arrays = {"cond": split.y_train, "real": split.x_train}  # 18 showers
        noise = torch.randn((len(split.y_train), modules.noise_dim),
                            generator=figure_generator(seed, 0))
        halves = {}
        for d in ([dev, torch.device("cpu")] if cuda else [dev]):
            state = restore_checkpoint(models, 0, init_state(modules, cfg_r, 7, d))
            t = time.perf_counter()
            halves[d.type] = eval_plots.figure_arrays(modules, state, arrays, noise=noise)
            rec[f"figure_arrays_{d.type}_s"] = time.perf_counter() - t
            del state
        ours, ref = halves[dev.type], halves["cpu"]
        sums, ref_sums = ours["generated"].sum((1, 2)), ref["generated"].sum((1, 2))
        rel = float((np.abs(sums - ref_sums) / np.abs(ref_sums)).max())
        err = float(np.abs(ours["generated"] - ref["generated"]).max())
        same_ids = bool(np.array_equal(ours["experts"], ref["experts"]))
        ok = (same_ids and rel <= 1e-4 and np.isfinite(ours["generated"]).all()
              and np.allclose(ours["generated"], ref["generated"], rtol=1e-4, atol=1e-4))
        rec["figures_device_half"] = {"routing": np.bincount(ours["experts"], minlength=n_exp)
                                      .tolist(), "sums_rel": rel, "max_abs_err": err}
        log(phase, f"generate_eval_figures' device half on the checkpoint, "
            f"{len(noise)} showers on {dev.type}"
            f"{' against the CPU' if cuda else ' (no card: against itself)'}: routing "
            f"identical {same_ids} ({rec['figures_device_half']['routing']}), photon sums "
            f"rel {rel:.3e} (1e-4), showers max abs err {err:.3e} (rtol/atol 1e-4) "
            f"in {rec[f'figure_arrays_{dev.type}_s']:.3f}s")
        if not ok:
            fail("the eval figures' device half disagrees with the CPU")
        if have_mpl:
            out = os.path.join(tmp, "plots")
            eval_plots.save_figures(eval_plots.build_figures(
                ours, 0, split.data_cond_names, n_exp), out, 0)
            pngs = sorted(os.listdir(out))
            log(phase, f"with matplotlib: {len(pngs)} PNGs written: {pngs}")
            if len(pngs) < 4:
                fail(f"the eval figures wrote {pngs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"real_data": rec}), flush=True)
    return rec["E_launches"], rec["E_on_bulk_ring"]


def mesh_serves(trees, router, mesh, dev, rehearse, card, seed):
    """Phase 23 (a): the teacher on ``int8_pallas`` and ``int8_fused`` through
    ``FastSim(mesh=...)`` on a world of one (``MESH_SERVE``; ``trees``:
    ``{precision: (generator tree, cfg)}``), each serve
    ``torch.equal`` to the meshless engine's on the same generator seed:
    ``simulate_switch`` (the kernels' counts set to 0 just before the
    meshed serve and read just after: each of the path's kernels launched,
    B and D on the tensor cores, A and C in clusters of the plan's k) and
    ``simulate_bulk`` through the dyn form (the CUDA graph on the card,
    whose replays the counts do not see). Returns ``(launches by kernel,
    record)``."""
    import torch

    from zdcsim_torch.inference.engine import FastSim

    phase = "23 mesh"
    n, batch, tile = REHEARSE_MESH if rehearse else MESH_SERVE
    cond = torch.randn((n, 9), generator=torch.Generator().manual_seed(seed + 23))
    every = kernel_wrappers()
    launches, rec = {}, {}

    def gen():
        return torch.Generator(device=dev).manual_seed(seed + 230)

    def timed_serve(fn):
        t = time.perf_counter()
        out = fn(cond, generator=gen(), return_experts=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for precision, (gp, cfg) in trees.items():
        names = KERNEL_PATHS[precision]
        wrappers = {k: every[k] for k in names}
        engines = {tag: FastSim(gp, router, batch_size=batch, precision=precision, device=dev,
                                cfg=cfg, mesh=m) for tag, m in (("meshless", None), ("mesh", mesh))}
        for eng in engines.values():
            eng._build_switch(tile=tile)
        timed_serve(engines["meshless"].simulate_switch)  # the first serve of a process warms up
        (ref, ref_ids), ref_s = timed_serve(engines["meshless"].simulate_switch)
        reset_counts(wrappers)
        (out, ids), out_s = timed_serve(engines["mesh"].simulate_switch)
        counts = read_counts(wrappers)
        same_switch = torch.equal(out, ref) and torch.equal(ids, ref_ids)
        for eng in engines.values():
            eng._build_switch(tile=tile, dyn_dispatch=True)
        bulk = {}
        for tag, eng in engines.items():
            _, bulk[tag + "_capture_s"] = timed_serve(eng.simulate_bulk)  # warm-up and capture
            (bulk[tag], bulk[tag + "_ids"]), bulk[tag + "_s"] = timed_serve(eng.simulate_bulk)
        same_bulk = (torch.equal(bulk["mesh"], bulk["meshless"])
                     and torch.equal(bulk["mesh_ids"], bulk["meshless_ids"])
                     and torch.equal(bulk["mesh"], out))
        used = torch.bincount(ids, minlength=3).tolist()
        log(phase, f"{precision} on {mesh}: simulate_switch of {n} showers, batch {batch}, tile "
            f"{tile}: torch.equal to the meshless engine {same_switch}, {out_s:.3f}s (meshless "
            f"{ref_s:.3f}s); kernel launches {counts}; showers per expert {used} [{card}]")
        log(phase, f"{precision} on {mesh}: simulate_bulk (dyn{', CUDA graph' if dev.type == 'cuda' else ''}"
            f"): torch.equal to the meshless engine and to the switch serve {same_bulk}, "
            f"{bulk['mesh_s']:.3f}s (meshless {bulk['meshless_s']:.3f}s; the first call, with "
            f"its capture, {bulk['mesh_capture_s']:.3f}s) [{card}]")
        if not (same_switch and same_bulk):
            fail(f"{precision}: the serve on the mesh differs from the meshless engine")
        if dev.type == "cuda":
            if min(counts[k] for k in names) <= 0:
                fail(f"the {precision} serve on the mesh did not launch {names}: {counts}")
            off = [k for k in names if counts.get(f"{k} on conv_mma", counts[k]) != counts[k]
                   or counts.get(f"{k} on clusters", counts[k]) != counts[k]]
            if off:
                fail(f"the {precision} serve on the mesh ran {off} off the tensor cores or "
                     f"their plan's clusters: {counts}")
        if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (n, 56, 30):
            fail(f"{precision} on the mesh: showers not finite of shape ({n}, 56, 30)")
        for k, v in counts.items():  # the launches of the path's kernels, and where they ran
            if k.split(" on ")[0] in names:
                launches[k] = launches.get(k, 0) + v
        rec[precision] = {"switch_s": out_s, "switch_meshless_s": ref_s, "bulk_s": bulk["mesh_s"],
                          "bulk_meshless_s": bulk["meshless_s"],
                          "bulk_capture_s": bulk["mesh_capture_s"], "launches": counts,
                          "routing": used}
        del engines, bulk
    return launches, rec


FORM_SETTINGS = (("INT8_CONV0_IMPL", "naive"), ("INT8_CONV1_IMPL", "phase"),
                 ("INT8_CONV2", False), ("DEQUANT_DTYPE", "bfloat16"))


def int8_forms(gp, cfg, router, dev, rehearse, card, seed):
    """Phase 23 (b): each of ``proton_fast``'s int8 switch settings on the
    ``int8`` serve of ``gp`` (``FORMS_SERVE``) against the default
    forms on the same noise, by JAX's rule (``tests/test_proton_fast.py:269``):
    routing identical, per-shower log1p sums within rtol 0.1. Returns the
    record."""
    import numpy as np
    import torch

    import zdcsim_torch.models.proton_fast as pf
    from zdcsim_torch.inference.engine import FastSim

    phase = "23 mesh"
    n, batch, tile = REHEARSE_FORMS if rehearse else FORMS_SERVE
    g = torch.Generator().manual_seed(seed + 231)
    cond, noise = torch.randn((n, 9), generator=g), torch.randn((n, 10), generator=g)

    def serve():
        eng = FastSim(gp, router, batch_size=batch, precision="int8", device=dev, cfg=cfg)
        eng._build_switch(tile=tile)
        t = time.perf_counter()
        imgs, ids = eng.simulate_switch(cond, noise=noise, return_experts=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return imgs, ids, time.perf_counter() - t

    what = "teacher" if cfg is None else f"w={cfg.model.generator.width} student"
    base, base_ids, base_s = serve()
    ref = log1p_sums(base)
    rec = {"default_s": base_s}
    for name, value in FORM_SETTINGS:
        saved = getattr(pf, name)
        setattr(pf, name, getattr(torch, value) if name == "DEQUANT_DTYPE" else value)
        try:
            imgs, ids, secs = serve()
        finally:
            setattr(pf, name, saved)
        rel = float((np.abs(log1p_sums(imgs) - ref) / np.abs(ref)).max())
        same = torch.equal(ids, base_ids)
        finite = bool(torch.isfinite(imgs).all()) and float(imgs.min()) >= 0
        log(phase, f"int8 with {name}={value!s} vs the default forms, {n} {what} showers: "
            f"routing identical {same}; max rel diff of per-shower log1p sums {rel:.4f} (rtol "
            f"0.1); {secs:.3f}s (default {base_s:.3f}s) [{card}]")
        if not (same and finite and rel <= 0.1):
            fail(f"int8 with {name}={value} disagrees with the default forms")
        rec[f"{name}={value}"] = {"max_rel": rel, "s": secs}
    return rec


def native_prep(rehearse, card, seed):
    """Phase 23 (c): the host C++ prep library built with this host's g++
    (the phase fails if it does not build) and held against the numpy
    versions on ``NATIVE_IMAGES`` random 56x30 images (``REHEARSE_NATIVE`` in
    the rehearsal): photon sums of photon
    counts, argmax coordinates and the row gather equal, ``log1p`` within
    two ulp, the group standard deviation within 1e-5. Returns the record."""
    import numpy as np

    from zdcsim_torch import native
    from zdcsim_torch.native import build

    phase = "23 mesh"
    t = time.perf_counter()
    try:
        path = build.build()
    except RuntimeError as e:
        fail(f"the host C++ prep library did not build: {e}")
    build_s = time.perf_counter() - t
    if not native.available():
        fail("the host C++ prep library built but did not load")
    rng = np.random.default_rng([seed, 23])
    n = REHEARSE_NATIVE if rehearse else NATIVE_IMAGES
    x = rng.poisson(2.0, (n, 56, 30)).astype(np.float32)
    groups = rng.integers(0, n // 4, n)
    idx = rng.integers(0, n, n)
    flat = x.reshape(n, -1)
    arg = flat.argmax(axis=1)

    def numpy_std():
        out = np.zeros(n)
        f64 = np.log1p(flat).astype(np.float64)
        for g in np.unique(groups):
            sel = np.flatnonzero(groups == g)
            if sel.size > 1:
                out[sel] = f64[sel].std(axis=0).sum()
        return out.astype(np.float32)

    cases = {
        "photon_sums": (lambda: native.photon_sums(x), lambda: flat.sum(axis=1), 0),
        "max_coords": (lambda: native.max_coords(x),
                       lambda: np.stack([arg // 30, arg % 30], 1).astype(np.float32), 0),
        "gather_rows": (lambda: native.gather_rows(x, idx), lambda: x[idx], 0),
        "log1p": (lambda: native.log1p_(x.copy()), lambda: np.log1p(x), "2 ulp"),
        "group_pixel_std": (lambda: native.group_pixel_std(np.log1p(x), groups), numpy_std, 1e-5),
    }
    rec = {"build_s": build_s, "library": os.path.basename(path)}
    for name, (ours, ref, tol) in cases.items():
        t = time.perf_counter()
        a = ours()
        ours_s = time.perf_counter() - t
        t = time.perf_counter()
        b = ref()
        ref_s = time.perf_counter() - t
        if tol == "2 ulp":
            ok = a.shape == b.shape and bool((np.abs(a.view(np.int32) - b.view(np.int32)) <= 2).all())
        else:
            ok = a.shape == b.shape and bool((np.abs(a - b) <= tol).all())
        err = float(np.abs(a.astype(np.float64) - b).max())
        log(phase, f"host C++ {name} on {n} images [56, 30] vs numpy: max |diff| {err:.3e} "
            f"(allowed {tol}), {ours_s * 1e3:.2f} ms (numpy {ref_s * 1e3:.2f} ms)")
        if not ok:
            fail(f"the host C++ {name} disagrees with numpy beyond {tol}")
        rec[name] = {"ms": ours_s * 1e3, "numpy_ms": ref_s * 1e3, "max_abs_diff": err}
    log(phase, f"host C++ prep library {os.path.basename(path)} built in {build_s:.2f}s with "
        f"this host's g++ [{card}]")
    return rec


def mesh_phase(gp, router, dev, rehearse, card, seed):
    """Phase 23: the sharded serve on a world of one (NCCL on the card, gloo
    in-process in the rehearsal, a ``file://`` store in a temporary
    directory), item 3's int8 forms and the host C++ prep library; a
    ``{"mesh": ...}`` line records it. The rehearsal serves the w=0.125
    student on ``int8_pallas`` alone (the fused precisions take full width
    only) and holds its int8 forms. Returns the meshed serves' kernel
    launches."""
    import tempfile

    import torch.distributed as dist

    from zdcsim_torch.config import load_config
    from zdcsim_torch.parallel import init_world, make_mesh
    from zdcsim_torch.utils.artifact import load_serving_artifact

    if rehearse:
        sp, _, _, meta = load_serving_artifact(STUDENT)
        trees = {"int8_pallas": (sp, load_config([f"model.generator.width={meta['width']}"]))}
    else:
        trees = {"int8_pallas": (gp, None), "int8_fused": (gp, None)}

    phase = "23 mesh"
    store = tempfile.mkdtemp(prefix="zdcsim_mesh_")
    device = "cpu" if rehearse else None
    t = time.perf_counter()
    try:
        init_world(0, 1, "file://" + os.path.join(store, "store"), device)
        try:
            mesh = make_mesh(1, device=device)
            world_s = time.perf_counter() - t
            log(phase, f"{mesh} on {dist.get_backend()} in {world_s:.2f}s")
            launches, rec = mesh_serves(trees, router, mesh, dev, rehearse, card, seed)
            rec["world_s"] = world_s
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    rec["int8_forms"] = int8_forms(*trees["int8_pallas"], router, dev, rehearse, card, seed)
    rec["native"] = native_prep(rehearse, card, seed)
    log(phase, f"the serves on the mesh launched {launches} [{card}]")
    print(json.dumps({"mesh": rec}), flush=True)
    return launches


def switch_bf16(tile, rehearse):
    """Phase 19's switch bf16 options at ``tile``, ``dispatch_remat`` on the
    card (``torch.utils.checkpoint`` imports ``torch._dynamo``, which looks
    for pandas: not under the rehearsal's guard)."""
    return ["train.dispatch=switch", "train.precision=bf16", f"train.dispatch_tile={tile}",
            f"train.dispatch_remat={not rehearse}"]


def mesh_steps(mesh, dev, rehearse, card, seed):
    """Phase 24 (a): one dense f32 step and one switch bf16 step (tile
    ``MESH_TRAIN``'s, ``dispatch_remat``) of the proton MoE on the mesh
    (``build_train_step(mesh=...)``) from one seeded state, batch and set of
    draws, each ``torch.equal`` leaf by leaf to the meshless step on the
    same inputs (a mesh of one makes every collective the identity), and
    the switch step on the mesh run twice from one state ``torch.equal``.
    Returns ``{step: record}``."""
    import numpy as np
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.models import build_moe
    from zdcsim_torch.parallel import batch_sharding, place_tree, shard_state
    from zdcsim_torch.train.state import init_state
    from zdcsim_torch.train.step import build_train_step, draw_step_noise

    phase = "24 mesh train"
    width, n_exp, batch, tile = REHEARSE_MESH_TRAIN if rehearse else MESH_TRAIN
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng([seed, 24])
    data = {"real": rng.random((batch, 56, 30, 1)) * 3, "cond": rng.standard_normal((batch, 9)),
            "std": rng.random((batch, 1)), "intensity": rng.random((batch, 1)) * 500,
            "positions": rng.random((batch, 2)) * 20}
    data = {k: torch.as_tensor(v.astype("float32"), device=dev) for k, v in data.items()}
    model = [f"model.generator.width={width}", f"model.n_experts={n_exp}",
             f"train.batch_size={batch}"]
    modules = build_moe(load_config(model))
    state = init_state(modules, load_config(model), seed, dev)
    local, rows = shard_state(mesh, state, n_exp), place_tree(batch_sharding(mesh), data)
    rec = {}
    for name, over in (("dense f32", ["train.dispatch=dense", "train.precision=f32"]),
                       ("switch bf16", switch_bf16(tile, rehearse))):
        cfg = load_config(model + over)
        plain, meshed = build_train_step(modules, cfg), build_train_step(modules, cfg, mesh)
        draws = draw_step_noise(torch.Generator(device=dev).manual_seed(seed + 24), modules,
                                batch, dev, plain.switch)
        ref = plain(state, data, draws, 0)
        sync()
        t = time.perf_counter()
        ours = meshed(local, rows, draws, 0)
        sync()
        step_s = time.perf_counter() - t
        bad = unequal_leaves(ours, ref)
        n_leaves = len(output_leaves(ours))
        log(phase, f"{name} step of the proton MoE width {width}, E={n_exp}, batch {batch} on "
            f"{mesh}: {step_s:.4f}s; torch.equal to the meshless step leaf by leaf {not bad} "
            f"({n_leaves - len(bad)} of {n_leaves} leaves equal); gen_loss "
            f"{float(ours[1]['gen_loss']):.6f} [{card}]")
        if bad:
            fail(f"the {name} step on the mesh differs from the meshless step: {bad[:5]}")
        if not all(bool(torch.isfinite(v).all()) for v in ours[1].values()):
            fail(f"the {name} step on the mesh: non-finite metrics")
        if name == "switch bf16":
            check_repeat(phase, f"the {name} step on the mesh", ours,
                         meshed(local, rows, draws, 0), card)
        rec[name] = {"s": step_s, "gen_loss": float(ours[1]["gen_loss"]), "leaves": n_leaves}
        del ref, ours
    return rec


def mesh_loop(dev, rehearse, card, seed):
    """Phase 24 (b): ``train()`` on the mesh (``MESH_LOOP``: 2 switch bf16
    steps, 1 epoch, an eval on kernel E, a checkpoint of the gathered state
    written by rank 0), the checkpoint restored with no mesh ``torch.equal``
    to the state the run returned, and served by ``FastSim.from_checkpoint`` on
    ``int8_pallas`` (A-D) and ``int8_fused`` (H; full width only) in
    agreement with each other. Returns ``(launches by kernel, record)``: E's
    from the loop (its evals), A-D's and H's from the serves."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.inference.engine import FastSim
    from zdcsim_torch.train.checkpoint import _flatten, restore_checkpoint
    from zdcsim_torch.train.loop import train

    phase = "24 mesh train"
    width, n_exp, batch, n_events = REHEARSE_MESH_LOOP if rehearse else MESH_LOOP
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tmp = tempfile.mkdtemp(prefix="zdcsim_mesh_loop_")
    every = kernel_wrappers()
    launches, rec = {}, {}
    try:
        cfg = load_config([f"model.generator.width={width}", f"model.n_experts={n_exp}",
                           f"train.batch_size={batch}",
                           *switch_bf16((REHEARSE_MESH_TRAIN if rehearse else MESH_TRAIN)[3],
                                        rehearse),
                           "dataset.synthetic=true",
                           f"dataset.synthetic_n_samples={n_events}", "train.seed=7",
                           "eval.fused_epilogue=true", "train.epochs=1", "train.eval_every=1",
                           "train.save_experiment_data=true", "train.ws_threshold_model_save=1e30",
                           f"train.save_experiments_dir={tmp}/", "config.run_name=mesh"])
        reset_counts(every)
        t = time.perf_counter()
        history, state = train(cfg, return_state=True, device=dev)
        sync()
        rec["train_s"] = time.perf_counter() - t
        counts = read_counts(every)
        e_counts = {k: v for k, v in counts.items() if k.startswith("expm1_channel_sums")}
        launches.update(e_counts)
        h = history[-1]
        log(phase, f"train() on the mesh: 1 epoch of switch bf16 steps "
            f"{h.get('epoch_time', 0.0):.2f}s at width "
            f"{width}, E={n_exp}, batch {batch} on {n_events} events in {rec['train_s']:.2f}s; "
            f"gen_loss {h['gen_loss']:.4f}, ws_mean {h['ws_mean']!r}; the eval launched E "
            f"{e_counts} [{card}]")
        if len(history) != 1 or not all(np.isfinite(h[k]) for k in ("gen_loss", "ws_mean")):
            fail(f"the loop on the mesh: {history}")
        if dev.type == "cuda" and counts.get("expm1_channel_sums", 0) <= 0:
            fail(f"the loop's eval on the mesh did not launch E: {counts}")
        models = f"{cfg.config.experiment_dir}/models"
        restored = restore_checkpoint(models, 0, state)
        a, b = _flatten(restored), _flatten(state)
        same = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
        log(phase, f"the checkpoint of the gathered state restored with no mesh: "
            f"torch.equal to the state the run returned {same} ({len(a)} tensors)")
        if not same:
            fail("the mesh run's checkpoint differs from its gathered state")
        del restored, a, b, state
        n, serve_batch, tile = REHEARSE_MESH_LOOP_SERVE if rehearse else MESH_LOOP_SERVE
        cond = torch.randn((n, 9), generator=torch.Generator().manual_seed(seed + 240))
        ref = None
        for precision in ("int8_pallas",) + (() if rehearse else ("int8_fused",)):
            names = KERNEL_PATHS[precision]
            eng = FastSim.from_checkpoint(cfg, models, 0, precision=precision,
                                          batch_size=serve_batch, device=dev)
            eng._build_switch(tile=tile)
            wrappers = {k: every[k] for k in names}
            reset_counts(wrappers)
            imgs, ids = eng.simulate_switch(cond, return_experts=True,
                                            generator=torch.Generator(device=dev).manual_seed(seed))
            sync()
            c = read_counts(wrappers)
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
            log(phase, f"FastSim.from_checkpoint of the mesh run on {precision} with no mesh: "
                f"{n} showers, routing {torch.bincount(ids, minlength=n_exp).tolist()}, kernel "
                f"launches {c} [{card}]")
            if dev.type == "cuda" and min(c[k] for k in names) <= 0:
                fail(f"the {precision} serve of the mesh run's checkpoint did not launch {names}")
            if tuple(imgs.shape) != (n, 56, 30) or not bool(torch.isfinite(imgs).all()):
                fail(f"{precision}: the checkpoint's showers not finite of shape ({n}, 56, 30)")
            if ref is None:
                ref = (log1p_sums(imgs), ids.cpu().numpy())
            else:
                check_agrees(phase, f"{precision} from the mesh run's checkpoint", imgs, ids, *ref,
                             ref_name="its int8_pallas serve")
            rec[precision] = {"launches": c}
            del eng, imgs, ids
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, rec


def mesh_train_phase(dev, rehearse, card, seed):
    """Phase 24: training on the ``(data, expert)`` mesh of a world of one
    (NCCL on the card, gloo in-process in the rehearsal, a ``file://`` store
    in a temporary directory): :func:`mesh_steps` and :func:`mesh_loop`; a
    ``{"mesh_train": ...}`` line records the phase. Returns the loop's and
    the serves' kernel launches."""
    import tempfile

    import torch.distributed as dist

    from zdcsim_torch.parallel import init_world, make_mesh

    phase = "24 mesh train"
    store = tempfile.mkdtemp(prefix="zdcsim_mesh_train_")
    device = "cpu" if rehearse else None
    t = time.perf_counter()
    try:
        init_world(0, 1, "file://" + os.path.join(store, "store"), device)
        try:
            mesh = make_mesh(1, device=device)
            log(phase, f"{mesh} on {dist.get_backend()} in {time.perf_counter() - t:.2f}s")
            rec = {"steps": mesh_steps(mesh, dev, rehearse, card, seed)}
            launches, rec["loop"] = mesh_loop(dev, rehearse, card, seed)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    rec["s"] = time.perf_counter() - t
    log(phase, f"training on the mesh launched {launches} in {rec['s']:.2f}s [{card}]")
    print(json.dumps({"mesh_train": rec}), flush=True)
    return launches


def api_phase(gp, rp, dev, rehearse, card, seed):
    """Phase 25: the registry's modules built on the device, the teacher
    (the w=0.125 student in the rehearsal) routed and served through
    ``build_model``'s router and ``Generator`` against the engine's float
    path, ``torch.equal``, and ``ExpertDense`` against its CPU result; a
    ``{"api": ...}`` line records it. None of A-H may launch."""
    import numpy as np
    import torch

    from zdcsim_torch.config import load_config
    from zdcsim_torch.convert import expert, from_jax_params, to_state_dict, tree_to_torch
    from zdcsim_torch.inference import FastSim
    from zdcsim_torch.models import MODEL_REGISTRY, build_model
    from zdcsim_torch.models.layers import ExpertDense
    from zdcsim_torch.train.step import f32_matmuls
    from zdcsim_torch.utils.artifact import load_serving_artifact

    phase = "25 api"
    wrappers = kernel_wrappers()
    before = read_counts(wrappers)
    rec = {"params": {}}
    t = time.perf_counter()
    for name in MODEL_REGISTRY:
        m = build_model(name, device=None if dev.type == "cuda" else dev)
        where = {p.device.type for p in m.parameters()}
        if where != {dev.type}:
            fail(f"build_model({name!r}) put parameters on {where}, not {dev.type}")
        rec["params"][name] = sum(p.numel() for p in m.parameters())
    rec["build_s"] = time.perf_counter() - t
    log(phase, f"build_model of the {len(MODEL_REGISTRY)} registry names on {dev.type} in "
        f"{rec['build_s']:.2f}s: " + ", ".join(f"{k} {v:,d}" for k, v in rec["params"].items()))

    cfg = None
    if rehearse:
        gp, _, rp, meta = load_serving_artifact(STUDENT)
        cfg = load_config([f"model.generator.width={meta['width']}"])
    which = "the w=0.125 student" if rehearse else "the teacher"
    eng = FastSim(gp, rp, batch_size=API_ROWS, precision="f32", device=dev, cfg=cfg)
    gen_tree, router_sd = from_jax_params(gp, rp)
    m = (cfg or load_config()).model
    router = build_model(m.router.version, {"n_experts": eng.n_experts}, device=dev).eval()
    router.load_state_dict(router_sd)
    gen = build_model("proton.generator", {"noise_dim": eng.noise_dim, "cond_dim": eng.cond_dim,
                                           "width": float(m.generator.width)}, device=dev).eval()
    rng = np.random.default_rng([seed, 25])
    cond = torch.from_numpy(rng.standard_normal((API_ROWS, eng.cond_dim), dtype="float32")).to(dev)
    noise = torch.from_numpy(rng.standard_normal((API_ROWS, eng.noise_dim),
                                                 dtype="float32")).to(dev)
    t = time.perf_counter()
    with torch.no_grad():
        gates, logits = router(cond)
        ref_gates, ref_logits = eng.router(cond)
        routed = torch.equal(gates, ref_gates) and torch.equal(logits, ref_logits)
        routed_rows = torch.bincount(logits.argmax(-1), minlength=eng.n_experts).tolist()
        equal = True
        for e in range(eng.n_experts):  # every expert on every row
            gen.load_state_dict(to_state_dict(tree_to_torch(expert(gen_tree, e), device=dev)))
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                ours = torch.expm1(gen(noise, cond)[..., 0])
            ref = eng._decode_one(e, cond, noise)
            equal = equal and ours.shape == ref.shape and torch.equal(ours, ref)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec["serve_s"] = time.perf_counter() - t
    rec["routed_rows"] = routed_rows
    log(phase, f"{which}'s router and Generator from build_model on {API_ROWS} rows (routed "
        f"{routed_rows}): routing torch.equal to the engine's {routed}; each of the "
        f"{eng.n_experts} experts' showers torch.equal to the engine's float Generator path "
        f"{equal} [{card}]")
    if not routed or not equal:
        fail("build_model's router or Generator disagrees with the engine's float path")

    e, b, i, o = EXPERT_DENSE
    torch.manual_seed(seed)
    layer = ExpertDense(e, o, in_features=i)
    torch.nn.init.normal_(layer.bias)
    x = torch.randn(e, b, i)
    with torch.no_grad(), f32_matmuls():
        cpu = layer(x)
        layer, xd = layer.to(dev), x.to(dev)
        out = layer(xd).cpu()
        ms = time_ms(lambda: layer(xd), 20) if dev.type == "cuda" else None
    k = layer.kernel.detach().cpu().double()
    exact = torch.stack([x[j].double() @ k[j] for j in range(e)]) + layer.bias.detach().cpu(
        ).double()
    errs = (float((out - cpu).abs().max()), float((out.double() - exact).abs().max()))
    ok = (torch.allclose(out, cpu, rtol=1e-5, atol=1e-5)
          and torch.allclose(out.double(), exact, rtol=1e-5, atol=1e-5))
    rec["expert_dense"] = {"shape": list(EXPERT_DENSE), "max_abs_err_cpu": errs[0],
                           "max_abs_err_f64": errs[1], "ms": ms}
    log(phase, f"ExpertDense [{e}, {b}, {i}] x [{e}, {i}, {o}] on {dev.type}: max |err| "
        f"{errs[0]:.3g} against the CPU, {errs[1]:.3g} against a float64 per-expert matmul "
        f"(rtol 1e-5) {ok}" + (f", {ms:.4f} ms" if ms is not None else "") + f" [{card}]")
    if not ok:
        fail("ExpertDense disagrees with its CPU result or the per-expert matmul")
    after = read_counts(wrappers)
    if after != before:
        fail(f"phase 25 launched kernels of A-H: {before} -> {after}")
    log(phase, "kernel launches none of A-H")
    print(json.dumps({"api": rec}), flush=True)


def phase8_router(seed, rows_a=8, rows_b=8, n=REHEARSE_SERVE[0]):
    """The router that phase 8 draws from ``--seed`` in the rehearsal,
    without phases 3-8: the draws of phases 3, 4 and 8 from the seed's
    stream replayed (the same calls on the same shapes and dtypes, the
    teacher's widths read from its artifact's two leaves), then the router
    drawn from the stream as phase 8 draws it."""
    import numpy as np

    with np.load(TEACHER) as f:  # the teacher's Dense_1 width and Conv_0's input channels
        feat = f["gen_params|MLPBlock_1|LayerNorm_0|scale"].shape[-1]
        cin = f["gen_params|Conv_0|kernel"].shape[-2]
    rng = np.random.default_rng(seed)
    rng.standard_normal((rows_a, feat), dtype="float32")  # phase 3
    rng.integers(-127, 128, (rows_b, 18, 10, cin), dtype="int8")  # phase 4
    rng.standard_normal(rows_b)
    rng.standard_normal((n, 9), dtype="float32")  # phase 8's conditions and noise
    rng.standard_normal((n, 10), dtype="float32")
    return seeded_router(rng)


def run_rehearsal(parts, gp, rp, rng, dev, card, seed) -> int:
    """The CPU rehearsal of ``parts`` (``REHEARSE_PARTS``), each recomputing
    from ``seed`` what it needs of another: the train part the gate's split
    (phase 10), the mesh part phase 8's router (:func:`phase8_router`)."""
    import numpy as np

    router = split = None
    if "serve" in parts:
        timed("3 A", check_kernel_a, gp, rng, dev, 8, seed)
        timed("4 B", check_kernel_b, gp, rng, dev, 8, seed)
        rng_cd = np.random.default_rng([seed, 1])
        timed("5 C", check_kernel_c, gp, rng_cd, dev, 4, seed)
        timed("6 D", check_kernel_d, gp, rng_cd, dev, 2, seed)
        timed("7 conv_i8", check_conv_i8, gp, rng_cd, dev, 1)
        gh_in = timed("7b G, H", check_kernels_gh, gp, rng_cd, dev, 1)
        _, conv_out = timed("7b G, H", check_conv_stages, *gh_in[1:4], dev)
        timed("7b G, H", check_norm_stages, *gh_in[1:4], conv_out, dev)
        _, router = timed("8 serve", serve, gp, rp, rng, dev, *REHEARSE_SERVE, card, seed)
        cond, real, _, split = timed("10 E", gate_data, dev, True)
        timed("11 F", kernel_f_path, gp, router, dev, REHEARSE_F, card)
        timed("12 float serves", float_serves, gp, router, dev, *REHEARSE_FLOAT, card, seed)
        timed("13 gate", gates, (cond[:REHEARSE_GATE], real[:REHEARSE_GATE]), dev, True, card)
        timed("15 engine API", engine_api, gp, router, dev, True, card, seed)
        timed("16 neutron", neutron, dev, True, card, seed)
    if "train" in parts:
        if split is None:
            cond, real, _, split = timed("10 E", gate_data, dev, True)
        timed("17 train", train, split, dev, True, card, seed)
        loop_rec = timed("18 loop", loop, dev, True, card, seed, keep_run=True)
        try:
            timed("19 options", options, split, dev, True, card, seed)
            timed("20 neutron train", neutron_train, dev, True, card, seed)
            timed("21 distill", distill_phase, gp, rp, split, cond, real, loop_rec, dev, True,
                  card, seed)
        finally:
            shutil.rmtree(loop_rec["tmp"], ignore_errors=True)
        timed("22 real data", real_data, dev, True, card, seed)
    if "mesh" in parts:
        replayed = phase8_router(seed)
        if router is not None and not all(
                np.array_equal(router[k][p], replayed[k][p]) for k in router for p in router[k]):
            fail("phase8_router does not replay phase 8's router")
        timed("23 mesh", mesh_phase, gp, router or replayed, dev, True, card, seed)
        timed("24 mesh train", mesh_train_phase, dev, True, card, seed)
        timed("25 api", api_phase, None, None, dev, True, card, seed)
    log_phase_times()
    print(json.dumps({"rehearsal": True}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run phases 3-13 and 15-25 on the CPU at small sizes with the "
                         "plain versions")
    ap.add_argument("--rehearse-part", choices=sorted(REHEARSE_PARTS),
                    help="rehearse one part on the CPU, recomputing what it needs from --seed: "
                         + ", ".join(f"{k} (phases {v})" for k, v in REHEARSE_PARTS.items()))
    ap.add_argument("--profile", action="store_true",
                    help="profile one serve of each kernel path with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    rehearsing = args.rehearse_cpu or args.rehearse_part is not None
    if not rehearsing and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    from zdcsim_torch.ops import _build
    from zdcsim_torch.utils.artifact import load_serving_artifact

    if rehearsing:
        dev, card = torch.device("cpu"), "cpu rehearsal"
    else:
        dev = torch.device("cuda")
        card = card_line()
        log("1 card", f"torch.cuda.get_device_name(0)={torch.cuda.get_device_name(0)!r} "
            f"device_count={torch.cuda.device_count()} torch {torch.__version__} "
            f"cuda {torch.version.cuda}")
        print(f"card: {card}", flush=True)
        t = time.perf_counter()
        lib_path, build_log = _build.build()
        _build.library()
        log("2 build", f"{time.perf_counter() - t:.2f}s -> {os.path.relpath(lib_path, HERE)}")
        for line in build_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
        sass = library_sass(lib_path)
        if sass is None:
            log("2 build", "no cuobjdump beside nvcc: SASS instruction counts not measured")
        else:
            for fn, c in bulk_sass_counts(sass).items():
                ops = ", ".join(f"{op} {c[op]}" for op in ("MUFU", "LDS", "FFMA", "FADD", "FMUL",
                                                          "FSETP", "FSEL", "FRND"))
                log("2 build", f"SASS of {fn}: {sum(c.values())} instructions ({ops}); a lane "
                    f"sums 52.5 pixels of a 56x30 shower, 60.5 of 44x44")
            counts = conv_sass_counts(sass)
            n_mma = 0
            for fn, c in counts.items():
                log("2 build", f"SASS of {fn}: IMMA {c['IMMA']}, IGMMA {c['IGMMA']}, IDP4A "
                    f"{c['IDP4A']}")
                if fn.startswith("conv_mma_kernel"):
                    n_mma += 1
                    if c["IGMMA"] == 0 or c["IMMA"] or c["IDP4A"]:
                        fail(f"{fn} does not run on wgmma alone: {c}")
            # G's and H's source launches 2 instantiations, B's and D's 4 each
            if n_mma < 10:
                fail(f"the library's SASS holds {n_mma} conv_mma_kernel instantiations, not 10")

    rng = np.random.default_rng(args.seed)
    parts = ((args.rehearse_part,) if args.rehearse_part else tuple(REHEARSE_PARTS)
             ) if rehearsing else ()
    gp = rp = None
    if not rehearsing or "serve" in parts:  # the rehearsal's later parts serve the student
        gp, _, rp, _ = load_serving_artifact(TEACHER)
        log("3 kernel A", "teacher artifact loaded")
    PHASE_S["setup"] = time.perf_counter() - T0  # imports, card, build, artifact
    if rehearsing:
        return run_rehearsal(parts, gp, rp, rng, dev, card, args.seed)
    rehearse = False
    a_in = timed("3 A", check_kernel_a, gp, rng, dev, A_ROWS, args.seed)
    b_in = timed("4 B", check_kernel_b, gp, rng, dev, B_ROWS, args.seed)
    # the later checks draw from a stream of their own, so the serve's
    # conditions and router stay those that phases 3-4 leave
    rng_cd = np.random.default_rng([args.seed, 1])
    c_in = timed("5 C", check_kernel_c, gp, rng_cd, dev, C_ROWS, args.seed)
    d_in = timed("6 D", check_kernel_d, gp, rng_cd, dev, D_ROWS, args.seed)
    timed("7 conv_i8", check_conv_i8, gp, rng_cd, dev, 2)
    gh_in = timed("7b G, H", check_kernels_gh, gp, rng_cd, dev, GH_ROWS)
    conv_in, conv_out = timed("7b G, H", check_conv_stages, *gh_in[1:4], dev)
    stage_in = timed("7b G, H", check_norm_stages, *gh_in[1:4], conv_out, dev)
    del conv_out
    launches, router = timed("8 serve", serve, gp, rp, rng, dev, N_SHOWERS, SERVE_BATCH,
                             SERVE_TILE, card, args.seed, args.profile)
    rec = timed("9 kernel times", time_kernels, a_in[:3], b_in[:5], c_in[:3], d_in[:6],
                launches["int8_pallas"], (a_in[3], b_in[5], c_in[3], d_in[6]), card)
    timed("9 kernel times", sweep_clusters, rec, a_in[:3], c_in[:3], card)
    conv_ms = timed("9 kernel times", time_conv_stages, conv_in, card)
    stage_ms = timed("9 kernel times", time_norm_stages, stage_in, card)
    rec += timed("9 kernel times", time_fused, *gh_in[:4], launches, gh_in[4:], conv_ms, card,
                 stage_ms)
    cond, real, e_err, split = timed("10 E", gate_data, dev, rehearse)
    f_launches, f_bulk, f_err = timed("11 F", kernel_f_path, gp, router, dev, F_SHOWERS, card)
    timed("12 float serves", float_serves, gp, router, dev, FLOAT_SHOWERS, SERVE_BATCH,
          SERVE_TILE, card, args.seed)
    e_counts = timed("13 gate", gates, (cond, real), dev, rehearse, card)
    rec += timed("14 epilogue times", time_epilogues, e_counts, (f_launches, f_bulk),
                 (e_err, f_err), card)
    timed("15 engine API", engine_api, gp, router, dev, rehearse, card, args.seed, args.profile)
    e_case = timed("16 neutron", neutron, dev, rehearse, card, args.seed, args.profile)
    next(r for r in rec if r["name"] == "expm1_channel_sums")["cases"].append(e_case)
    timed("17 train", train, split, dev, rehearse, card, args.seed, args.profile)
    loop_rec = timed("18 loop", loop, dev, rehearse, card, args.seed, keep_run=True)
    try:
        timed("19 options", options, split, dev, rehearse, card, args.seed, args.profile)
        n_e, n_bulk = timed("20 neutron train", neutron_train, dev, rehearse, card, args.seed,
                            args.profile)
        gate_launches = timed("21 distill", distill_phase, gp, rp, split, cond, real, loop_rec,
                              dev, rehearse, card, args.seed)
    finally:
        shutil.rmtree(loop_rec["tmp"], ignore_errors=True)
    n_e22, n_bulk22 = timed("22 real data", real_data, dev, rehearse, card, args.seed)
    mesh_launches = timed("23 mesh", mesh_phase, gp, router, dev, rehearse, card, args.seed)
    train_launches = timed("24 mesh train", mesh_train_phase, dev, rehearse, card, args.seed)
    timed("25 api", api_phase, gp, rp, dev, rehearse, card, args.seed)
    e_rec = next(r for r in rec if r["name"] == "expm1_channel_sums")
    # the neutron loop's and the fixtures' evals are main paths of E too
    e_rec["launches"] += n_e + n_e22
    e_rec["bulk_launches"] += n_bulk + n_bulk22
    for r in rec:  # the run directory's gates, the mesh's serves and its loop: main paths too
        r["launches"] += sum(d.get(r["name"], 0) for d in (gate_launches, mesh_launches,
                                                           train_launches))
        if "cluster_launches" in r:
            r["cluster_launches"] += sum(d.get(f"{r['name']} on clusters", 0)
                                         for d in (gate_launches, mesh_launches, train_launches))
            if r["cluster_launches"] != r["launches"]:
                fail(f"{r['name']} ran a norm stage off its plan's clusters: "
                     f"{r['cluster_launches']} of {r['launches']} launches")
    e_rec["bulk_launches"] += sum(d.get("expm1_channel_sums on the bulk ring", 0)
                                  for d in (gate_launches, train_launches))
    e_rec["body"] = "bulk ring" if e_rec["bulk_launches"] == e_rec["launches"] else "direct"
    log_phase_times()
    log("done", f"wall {time.perf_counter() - T0:.2f}s [{card}]")
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
