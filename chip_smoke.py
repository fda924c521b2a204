"""Smoke run of the PyTorch/CUDA port (mpc_cbf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU (built for
sm_90a: an H100). It
1. prints the card (nvidia-smi name and power limit);
2. builds the CUDA kernels from csrc/ into build/kernels/ (one nvcc per
   source, started together) and times it; fails if ptxas reports a spill
   in an instance of the cluster kernel's register layout, of the folded
   kernel or of the tiled kernel's tensor-core loop (all hold their rows in
   registers);
3. holds every variant of the fused ADMM kernel against its plain PyTorch
   twin at 40 iterations to rtol = atol = 2e-4, each through the wrapper at
   a shape that takes it: folded at the fov flagship's shapes (43, 127,
   84; the main path) on 1001 and 3 lanes and for the step's longest phase
   of 150 iterations, tiled at the connectivity and λ₂/CLF connectivity
   shapes (1001 lanes: a ragged last block; 3 lanes: fewer than a block
   holds; 1001 lanes for the step's longest phase of 150 iterations), folded
   at the 32-agent connectivity shapes (36, 126, 62) on 1001 and 3 lanes
   (and for its longest phase, 50) and the 32-agent fov shapes (67, 151, 372)
   on 64 and 3 lanes and, on 64 lanes, for the 550 iterations of the step's
   longest phase, generic at the shapes (38, 128, 4) and the 3 lanes of
   run_sim --controller connectivity on a 3-robot team (step 17), at every
   connectivity team of the sweep (35 + R, 125 + R, 2R - 2) on 15 R lanes
   (step 21; R = 10 also for a 150-iteration phase) and at the 24-agent fov
   shapes (59, 143, 276) on 64 lanes; generic also launched by name at the
   fov flagship and the 32-agent connectivity shapes; cluster (one lane a
   thread-block cluster) at the fov teams of 40, 64, 96, 128 (the rows in
   registers; each also for the step's 550-iteration phase), 160, 256 (rows
   and C streamed from device memory; also a 256-lane chunk for 550
   iterations) and 400 agents (also for 550 iterations), the connectivity
   teams of 128, 256 (rows in registers, also for 550 iterations), 40 and
   320 robots, the 32-robot connectivity lane that run_sim's slack gives
   (67, 157, 62, the layout on one SM: one lane a block of 8 warps, two
   blocks an SM; also for its longest phase, 150; each cluster row logs the
   layout it ran in, from launches_by_layout), two synthetic shapes past
   every one-block layout (n = 162 and 165), and by name at the 32-agent fov
   shapes; every kernel but tiled takes the lane's float64 C, which the
   caller factors; a NaN lane that must leave every other lane bitwise
   untouched at each shape whose kernel shares a block or an SM between
   lanes, and at the cluster kernel's 256-robot, 256- and 400-agent lanes
   (the inputs carry inactive rows with rho = 1e-12 and bounds of +-1e20);
   then checks that every fov team of 2 to 512 agents and every
   connectivity team of 2 to 512 robots takes one of the four kernels (none
   raises), and that the tiled kernel takes exactly the shapes whose
   operand is WK;
4. times kernel and twin for each rho phase length of a control step (150 +
   50 cold, 32 + 32 warm) at 8192 fov (folded) and 32768 connectivity lanes
   (connectivity and λ₂/CLF: tiled), and at the lanes and phase lengths a
   launch of steps 7 and 7b gets: the folded kernel at 4096 lanes (4 x 50
   iterations) and at one lane chunk of 2048 (550 + 50 + 150 + 50), generic
   at the 3 lanes of one run_sim team (150 + 50 + 150 + 50), at each sweep
   team's 15 R lanes (the same phases) and at the 24-agent step's 768 lanes,
   generic at the 40- and 64-agent steps'
   launches and cluster at the 40-, 64-, 96-, 128- and 400-agent steps' (760,
   512, 96 and 512 lanes; a lane chunk of 256), at a lane chunk of a
   256-agent step and at one run_sim team of 128 and of 256 connectivity
   robots; for every kernel that takes C also
   the C builds of the step's phases (folded_c: cuBLAS and cuSOLVER), for
   tiled the Woodbury builds (woodbury); prints
   each time beside the loop's bound (portbench/roofline_k3.py::k3_bound_s:
   the least time of the iterations alone, C given, from the shapes and the
   card's peaks; the same bound whatever kernel runs the loop), and the
   microseconds and clocks of one iteration (at the SM clock nvidia-smi
   reads after the window; the log adds the barriers an iteration the source
   writes);
5. drives the main path (StructuredIMPC(FovIMPCCBF) with the structured
   ADMM (iters 200, tail 64) on 8192 lanes of bench.py's fov recipe),
   checks that it launched the folded kernel 4 times per call and that every
   flyable lane is finite, times 5 calls, runs the same call through the
   plain loop: the usable-lane rates must agree within 1 point and stay at
   or above 0.70;
6. runs one connectivity control step at 32768 lanes (tiled kernel, 4
   launches, usable >= 0.99), its stage split, and the same step through the
   plain loop (success flags equal on at least 99 % of the lanes);
7. runs one 32-agent control step of benchmarks/swarm.py's recipe (128
   scenarios x 32 agents = 4096 lanes) through the ADMM: connectivity (100
   iterations; the folded kernel, 4 launches, usable >= 0.99) and fov (600,
   tail 200, neighbours masked to the sensing range; the folded kernel, one
   lane chunk, 4 launches): finite flyable lanes, time,
   usable rate (>= 0.97) and peak device memory; the fov step also with a
   sync around each stage, under torch.profiler, and through the plain
   loop (usable rates within 0.01, success flags equal on 99 % of lanes);
   then the same two steps through the f32 IPM (IPM_F32_ENTRY, the
   reference's default swarm solver), one call each beside the ADMM's
   numbers;
7b. runs one fov step of benchmarks/swarm.py's recipe at another team size
   (its second argument): 32 rings of 24 agents, a shape without a compiled
   kernel, through the generic kernel (4 launches, asserted) and through the
   plain loop: usable rates within 0.01, success flags equal on 99 % of the
   lanes; then 19 rings of 40 agents (760 lanes) and 8 rings of 64 (512
   lanes, one lane chunk) through the cluster kernel (4 launches each,
   asserted; timed alone at those lanes: the cluster_fov40 and cluster_fov64
   rows), one ring of 96 agents (96 lanes), 4 rings of
   128 (512 lanes, one lane chunk) and one ring of 400 (400 lanes, two lane
   chunks of 256 and 144: rows and C streamed) through the cluster kernel (4,
   4 and 8 launches, asserted), each also through the plain loop (usable
   rates within 0.01, flags equal on 99 % of the lanes), the wall time the
   median of 3 calls, with the kernel's share, bound, twin and C builds
   beside it and the peak device memory (the 128- and 400-agent steps also
   with a sync around each stage);
8. holds the f64 IPM on the card against the same solve on the host CPU
   (512 fov lanes: converged flags, z to 1e-3);
9. drives the f32 Mehrotra IPM (IPM_F32_ENTRY, bench.py's default solver)
   on the fov recipe at 8192 lanes: 3 timed calls after a warm-up, the
   usable rate (bar 0.98), peak device memory, one call with a sync around
   each stage, one call under torch.profiler (kernel launches per call,
   device share of cholesky_ex + the triangular solves) and one call at
   chunk = 0;
10. the f32 IPM on connectivity at 32768 lanes (usable bar 0.99), one timed
    call;
11. HYBRID_PROD (f32 entry + 12-iteration f64 tail) on the fov recipe at
    8192 lanes: certified lanes must be usable lanes, certified rate >= 0.95;
12. a closed loop: MultiAgentSim(structured=True) with IPM_F32_ENTRY, 8 fov
    robots x 1024 scenarios (random_instance seeds 0..1023) = 8192 lanes a
    step, 10 steps (1 s): every trajectory must be finite, and the mean
    per-step solver success and the instance_success share are reported
    (not timed: the benchmark's fov8.fleet cell times this traffic);
13. the 4-robot connectivity step with the λ₂/CLF rows
    (ConnectivityIMPCCBF(enable_connectivity=True), shapes (36, 126, 14))
    through StructuredIMPC at 32768 lanes: it must launch the tiled kernel
    4 times a call (the shape has an instantiation of its own); the kernel
    is held against the twin at that shape and timed alone at those lanes;
14. the dense ADMM (ops/qp/admm.py, ADMMConfig(iters=200) as run_sim builds
    it) against the same solver in float64 on the card: the fov flagship's
    QPs (n = 43, m = 211) at 8192 lanes and the cbf-fov QPs (n = 10, m = 44)
    at 32768 lanes: converged share, time, launches per solve; then the dense
    IMPC step FovIMPCCBF.optimize at 8192 lanes (usable share);
15. the batched float32 eigh of 4096 8-robot Laplacians against a float64
    eigh on the host;
16. closed loops at the width of a sweep (circle_rotate_instance(8, 4.0)
    with 0.05 m start noise, apps/sweep.py:60-70), built by run_sim.build_sim
    from configs/base_config.json: CBFOnlySim cbf-fov (slack on) 8 x 4096
    for 30 steps, with one step under torch.profiler, the same with the
    particle filter (229376 filters of 256 particles), CBFOnlySim
    cbf-connectivity 8 x 4096 for 30 steps, BezierMPCSim 8 x 1024 for 20
    steps, MultiAgentSim(structured=False) 8 x 256 for 5 steps: finite
    trajectories, ms per step, solver success, instance_success share,
    minimum pairwise distance, peak device memory;
17. the command line: mpc_cbf_torch.apps.run_sim.main on
    configs/baseline/3r/rotate.json for 8 s of flight with each of the six
    controllers, connectivity --enable-connectivity and cbf-fov --pf
    (--device defaults to cuda): success and solver_success_rate >= 0.95 as
    the JAX package's runner gives on a CPU, ms per replan step of one team
    against the 100 ms budget; --controller connectivity must launch the
    generic kernel 4 times a step (320 launches: the generic row of the
    kernels record);
18. bench.py's +polish mode, fov and connectivity at 8192 lanes:
    StructuredConfig(iters=200, iters_tail=64, polish=True), the f32 ADMM (folded
    kernel for fov, tiled for connectivity, 4 launches a call, asserted) and the f64 active-set polish on the
    card: finite flyable lanes, certified lanes a subset of usable ones, usable
    at or above the raw ADMM's in the same run, connectivity certified >= 0.99
    (fov's rate reported); 3 timed calls, the polish's share from a stage
    split, launches and device-busy time of one call under torch.profiler,
    peak device memory;
19. polish_structured on the card against the host CPU on 512 lanes of each
    recipe's IMPC-iteration-0 QPs from one f32 ADMM iterate: certified flags
    equal, z within 1e-7 where both certify;
20. the first 256 certified lanes of each recipe (of 256 connectivity lanes,
    of 8192 fov lanes) against the exact oracle (ops/qp/oracle.py, built on the
    host): control deviation below 1e-3 (tests/test_polish.py), except on the
    lanes where the JAX package misses that bar too on the CPU
    (scripts/polish_oracle_reference.py; JAX_CPU_ORACLE_OVER), which must stay
    within 1e-4 of the JAX package's deviation;
21. the reference's grid through mpc_cbf_torch.apps.sweep.main, one call a
    cell: connectivity teams of 2, 4, 6, 8, 10 robots x 15 seeds for 6 s (the
    generic kernel, 4 launches a step, asserted; each team's shape is also
    held against the twin and timed alone at 15 R lanes: the
    generic_sweep_r<R> rows), fov teams of 8 at 120, 240 and 360 degrees (the
    f32 IPM, no kernel): wall time, success and success_ref shares (every
    connectivity cell must keep 1.0 for both), launches; then connectivity
    cells of 128 and 256 robots (one seed, 1 s) through the cluster kernel (4
    launches a step, asserted; the cluster_conn<R> rows);
22. checkpoint/resume: utils/checkpoint.py::checkpointed_rollout on the
    sweep's connectivity cell of 4 robots x 15 seeds (the generic kernel, 4
    launches a step, asserted), 60 steps in segments of 20 into
    build/smoke_ckpt/, then a crash at 40 and a fresh call that resumes to
    60: the resumed steps within 1e-6 of the uninterrupted run;
23. scenario sharding: parallel.sharded_rollout over make_mesh() (this
    card) bitwise equal to sim.rollout on the same cell; init_distributed
    in a world of one (NCCL, a localhost port): host_scenarios_to_global
    returns the local batch unchanged;
24. deploy: launch_formation with tests/test_deploy.py's two robots on the
    card for 8 s of virtual time: both plants within 0.5 of their goals,
    the pair more than 0.3 apart; median and p95 wall ms of a ControlNode
    replan beside h = 100 ms, and the launches of one replan;
25. the apps on the card's output: statistics.aggregate over the sweep
    grid's rows (success rates equal to the rows' means), and a
    generate_instances task flown by run_sim.main on the card;
26. apps.audit_failed_lanes at 8192 lanes: the f32 IPM's usable rate, its
    failed lanes and the oracle's status on each (reported beside the JAX
    package's TPU record, not held to it).
Any failure raises (exit code 1). The last three lines are the card's name
and power limit again, a JSON record of the kernels and {"ok": true,
"device": {...}}. Without a GPU, or without
the repository beside it, it exits non-zero and prints no result.
Cut against earlier versions to stay within the time: the f32-IPM closed
loop flies 10 steps (60 at first, then 20), the fov IPM times 3 calls, not
5, and its chunk = 0 run, the connectivity IPM and HYBRID_PROD time one
call each, not three; the CBF-only loops fly 30 steps, not 60.

Expected on one NVIDIA H100 80GB HBM3 at 700 W (PERF.md; the wall times
follow the host): every kernel variant within 1.3e-4 of its twin (under
6.2e-5 for folded, also after 550 iterations); one fov control step's four
phases at 8192 lanes 7.1 ms in the folded kernel (bound 0.466 ms, 6.6 % of
it reached; twin 110-157 ms) and 11.3 ms of C builds; connectivity at 32768
lanes 8.8-9.1 ms through tiled's tensor-core loop; the λ₂/CLF step at 32768
lanes 10.3-10.9 ms; the
folded kernel 2.07 ms for the 32-agent connectivity step's four launches at
4096 lanes (bound 0.120 ms) and 39.8 ms for the 32-agent fov step's four
launches at 4096 lanes (bound 4.876 ms, 12.3 %); generic 0.48 ms for one
run_sim connectivity step on 3 lanes, 0.48-0.62 ms at the sweep's teams,
9.1 ms at the 24-agent fov shapes on 768 lanes; cluster 46.5 / 74.7 ms at
the 40- / 64-agent steps, 21.3 ms at the 96-agent ring, 193 ms at the
128-agent step's 512 lanes (bound 6.075 ms, 3.1 %), 362 ms at a 256-lane
chunk of 256 agents (rows and C streamed; twin 776 ms) and 941 ms at one of
400 agents (twin 1540 ms), 16.0-17.7 / 84.2-84.8 ms at one team of
128 / 256 connectivity robots; the C builds (folded_c) beside each, from
0.47 ms (3 lanes) to 105 ms (256 lanes of 400 agents) a step's four phases;
fov ADMM usable 0.7101 (plain route 0.7101, flags equal), 52-71 ms per
call;
connectivity ADMM usable 0.9933, 16 ms, flags equal to the plain loop's on
every lane; 32-agent connectivity usable
1.0000, 10-12 ms (f32 IPM: 1.0000, 225-450 ms); 32-agent fov usable 0.9902
with the kernel and 0.9900 with the plain loop (one lane's flag differs),
104 ms, peak 2.05 GiB (f32 IPM:
usable 1.0000, 436-520 ms, peak 1.39 GiB); 24-agent fov usable 0.9935
through the generic kernel and the plain loop, flags equal on every lane;
40 / 64 / 96 / 128-agent steps 92-119 / 126-137 / 88-111 / 274-293 ms
(usable 0.9987 / 1.0000 / 1.0000 / 1.0000, flags equal on every lane, 128
agents peak 2.27 GiB); the 400-agent ring 1.76-1.93 s (usable 1.0000, flags
equal on all 400 lanes, peak 10.27 GiB); λ₂ connectivity usable 0.5292 on bench.py's random
teams (0.98 where the λ₂ row is on, 0.29 under the hard CLF rows; the JAX
package gives the same flags), 47-68 ms a call; the f64 IPM on the card
within 2.5e-4 of the host CPU; fov f32 IPM usable 0.9974, 500-1400 ms per
call at chunk 2048 and 220-430 ms at chunk 0, ~46k kernel launches per
call; connectivity f32 IPM usable 1.0000, 1.9-4.2 s; HYBRID_PROD certified
0.987-0.989, 0.74-1.55 s; closed loop solver success 0.99,
instance_success 0.0 (the JAX package flies these random instances to
the same places); the dense ADMM ~10 250 launches a solve, 240-390 ms on the
fov flagship QPs (converged 0.17, primal residual <= 0.05: 0.47) and 116-220
ms on the cbf-fov QPs (converged 0.42); the dense IMPC step usable 0.726,
0.54-0.62 s; CBF-only steps at 32768 lanes 133-256 ms (223-336 with the
particle filter, peak 4.24 GiB), solver success 0.06-0.13 (cbf-fov) and 0.53-0.62
(cbf-connectivity) on the 8-robot rings, as in the JAX package;
BezierMPCSim 179-227 ms a step, all scenarios succeed; the command line
flies all eight variants to success on 3r/rotate, 11-52 ms per replan step
through the structured ADMM, 119-363 ms through the dense ADMM and the f32
IPM (over the 100 ms budget); fov +polish at 8192 lanes usable 0.7156 (raw
0.7101), certified 0.0522, 1.0-2.7 s a call, the polish 81-83 % of it;
connectivity +polish usable 0.9998 (raw 0.9929), certified 0.9993, 0.7-2.2 s
(polish 98-99 %); ~16 400-20 500 launches a call, device busy 37-66 %,
MAGMA's LU row swaps the largest kernel; the polish on the card equal to the
host's (flags on every lane, z within 3e-12); certified lanes within 1e-3 of
the oracle but connectivity lane 120 (1.247e-3, the JAX package 1.249e-3);
the sweep's connectivity cells 0.5-1.7 s for 60 steps (generic 0.48-0.62 ms
a step's four launches at 15 R lanes), all seeds succeed, fov cells 13-31 s;
a resumed checkpointed run equal to the uninterrupted one (max |Δ| 0),
sharded_rollout on one card bitwise sim.rollout; the deploy graph's replans
258-365 ms median (21 793 launches a replan: over the 100 ms budget), both
robots at their goals; the audit at 8192 lanes usable 0.9974, 21 failed
lanes, all max-iter at the oracle.
5 to 11 minutes in all (353-432 s in the runs with the 32-agent and team
phases above, 343-573 s with the slice-6 phases, 494-510 s with the last
modules' phases, 616 s with the cluster kernel's before the CBF-only loops
were cut to 30 steps, 364 s after; 400-500 s of phases with slice 10's,
362 s with slice 12's; 284 s after the by-name rows went);
every phase logs its wall seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import shutil
import socket
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from mpc_cbf_torch import _build
from mpc_cbf_torch.types import State
from mpc_cbf_torch.ops.cbf import ConnectivityCBF, FovCBF
from mpc_cbf_torch.ops.qp import fused_admm
from mpc_cbf_torch.ops.qp.ipm import HYBRID_PROD, IPM_F32_ENTRY, IPMConfig, StructuredIPM
from mpc_cbf_torch.ops.qp.admm import ADMMConfig, solve_batch
from mpc_cbf_torch.ops.qp import structured as structured_mod
from mpc_cbf_torch.ops.qp.oracle import solve_oracle_batch
from mpc_cbf_torch.ops.qp.polish import make_guards, polish_structured
from mpc_cbf_torch.ops.qp.structured import StructuredConfig
from mpc_cbf_torch.apps import audit_failed_lanes, generate_instances, run_sim, sweep
from mpc_cbf_torch.apps import statistics as sweep_statistics
from mpc_cbf_torch.controllers import (
    BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
    ConnectivityIMPCCBF, FovIMPCCBF, StructuredIMPC)
from mpc_cbf_torch.deploy import launch_formation
from mpc_cbf_torch.parallel import MultiAgentSim, make_mesh, sharded_rollout
from mpc_cbf_torch.parallel import distributed
from mpc_cbf_torch.utils import config as cfgmod
from mpc_cbf_torch.utils.checkpoint import Checkpointer, checkpointed_rollout
from mpc_cbf_torch.utils.instances import circle_rotate_instance, random_instance
from mpc_cbf_torch.utils.metrics import instance_success
from portbench.roofline_k3 import k3_bound_s

DEV = torch.device("cuda")
F32 = torch.float32
FOV_SHAPES = dict(n=43, m_s=127, m_d=84)      # fov flagship: 36 + 7 slack columns
CONN_SHAPES = dict(n=36, m_s=126, m_d=6)      # 4-robot connectivity
SWARM_CONN_SHAPES = dict(n=36, m_s=126, m_d=62)   # 32-agent connectivity
SWARM_FOV_SHAPES = dict(n=67, m_s=151, m_d=372)   # 32-agent fov: 36 + 31 slack columns
# shapes without a compiled kernel: the generic kernel's
RUN_SIM_CONN_SHAPES = dict(n=38, m_s=128, m_d=4)  # run_sim connectivity, 3 robots
TEAM24_FOV_SHAPES = dict(n=59, m_s=143, m_d=276)  # 24-agent fov
# fov teams of 40 and 64 agents and a 40-robot connectivity team: past the
# generic kernel's registers, the cluster kernel's (2 and 4 blocks a lane, rows
# in registers). The fov steps run 19 rings of 40 (760 lanes) and 8 rings of 64
# (512 lanes), one lane chunk each
TEAM40_FOV_SHAPES = dict(n=75, m_s=159, m_d=468)
TEAM64_FOV_SHAPES = dict(n=99, m_s=183, m_d=756)
# lanes larger than one SM: the cluster kernel's. fov teams of 96 and 128
# agents (the steps: one ring of 96; 4 rings of 128 = 512 lanes, one lane
# chunk), 256 agents (rows and C streamed from device memory; alone, at one
# lane chunk of 256) and 400 agents (the step: one
# ring of 400, two lane chunks of 256 and 144), the sweep's and run_sim's
# connectivity teams of 128 and 256 robots (alone, one run_sim team's lanes)
# and of 320 (rows and C streamed; checked only)
TEAM96_FOV_SHAPES = dict(zip("n m_s m_d".split(), fused_admm.fov_team_shape(96)))
TEAM128_FOV_SHAPES = dict(zip("n m_s m_d".split(), fused_admm.fov_team_shape(128)))
TEAM256_FOV_SHAPES = dict(zip("n m_s m_d".split(), fused_admm.fov_team_shape(256)))
TEAM400_FOV_SHAPES = dict(zip("n m_s m_d".split(), fused_admm.fov_team_shape(400)))
TEAM128_CONN_SHAPES = dict(n=163, m_s=253, m_d=254)
TEAM256_CONN_SHAPES = dict(n=291, m_s=381, m_d=510)
TEAM320_CONN_SHAPES = dict(n=355, m_s=445, m_d=638)
TEAM_FOV_RINGS = {40: 19, 64: 8, 96: 1, 128: 4, 256: 1, 400: 1}
CHUNK = 256                                  # the auto lane_chunk of the 400-agent lane
#: rows timed alone, at shapes no phase of the main path launches (the log and
#: PERF.md keep them; the kernels line lists what the main path ran)
ALONE = ("cluster_fov256",)
#: teams past every register layout: the largest fov team and connectivity team
#: every kernel must hold (coverage)
LARGEST_TEAM = 512
TEAM40_CONN_SHAPES = dict(n=75, m_s=165, m_d=78)
CONN32_SHAPES = dict(n=67, m_s=157, m_d=62)       # 32-robot connectivity with slack (conn32)
LAMBDA2_SHAPES = dict(n=36, m_s=126, m_d=14)      # 4-robot connectivity with the λ₂/CLF rows
BASE_CONFIG = "configs/base_config.json"
TASK_3R = "configs/baseline/3r/rotate.json"
PHASES = (150, 50, 32, 32)                   # cold soft/stiff, warm soft/stiff
RTOL = ATOL = 2e-4                           # tests/test_pallas_admm.py:53-55
KERNEL = fused_admm.structured_admm_iterations
KW = dict(sigma=1e-6, alpha=1.6)
SOURCES = {"tiled": "mpc_cbf_torch/csrc/structured_admm_tiled.cu",
           "folded": "mpc_cbf_torch/csrc/structured_admm_folded.cu",
           "generic": "mpc_cbf_torch/csrc/structured_admm_generic.cu",
           "cluster": "mpc_cbf_torch/csrc/structured_admm_cluster.cu"}
#: barriers of one iteration as the sources write them (generic:
#: structured_admm_generic.cu; folded: structured_admm_folded.cu, its three
#: waits, two of them of some warps only; cluster:
#: structured_admm_cluster.cu's register layout on a cluster, two block-wide
#: and two waits for the other blocks' pushes, the fov teams it times; on one
#: SM three block-wide; its streamed layout has two block-wide and two
#: cluster-wide): a count read from the code, printed beside the measured
#: times in the log only
BARRIERS = {"generic": 3, "folded": 3, "cluster": 4}
SWARM_PHASES = {"connectivity": (50, 50, 50, 50),     # StructuredConfig(iters=100), cold and warm
                "fov": (550, 50, 150, 50)}            # iters=600, iters_tail=200
RUN_SIM_PHASES = (150, 50, 150, 50)                   # StructuredConfig(), run_sim's ADMM


def reset_counts() -> None:
    KERNEL.launches = 0
    KERNEL.launches_by_variant = dict.fromkeys(fused_admm.VARIANTS, 0)
    KERNEL.launches_by_layout = {}


def launch_lanes(shapes: dict, batch: int) -> int:
    """The lanes a launch of one control step on ``batch`` lanes of these
    shapes gets: StructuredQPOperator's auto lane_chunk (the first chunk)."""
    op = structured_mod.StructuredQPOperator.__new__(structured_mod.StructuredQPOperator)
    op.n, op.m_d, op.cfg = shapes["n"], shapes["m_d"], StructuredConfig()
    return op._lane_chunk(batch) or batch


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, fn, *args, **kwargs):
    """Run one phase of the script and log the wall seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"  [{name}: {time.perf_counter() - t0:.1f} s]")
    return out


def sync_clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs, after one warm-up run. The card
    first spins for about a millisecond (torch.cuda._sleep), so that the host
    queues the launches while it is busy: a launch of 0.1 ms then starts
    right after the one before it, and a pause of the host does not fall
    into the window."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}")
    return smi


def build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {lib.relative_to(_build.BUILD_ROOT.parent.parent)}")
    lines = (lib.parent / "build.log").read_text().splitlines()
    for line in lines:
        if "registers" in line or "spill" in line or "# " in line[:2]:
            log(f"  {line.strip()}")
    # the cluster kernel's register layout, the folded kernel and the tiled kernel's tensor-core
    # loop hold their rows in registers: no instance may spill
    for kernel in ("reg_kernel", "folded_kernel", "TcShape"):
        spilled = [line.split("'")[1] for i, line in enumerate(lines)
                   if "Compiling entry function" in line and kernel in line
                   and not any("0 bytes spill stores, 0 bytes spill loads" in ln
                               for ln in lines[i + 1:i + 4])]
        if spilled or not any(kernel in line for line in lines):
            raise AssertionError(f"ptxas: {kernel} spills in {spilled} (or has no report)")


def phase_inputs(B: int, seed: int, shapes=FOV_SHAPES, operand: str | None = None):
    """Seeded inputs of one rho phase on the card (a fresh list of the same
    tensors for the same arguments), with the operand ``operand`` ("wk", "c";
    None: the shape's). Lanes of more than 300 dynamic rows repeat 64 distinct
    lanes, of more than 1000 rows 8 and of more than 2000 rows 2: the host's
    inverses would otherwise take a minute (the kernels' work does not depend
    on the values)."""
    return list(_phase_inputs(B, seed, tuple(shapes.items()), operand))


@functools.lru_cache(maxsize=None)
def _phase_inputs(B: int, seed: int, shapes: tuple, operand: str | None) -> tuple:
    shapes = dict(shapes)
    m_d = shapes["m_d"]
    distinct = 2 if m_d > 2000 else 8 if m_d > 1000 else 64 if m_d > 300 else None
    arrays = fused_admm.random_phase_inputs(np.random.default_rng(seed), B, **shapes,
                                            distinct=distinct, operand=operand)
    return tuple(torch.from_numpy(a).to(DEV) for a in arrays)


def max_dev(out_k, out_t, what: str) -> float:
    err = 0.0
    for name, k, t in zip(("x", "zs", "zd", "ys", "yd"), out_k, out_t):
        dev = (k - t).abs()
        bad = int((dev > ATOL + RTOL * t.abs()).sum())
        if bad or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{what}, kernel vs twin, {name}: {bad} entries beyond "
                                 f"rtol=atol={RTOL}, max |dev| {float(dev.max()):.3e}")
        err = max(err, float(dev.max()))
    return err


def check_kernel(iters: int = 40) -> dict:
    """Every kernel variant against the twin; returns the max abs error of
    each row of the kernels record."""
    cases = [  # (row of the record, what, shapes, lanes, generic or cluster by name, or None)
        # the fov flagship, the main path: the folded kernel (one lane a block, the lane's C),
        # also for the step's longest phase
        ("folded_fov", "fov", FOV_SHAPES, 1001, None),
        ("folded_fov", "fov, 3 lanes", FOV_SHAPES, 3, None),
        ("folded_fov", "fov, the step's longest phase", FOV_SHAPES, 1001, None, max(PHASES)),
        # the connectivity shapes: the tiled kernel's tensor-core loop (32 lanes a block)
        ("tiled_connectivity", "connectivity", CONN_SHAPES, 1001, None),
        ("tiled_connectivity", "connectivity, fewer lanes than a block", CONN_SHAPES, 3, None),
        ("tiled_connectivity", "connectivity, the step's longest phase", CONN_SHAPES, 1001, None,
         max(PHASES)),
        ("folded_swarm_connectivity", "32-agent connectivity", SWARM_CONN_SHAPES, 1001, None),
        ("folded_swarm_connectivity", "32-agent connectivity, 3 lanes", SWARM_CONN_SHAPES, 3, None),
        ("folded_swarm_connectivity", "32-agent connectivity, the step's longest phase",
         SWARM_CONN_SHAPES, 1001, None, max(SWARM_PHASES["connectivity"])),
        ("folded_swarm_fov", "32-agent fov", SWARM_FOV_SHAPES, 64, None),
        ("folded_swarm_fov", "32-agent fov, 3 lanes", SWARM_FOV_SHAPES, 3, None),
        ("generic", "run_sim's 3-robot connectivity", RUN_SIM_CONN_SHAPES, 3, None),
        ("generic", "fov through the generic kernel", FOV_SHAPES, 100, "generic"),
        ("generic", "32-agent connectivity through the generic kernel", SWARM_CONN_SHAPES, 64,
         "generic"),
        ("cluster", "32-agent fov through the cluster kernel", SWARM_FOV_SHAPES, 64, "cluster"),
        ("tiled_lambda2", "connectivity with the λ₂/CLF rows", LAMBDA2_SHAPES, 1001, None),
        ("tiled_lambda2", "connectivity with the λ₂/CLF rows, fewer lanes than a block",
         LAMBDA2_SHAPES, 3, None),
        ("tiled_lambda2", "connectivity with the λ₂/CLF rows, the step's longest phase",
         LAMBDA2_SHAPES, 1001, None, max(PHASES)),
        *(("generic_sweep_r%d" % R, f"sweep connectivity team of {R}", sweep_shapes(R),
           SWEEP_SEEDS * R, None) for R in SWEEP_SIZES),
        ("generic_sweep_r10", "sweep connectivity team of 10, a cold phase",
         sweep_shapes(10), SWEEP_SEEDS * 10, None, max(RUN_SIM_PHASES)),
        ("generic_team24", "24-agent fov", TEAM24_FOV_SHAPES, 64, None),
        # the cluster kernel's register layout at the six teams the steps and the sweep cells
        # run, each also for the 550 iterations of the fov step's longest phase
        ("cluster_fov40", "40-agent fov", TEAM40_FOV_SHAPES, 64, None),
        ("cluster_fov40", "40-agent fov, the step's longest phase", TEAM40_FOV_SHAPES, 64, None,
         max(SWARM_PHASES["fov"])),
        ("cluster_fov64", "64-agent fov", TEAM64_FOV_SHAPES, 16, None),
        ("cluster_fov64", "64-agent fov, the step's longest phase", TEAM64_FOV_SHAPES, 16, None,
         max(SWARM_PHASES["fov"])),
        ("cluster", "40-robot connectivity", TEAM40_CONN_SHAPES, 64, None),
        ("cluster", "32-robot connectivity (conn32), on one SM", CONN32_SHAPES, 64, None),
        ("cluster", "32-robot connectivity (conn32), on one SM, the step's longest phase",
         CONN32_SHAPES, 64, None, max(RUN_SIM_PHASES)),
        # lanes larger than one SM: the cluster kernel (rows in registers but at 256 fov agents)
        ("cluster_fov96", "96-agent fov", TEAM96_FOV_SHAPES, 4, None),
        ("cluster_fov96", "96-agent fov, the step's longest phase", TEAM96_FOV_SHAPES, 4, None,
         max(SWARM_PHASES["fov"])),
        ("cluster_fov128", "128-agent fov", TEAM128_FOV_SHAPES, 4, None),
        ("cluster_fov128", "128-agent fov, the step's longest phase", TEAM128_FOV_SHAPES, 4, None,
         max(SWARM_PHASES["fov"])),
        # the streamed layout: the 160-, 256- (also a lane chunk) and 400-agent fov lanes, also
        # for the step's longest phase
        ("cluster", "160-agent fov (rows and C streamed)",
         dict(zip("n m_s m_d".split(), fused_admm.fov_team_shape(160))), 2, None),
        ("cluster_fov256", "256-agent fov (rows streamed, C too)", TEAM256_FOV_SHAPES, 2, None),
        ("cluster_fov256", "256-agent fov (rows and C streamed), a lane chunk, the longest phase",
         TEAM256_FOV_SHAPES, CHUNK, None, max(SWARM_PHASES["fov"])),
        ("cluster_fov400", "400-agent fov (rows and C streamed)", TEAM400_FOV_SHAPES, 4, None),
        ("cluster_fov400", "400-agent fov (rows and C streamed), the step's longest phase",
         TEAM400_FOV_SHAPES, 4, None, max(SWARM_PHASES["fov"])),
        ("cluster_conn128", "128-robot connectivity", TEAM128_CONN_SHAPES, 16, None),
        ("cluster_conn128", "128-robot connectivity, 550 iterations", TEAM128_CONN_SHAPES, 16,
         None, max(SWARM_PHASES["fov"])),
        ("cluster_conn256", "256-robot connectivity", TEAM256_CONN_SHAPES, 8, None),
        ("cluster_conn256", "256-robot connectivity, 550 iterations",
         TEAM256_CONN_SHAPES, 8, None, max(SWARM_PHASES["fov"])),
        ("cluster", "320-robot connectivity (rows and C streamed)", TEAM320_CONN_SHAPES, 4, None),
        ("cluster", "n = 162, past every one-block layout", dict(n=162, m_s=2, m_d=2), 3, None),
        ("cluster", "n = 165, past every one-block layout", dict(n=165, m_s=4, m_d=4), 3, None),
        # the longest phase of the 32-agent fov step: two float32 loops after 550 iterations
        ("folded_swarm_fov", "32-agent fov, the step's longest phase", SWARM_FOV_SHAPES, 64, None,
         max(SWARM_PHASES["fov"])),
    ]
    errs = {}
    for row, what, shapes, B, variant, *longer in cases:
        n_it = longer[0] if longer else iters
        reset_counts()
        if variant is None:                   # the kernel of the shape, through the wrapper
            args, twin = phase_inputs(B, seed=0, shapes=shapes), \
                fused_admm.structured_admm_iterations_ref
            out_k = KERNEL(*args, iters=n_it, **KW)
            took = [v for v, c in KERNEL.launches_by_variant.items() if c]
            if took != [row.split("_")[0]]:
                raise AssertionError(f"{what}: launched {took}, expected the {row} kernel")
            took += list(KERNEL.launches_by_layout)   # the cluster kernel's layout
        else:                                 # generic or cluster by name, on C
            twin = fused_admm.folded_iterations_ref
            args = phase_inputs(B, seed=0, shapes=shapes, operand="c")
            out_k = fused_admm.launch_variant(fused_admm._lib(), variant, args, iters=n_it, **KW)
            took = [variant]
        out_t = twin(*args, iters=n_it, **KW)
        torch.cuda.synchronize()
        err = max_dev(out_k, out_t, what)
        errs[row] = max(errs.get(row, 0.0), err)
        log(f"kernel vs twin, {what} {tuple(shapes.values())} at B={B}, {n_it} iterations "
            f"({', '.join(took)}): max |dev| {err:.3e} (rtol = atol = {RTOL})")

    # a NaN lane leaves every other lane, those of its block too, bitwise untouched
    for what, shapes, bad_lane in (("fov", FOV_SHAPES, 5), ("connectivity", CONN_SHAPES, 10),
                                   ("connectivity with the λ₂/CLF rows", LAMBDA2_SHAPES, 10),
                                   ("32-agent connectivity", SWARM_CONN_SHAPES, 10),
                                   ("sweep connectivity team of 10", sweep_shapes(10), 10),
                                   ("128-robot connectivity", TEAM128_CONN_SHAPES, 10),
                                   ("256-robot connectivity", TEAM256_CONN_SHAPES, 10),
                                   ("256-agent fov (rows streamed)", TEAM256_FOV_SHAPES, 10),
                                   ("400-agent fov (rows and C streamed)", TEAM400_FOV_SHAPES,
                                    10)):
        args = phase_inputs(37, seed=2, shapes=shapes)
        clean = KERNEL(*args, iters=iters, **KW)
        args[3] = args[3].clone()
        args[3][bad_lane] = float("nan")              # the lane's cost vector q
        dirty = KERNEL(*args, iters=iters, **KW)
        torch.cuda.synchronize()
        keep = torch.arange(37, device=DEV) != bad_lane
        if not bool(torch.isnan(dirty[0][bad_lane]).all()):
            raise AssertionError(f"{what}: the NaN lane came out finite")
        if not all(torch.equal(c[keep], d[keep]) for c, d in zip(clean, dirty)):
            raise AssertionError(f"{what}: a NaN lane changed another lane")
        log(f"NaN lane, {what}: lane {bad_lane} is NaN, the other 36 lanes are bitwise unchanged")
    return errs


def coverage() -> None:
    """Every fov team of 2 to 512 agents ((35 + A, 119 + A, 12 (A - 1)),
    benchmarks/swarm.py's rings) and every connectivity team of 2 to 512
    robots ((35 + R, 125 + R, 2R - 2), apps/sweep.py's and run_sim's) takes
    one of the four kernels: structured_admm_variant returns no kNone; and
    the tiled kernel takes exactly the shapes whose operand is WK
    (fused_admm.TILED_SHAPES, the Python side's choice of form)."""
    lib = fused_admm._lib()
    sizes = range(2, LARGEST_TEAM + 1)
    teams = {f"fov {A}": fused_admm.fov_team_shape(A) for A in sizes}
    teams.update({f"connectivity {R}": (35 + R, 125 + R, 2 * R - 2) for R in sizes})
    teams.update({f"tiled {s}": s for s in fused_admm.TILED_SHAPES})
    took = {name: lib.structured_admm_variant(*shape) for name, shape in teams.items()}
    missing = [name for name, code in took.items() if code < 0]
    if missing:
        raise AssertionError(f"no kernel holds the teams {missing}")
    wrong = [name for name, code in took.items()
             if (fused_admm.VARIANTS[code] == "tiled") != fused_admm.takes_wk(*teams[name])]
    if wrong:
        raise AssertionError(f"the tiled kernel and the WK operand disagree at {wrong}")
    counts = {v: sum(fused_admm.VARIANTS[c] == v for c in took.values())
              for v in fused_admm.VARIANTS}
    log(f"coverage: all {len(teams)} shapes (fov 2-{LARGEST_TEAM} agents, connectivity "
        f"2-{LARGEST_TEAM} robots, the {len(fused_admm.TILED_SHAPES)} tiled shapes) take a "
        f"kernel: {counts}; the tiled kernel exactly the WK shapes {fused_admm.TILED_SHAPES}")


def bound_text(b_ms: float, k_ms: float) -> str:
    """'bound x ms (y % of it reached)'; a bound of microseconds (three lanes
    on a whole card) keeps its digits."""
    small = b_ms < 0.01
    return (f"bound {b_ms:.3e} ms" if small else f"bound {b_ms:.3f} ms") + \
        f" ({100 * b_ms / k_ms:.{3 if small else 1}f} % of it reached)"


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now (MHz)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def kernel_of_shape(shapes) -> str:
    """The variant the wrapper launches for these shapes."""
    lib = fused_admm._lib()
    return fused_admm.VARIANTS[lib.structured_admm_variant(*shapes.values())]


def per_iter_text(ms: float, its: int, mhz: float, variant: str) -> str:
    """'x µs, y clocks at z MHz, b barriers' for one iteration of a step of
    ``its`` iterations that took ``ms``."""
    us = ms * 1e3 / its
    bars = BARRIERS.get(variant)
    return (f"{us:.3f} µs, {us * mhz:.0f} clocks at {mhz:.0f} MHz"
            + (f" ({bars} barriers in the source)" if bars else ""))


def time_phases(what: str, shapes, B: int, phases=PHASES, reps: int = 5) -> dict:
    """Device ms of the kernel the shape takes and the twin per rho phase
    length at B lanes, beside the loop's bound (``k3_bound_s``); for a
    C-form kernel also the C build of one phase
    (StructuredQPOperator.folded_c: the float64 product, its Cholesky and two
    triangular solves, library calls) on the same lanes, for the tiled kernel
    the Woodbury build (StructuredQPOperator.woodbury: two batched products
    and an [m_d, m_d] inverse). Returns the sums over ``phases``: the
    launches one control step makes on B lanes."""
    twin = fused_admm.structured_admm_iterations_ref
    args = phase_inputs(B, seed=1, shapes=shapes)
    per = {}
    for iters in sorted(set(phases)):
        kw = dict(iters=iters, **KW)
        k_ms = cuda_ms(lambda: KERNEL(*args, **kw), reps=reps)
        t_ms = cuda_ms(lambda: twin(*args, **kw), reps=min(reps, 2))
        b_ms = k3_bound_s(B, **shapes, phases=(iters,)) * 1e3
        per[iters] = (k_ms, t_ms)
        log(f"{what}, phase of {iters:3d} iterations at B={B}: kernel {k_ms:.3f} ms, "
            f"{bound_text(b_ms, k_ms)}, plain twin {t_ms:.3f} ms")
    k_sum, t_sum = (sum(per[i][j] for i in phases) for j in (0, 1))
    b_ms = k3_bound_s(B, **shapes, phases=phases) * 1e3
    mhz = sm_clock_mhz()                      # read right after the window
    its = sum(phases)
    variant = kernel_of_shape(shapes)
    c_ms = wk_ms = None
    op = structured_mod.StructuredQPOperator
    if args[10].dtype == torch.float64:       # the C form: one build a phase, as _solve makes it
        M_s = torch.linalg.inv(args[0].double())
        c_ms = len(phases) * cuda_ms(lambda: op.folded_c(M_s, args[6], args[9]), reps=2)
    else:                                     # the Woodbury form
        wk_ms = len(phases) * cuda_ms(lambda: op.woodbury(args[0], args[6], args[9]), reps=2)
    out = dict(ms=k_sum, plain_ms=t_sum, bound_ms=b_ms, lanes=B, phases=list(phases),
               us_per_iter=k_sum * 1e3 / its, clocks_per_iter=k_sum * 1e3 / its * mhz,
               c_build_ms=c_ms, wk_build_ms=wk_ms)
    msg = (f"{what}, {len(phases)} phases {phases} at B={B}: kernel {k_sum:.3f} ms, "
           f"{bound_text(b_ms, k_sum)}; twin {t_sum:.3f} ms; an iteration "
           f"{per_iter_text(k_sum, its, mhz, variant)}"
           + (f"; the C builds of the {len(phases)} phases (folded_c) {c_ms:.3f} ms"
              if c_ms is not None else
              f"; the Woodbury builds of the {len(phases)} phases (woodbury) {wk_ms:.3f} ms"))
    log(msg)
    return out


def fov_controller(N: int = 7):
    """bench.py's fov controller (bench.py:73-86): an (N+1)-robot team."""
    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device=DEV, dtype=F32)
    cbf = FovCBF(120.0 * np.pi / 180.0, 0.3, 6.0, mpc.v_min, mpc.v_max)
    return FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), N,
                      box_half_extents=np.array([0.1, 0.1, 0.0]))


def swarm_problem(mode: str, scenarios: int, A: int = 32):
    """benchmarks/swarm.py's recipe (:44-55, :76-104): `scenarios` rings of A
    agents, every (scenario, agent) pair one lane; fov neighbours masked to
    the sensing range. Returns the controller and optimize_batch's inputs."""
    mpc = MPCParams()
    if mode == "fov":
        ctrl = fov_controller(A - 1)
    else:
        op = BezierMPCOperator(BezierParams(), mpc, dim=3, device=DEV, dtype=F32)
        ctrl = ConnectivityIMPCCBF(op, ConnectivityCBF(1.0, 6.0, mpc.v_min, mpc.v_max),
                                   IMPCParams(), A - 1)
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(A) / A
    R = max(4.0, A * 1.2 / (2 * np.pi) * 2)               # ring with > 1.2 m spacing
    base = np.stack([R * np.cos(ang), R * np.sin(ang), np.zeros(A)], -1)
    pos = base[None] + rng.normal(0, 0.05, (scenarios, A, 3))
    vel = np.zeros_like(pos)
    goals = np.broadcast_to(np.roll(base, -1, axis=0), pos.shape)
    others = np.stack([np.delete(np.arange(A), i) for i in range(A)])
    B = scenarios * A
    if mode == "fov":
        cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (scenarios, A, A - 1, 3))
        blob = np.concatenate([pos[:, others, :2], cov], -1).reshape(B, A - 1, 5)
        dist = np.linalg.norm(pos.reshape(B, 1, 3)[..., :2] - blob[..., :2], axis=-1)
        mask = dist < 5.5
    else:
        blob = np.concatenate([pos, vel], -1)[:, others].reshape(B, A - 1, 6)
        mask = np.ones((B, A - 1), bool)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F32, device=DEV)
    ref = t(np.tile(goals.reshape(B, 3), (1, mpc.k_hor)))
    cur = State(pos=t(pos.reshape(B, 3)), vel=t(vel.reshape(B, 3)))
    return ctrl, (cur, ref, t(blob), torch.as_tensor(mask, device=DEV))


def controller_shapes(ctrl) -> dict:
    return dict(n=ctrl.n, m_s=ctrl.static_parts()[1].shape[0], m_d=ctrl.m_dynamic)


def bench_problem(mode: str, batch: int, enable_connectivity: bool = False):
    """bench.py's recipe (bench.py:73-108,143-147), numpy seed 0, on the card;
    enable_connectivity adds the λ₂/CLF rows to the connectivity controller."""
    mpc = MPCParams()
    rng = np.random.default_rng(0)
    if mode == "fov":
        N = 7
        ctrl = fov_controller(N)
        ang = rng.uniform(0, 2 * np.pi, (batch, N))
        rad = rng.uniform(1.0, 3.5, (batch, N))
        cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (batch, N, 3))
        nbr = np.concatenate([(rad * np.cos(ang))[..., None],
                              (rad * np.sin(ang))[..., None], cov], axis=-1)
    else:
        N = 3
        op = BezierMPCOperator(BezierParams(), mpc, dim=3, device=DEV, dtype=F32)
        ctrl = ConnectivityIMPCCBF(op, ConnectivityCBF(1.0, 4.0, mpc.v_min, mpc.v_max),
                                   IMPCParams(), N, enable_connectivity=enable_connectivity)
        ang = rng.uniform(0, 2 * np.pi, (batch, N))
        rad = rng.uniform(2.5, 4.0, (batch, N))
        nbr_pos = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros_like(rad)], -1)
        nbr = np.concatenate([nbr_pos, rng.normal(0, 0.5, (batch, N, 3))], axis=-1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F32, device=DEV)
    pos = t(rng.normal(0, 0.3, (batch, 3)))
    vel = t(rng.normal(0, 0.5, (batch, 3)))
    goals = rng.normal(0, 3.0, (batch, 3))
    ref = t(np.tile(goals[:, None, :], (1, mpc.k_hor, 1)).reshape(batch, -1))
    mask = torch.ones((batch, N), dtype=torch.bool, device=DEV)
    return ctrl, (State(pos=pos, vel=vel), ref, t(nbr), mask)


def admm_stepper(ctrl, **cfg):
    return StructuredIMPC(ctrl, StructuredConfig(iters=200, iters_tail=64, **cfg))


def control_step(ctrl, inputs, **cfg):
    simpc = admm_stepper(ctrl, **cfg)
    return lambda: simpc.optimize_batch(*inputs)


def check_result(res, batch: int) -> float:
    if tuple(res.coeffs.shape) != (batch, 36):
        raise AssertionError(f"coeffs shape {tuple(res.coeffs.shape)}")
    if not bool(torch.isfinite(res.coeffs[res.flyable]).all()):
        raise AssertionError("a flyable lane has non-finite coefficients")
    return float(res.success.float().mean())


def fov_main_path(batch: int = 8192):
    """The fov flagship through its route (the folded kernel on the lane's C,
    4 launches a call, asserted), beside the same step through the plain
    loop (usable rates within 0.01)."""
    ctrl, inputs = bench_problem("fov", batch)
    simpc = admm_stepper(ctrl)
    variant = kernel_of_shape(FOV_SHAPES)
    step = lambda: simpc.optimize_batch(*inputs)
    step()                                   # warm-up (torch.func, cuBLAS, cuSOLVER)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = step()
    torch.cuda.synchronize()
    launches = KERNEL.launches
    if launches != 4 or KERNEL.launches_by_variant[variant] != 4:
        raise AssertionError(f"main path launched the kernel {launches} times "
                             f"({KERNEL.launches_by_variant}), expected the {variant} one 4 times")
    usable = check_result(res, batch)
    log(f"fov main path, {batch} lanes: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    times = []
    for _ in range(5):
        before = KERNEL.launches
        t0 = sync_clock()
        res_k = step()
        times.append(sync_clock() - t0)
        if KERNEL.launches - before != 4:
            raise AssertionError("a control step did not launch the kernel 4 times")
    t_k = statistics.median(times)
    log(f"fov main path, {batch} lanes, kernel: usable {usable:.4f}, median {t_k * 1e3:.2f} ms "
        f"of 5 calls ({min(times) * 1e3:.2f}..{max(times) * 1e3:.2f}), "
        f"{batch * 2 / t_k:.1f} solves/s")
    stage_split(simpc, inputs)
    profile_call(step)
    before = KERNEL.launches
    plain = control_step(ctrl, inputs, use_kernel=False)
    plain()
    t0 = sync_clock()
    res_t = plain()
    t_t = sync_clock() - t0
    if KERNEL.launches != before:
        raise AssertionError("the plain loop launched the kernel")
    usable_t = check_result(res_t, batch)
    log(f"fov main path, {batch} lanes, plain loop: usable {usable_t:.4f}, "
        f"{t_t * 1e3:.2f} ms, {batch * 2 / t_t:.1f} solves/s")
    if abs(usable - usable_t) > 0.01 or usable < 0.70:
        raise AssertionError(f"usable rates: kernel {usable:.4f}, plain {usable_t:.4f} "
                             "(bars: within 0.01 of each other, kernel >= 0.70)")
    both = res_k.success & res_t.success
    dev = (res_k.coeffs - res_t.coeffs).abs().amax(-1)[both]
    log(f"  kernel vs plain coefficients on {int(both.sum())} lanes usable in both: "
        f"median {float(dev.median()):.2e}, p99 {float(dev.quantile(0.99)):.2e}, "
        f"max {float(dev.max()):.2e}; success flags differ on "
        f"{int((res_k.success != res_t.success).sum())} lanes")
    return launches


def connectivity_path(batch: int = 32768, split: bool = True) -> int:
    """The connectivity flagship through its route (the tiled kernel, 4
    launches a call, asserted; usable >= 0.99), and the same step through the
    plain loop: the success flags may differ on at most 1 % of the lanes.
    ``split``: one more call with a sync around each stage."""
    ctrl, inputs = bench_problem("connectivity", batch)
    simpc = admm_stepper(ctrl)
    step = lambda: simpc.optimize_batch(*inputs)
    step()
    reset_counts()
    t0 = sync_clock()
    res = step()
    dt = sync_clock() - t0
    launches = KERNEL.launches
    if launches != 4 or KERNEL.launches_by_variant["tiled"] != 4:
        raise AssertionError(f"connectivity step launched {KERNEL.launches_by_variant}, "
                             "expected the tiled kernel 4 times")
    usable = check_result(res, batch)
    log(f"connectivity, {batch} lanes, kernel: usable {usable:.4f}, {dt * 1e3:.2f} ms, "
        f"{batch * 2 / dt:.1f} solves/s")
    if usable < 0.99:
        raise AssertionError(f"connectivity ADMM usable rate {usable:.4f} < 0.99")
    if split:
        stage_split(simpc, inputs)
    plain = control_step(ctrl, inputs, use_kernel=False)
    plain()
    before = KERNEL.launches
    t0 = sync_clock()
    res_t = plain()
    dt_t = sync_clock() - t0
    if KERNEL.launches != before:
        raise AssertionError("the plain loop launched the kernel")
    usable_t = check_result(res_t, batch)
    differ = int((res.success != res_t.success).sum())
    both = res.success & res_t.success
    dev = (res.coeffs - res_t.coeffs).abs().amax(-1)[both]
    log(f"connectivity, {batch} lanes, plain loop: usable {usable_t:.4f}, {dt_t * 1e3:.2f} ms; "
        f"success flags differ on {differ} lanes ({differ / batch:.4f}); coefficients on "
        f"{int(both.sum())} lanes usable in both: median |dev| {float(dev.median()):.2e}, "
        f"p99 {float(dev.quantile(0.99)):.2e}, max {float(dev.max()):.2e}")
    if differ > 0.01 * batch:
        raise AssertionError(f"connectivity: the kernel's and the plain loop's success flags "
                             f"differ on {differ} of {batch} lanes (bar: at most 1 %)")
    return launches


def swarm_path(mode: str, ctrl, inputs, variant: str, timed: dict, usable_bar: float = 0.0,
               plain: bool = False, split: bool = False, profile: bool = False,
               calls: int = 1) -> int:
    """One control step of benchmarks/swarm.py's recipe (SWARM_SOLVER=admm)
    through the kernel route; returns the kernel launches of the call.
    ``timed``: the kernel-alone row of this path, which must have been
    taken at this step's lanes per launch and phase lengths; it receives
    what the step measured under "step". ``plain``: the
    same step through the plain loop too (one call); the usable rates must
    agree within 0.01 and the success flags on 99 % of the lanes. ``split``:
    one more call with a sync around each stage; ``profile``: one under the
    profiler. ``calls``: the step's wall time is the median of that many
    calls."""
    batch, agents = inputs[0].pos.shape[0], inputs[2].shape[1] + 1
    cfg = StructuredConfig(iters=600, iters_tail=200) if mode == "fov" \
        else StructuredConfig(iters=100)
    simpc = StructuredIMPC(ctrl, cfg)
    chunk = simpc.op_qp._lane_chunk(batch) or batch
    phases = [p[0] for op in (simpc.op_qp, simpc.op_qp_tail or simpc.op_qp) for p in op.phases]
    what = f"{agents}-agent {mode}"
    if (chunk, phases) != (timed["lanes"], timed["phases"]):
        raise AssertionError(f"{what} step launches {chunk} lanes for {phases} "
                             f"iterations; timed alone at {timed['lanes']}, {timed['phases']}")
    step = lambda: simpc.optimize_batch(*inputs)
    step()                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, times = timed_calls(step, calls)
    dt = statistics.median(times)
    chunks = -(-batch // chunk)
    expected = 4 * chunks                     # 2 IMPC iterations x 2 rho phases per chunk
    if KERNEL.launches != expected * calls or \
            KERNEL.launches_by_variant[variant] != expected * calls:
        raise AssertionError(f"{what} step launched {KERNEL.launches_by_variant} in {calls} "
                             f"calls, expected the {variant} kernel {expected} times a call")
    usable = check_result(res, batch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed["step"] = dict(usable=usable, ms=dt * 1e3, peak=peak)
    log(f"{what}, {batch} lanes, ADMM {cfg.iters} iterations, lane_chunk auto = "
        f"{chunk} lanes ({chunks} chunks), {variant} kernel x{expected} a call: usable "
        f"{usable:.4f}, flyable {float(res.flyable.float().mean()):.4f}, "
        + (spread(times) if calls > 1 else f"{dt * 1e3:.2f} ms")
        + f", {batch * 2 / dt:.1f} solves/s, peak device memory {peak:.3f} GiB; the kernel "
        f"alone about {timed['ms'] * batch / chunk:.3f} ms of it ({batch / chunk:.4g} x "
        f"{timed['ms']:.3f} at {chunk} lanes; bound {timed['bound_ms'] * batch / chunk:.3f} ms, "
        f"plain twin {timed['plain_ms'] * batch / chunk:.3f} ms"
        + (f", the C builds {timed['c_build_ms'] * batch / chunk:.3f} ms"
           if timed.get("c_build_ms") else "") + ")")
    if usable < usable_bar:
        raise AssertionError(f"{what} ADMM usable rate {usable:.4f} < {usable_bar}")
    if split:
        stage_split(simpc, inputs)
    if profile:
        profile_call(step)
    if plain:
        slow = StructuredIMPC(ctrl, dataclasses.replace(cfg, use_kernel=False))
        before = KERNEL.launches
        t0 = sync_clock()
        res_t = slow.optimize_batch(*inputs)
        dt_t = sync_clock() - t0
        if KERNEL.launches != before:
            raise AssertionError("the plain loop launched the kernel")
        usable_t = check_result(res_t, batch)
        differ = int((res.success != res_t.success).sum())
        both = res.success & res_t.success
        dev = (res.coeffs - res_t.coeffs).abs().amax(-1)[both]
        log(f"{what}, {batch} lanes, plain loop: usable {usable_t:.4f}, {dt_t * 1e3:.2f} ms; "
            f"success flags differ on {differ} lanes ({differ / batch:.4f}); coefficients on "
            f"{int(both.sum())} lanes usable in both: median |dev| {float(dev.median()):.2e}, "
            f"p99 {float(dev.quantile(0.99)):.2e}, max {float(dev.max()):.2e}")
        if abs(usable - usable_t) > 0.01 or differ > 0.01 * batch:
            raise AssertionError(f"{what}: kernel usable {usable:.4f}, plain {usable_t:.4f}, flags "
                                 f"differ on {differ} lanes (bars: within 0.01, at most 1 %)")
    return expected


def swarm_ipm_path(mode: str, ctrl, inputs, admm: dict) -> None:
    """The same 32-agent step through the f32 IPM (IPM_F32_ENTRY,
    benchmarks/swarm.py's default solver): one call after a warm-up, beside
    the ADMM step's numbers (``admm``: what swarm_path left under "step").
    The only bar: finite flyable lanes."""
    batch, agents = inputs[0].pos.shape[0], inputs[2].shape[1] + 1
    simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)
    step = lambda: simpc.optimize_batch(*inputs)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, times = timed_calls(step, 1)
    if KERNEL.launches:
        raise AssertionError("the IPM control step launched the ADMM kernel")
    usable = check_result(res, batch)
    log(f"{agents}-agent {mode}, {batch} lanes, f32 IPM (IPM_F32_ENTRY): usable {usable:.4f}, "
        f"flyable {float(res.flyable.float().mean()):.4f}, {times[0] * 1e3:.2f} ms, "
        f"{batch * 2 / times[0]:.1f} solves/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; the ADMM step: usable "
        f"{admm['usable']:.4f}, {admm['ms']:.2f} ms, peak {admm['peak']:.3f} GiB")


def timed_calls(step, n: int):
    """(last result, host seconds of each of n calls, each ending in a sync)."""
    times = []
    for _ in range(n):
        t0 = sync_clock()
        res = step()
        times.append(sync_clock() - t0)
    return res, times


def spread(times) -> str:
    return (f"median {statistics.median(times) * 1e3:.2f} ms of {len(times)} calls "
            f"({min(times) * 1e3:.2f}..{max(times) * 1e3:.2f})")


def stage_split(simpc, inputs, polish: bool = False) -> dict:
    """One call with a sync around each stage: the assembly (cost vector,
    shared bounds, dynamic rows) and each IMPC iteration's solve; with
    ``polish``, the ADMM and the f64 polish of each solve apart. Returns the
    seconds of each stage label, summed, and of the call ("total")."""
    rec = []

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = sync_clock()
            out = fn(*a, **k)
            rec.append((label, sync_clock() - t0))
            return out
        setattr(obj, name, timed)             # shadows the method on this object only
        return fn

    hooks = [(simpc.ctrl, "cost_vector", "assembly: cost_vector"),
             (simpc.ctrl, "shared_bounds", "assembly: shared_bounds"),
             (simpc.ctrl, "dynamic_rows", "assembly: dynamic_rows"),
             (simpc.op_qp, "solve", "solve")]
    tail = simpc.op_qp_tail
    if tail is not None:
        # a HybridIPM's entry is op_qp itself, so time only its f64 tail
        hooks.append((tail.tail, "solve", "solve: f64 tail") if hasattr(tail, "tail")
                     else (tail, "solve", "solve (tail operator)"))
    if polish:
        # solve_polished calls self.solve (timed above) and then the module's
        # polish_structured
        hooks.append((structured_mod, "polish_structured", "polish (f64)"))
    originals = [wrap(obj, name, label) for obj, name, label in hooks]
    try:
        t0 = sync_clock()
        simpc.optimize_batch(*inputs)
        total = sync_clock() - t0
    finally:
        for (obj, name, _), fn in zip(hooks, originals):
            if isinstance(obj, types.ModuleType):
                setattr(obj, name, fn)
            else:
                delattr(obj, name)
    log(f"  stage split of one call (sync around each stage), {total * 1e3:.2f} ms in all:")
    for label, sec in rec:
        log(f"    {label:28s} {sec * 1e3:9.2f} ms")
    log(f"    {'rest of optimize_batch':28s} {(total - sum(s for _, s in rec)) * 1e3:9.2f} ms")
    out = {"total": total}
    for label, sec in rec:
        out[label] = out.get(label, 0.0) + sec
    return out


def _device_us(evt, total: bool) -> float:
    names = ("device_time_total", "cuda_time_total") if total else \
        ("self_device_time_total", "self_cuda_time_total")
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled(step):
    """One call under torch.profiler: (key averages, its device kernels,
    wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = sync_clock()
        step()
        wall = sync_clock() - t0
    avgs = prof.key_averages()
    return avgs, [e for e in avgs if e.device_type == DeviceType.CUDA], wall


def profile_counts(step) -> tuple:
    """(kernel launches, device busy ms, wall ms) of one call under
    torch.profiler."""
    _, kernels, wall = profiled(step)
    return (sum(e.count for e in kernels),
            sum(_device_us(e, total=False) for e in kernels) / 1e3, wall * 1e3)


def profile_call(step, top: int = 8) -> tuple:
    """One call under torch.profiler: kernel launches, device busy time and
    the share of the factorization (cholesky_ex and the two triangular solves
    of ipm.chol_solve); the ``top`` kernels by device time. Returns (kernel
    launches, device busy ms, wall ms) as profile_counts does."""
    avgs, kernels, wall = profiled(step)
    launches = sum(e.count for e in kernels)
    busy = sum(_device_us(e, total=False) for e in kernels)
    chol = sum(_device_us(e, total=True) for e in avgs
               if e.key in ("aten::linalg_cholesky_ex", "aten::linalg_solve_triangular"))
    if busy <= 0:
        log(f"  profiled call ({wall * 1e3:.2f} ms wall): {launches} kernel launches; "
            "device time not measured (the profiler saw none)")
        return launches, 0.0, wall * 1e3
    log(f"  profiled call ({wall * 1e3:.2f} ms wall under the profiler): {launches} kernel "
        f"launches, device busy {busy / 1e3:.2f} ms; cholesky_ex + solve_triangular "
        f"{chol / 1e3:.2f} ms = {100 * chol / busy:.1f} % of device time")
    host = {k: sum(e.count for e in avgs if e.key == k)
            for k in ("cudaMalloc", "cudaFree", "cudaStreamSynchronize", "cudaDeviceSynchronize")}
    log(f"    device busy {100 * busy / 1e3 / (wall * 1e3):.1f} % of the wall time; host calls "
        + (", ".join(f"{k} x{v}" for k, v in host.items() if v) or "none that wait"))
    for e in sorted(kernels, key=lambda e: -_device_us(e, total=False))[:top]:
        log(f"    {_device_us(e, total=False) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return launches, busy / 1e3, wall * 1e3


def ipm_device_parity(batch: int = 512) -> None:
    """The f64 IPM on the card (cuSOLVER/MAGMA factorizations) against the
    same solve on the host CPU (LAPACK), on one batch of fov QPs (IMPC
    iteration 0 of bench.py's recipe). Bars from tests/test_ipm.py: z to
    1e-3 on the lanes converged on both (two factorizations, :245-250), and
    the converged flags equal on at least 99 % of the lanes."""
    ctrl, (cur, ref, nbr, mask) = bench_problem("fov", batch)
    H = ctrl.impc.cbf_horizon
    q = ctrl.cost_vector(cur, ref, nbr, mask)
    lb_s, ub_s = ctrl.shared_bounds(cur)
    pred = cur.stacked[:, None, :].expand(batch, H, cur.stacked.shape[-1])
    A_d, lb_d, ub_d = ctrl.dynamic_rows(cur, nbr, mask, pred,
                                        torch.arange(H, device=DEV) == 0)
    static = ctrl.static_parts() + (ctrl.m_dynamic,)
    args = (q, lb_s, ub_s, A_d, lb_d, ub_d)
    card = StructuredIPM(*static, IPMConfig(), device=DEV).solve(*args)
    host = StructuredIPM(*static, IPMConfig(), device="cpu").solve(*(a.cpu() for a in args))
    conv_c, conv_h = card.converged.cpu(), host.converged
    both = conv_c & conv_h
    dev = (card.z.cpu() - host.z).abs().amax(dim=1)[both]
    same = float((conv_c == conv_h).float().mean())
    log(f"f64 IPM, card against host CPU, {batch} fov lanes: converged {float(conv_c.float().mean()):.4f} "
        f"/ {float(conv_h.float().mean()):.4f}, flags equal on {same:.4f} of lanes; max |dz| on "
        f"{int(both.sum())} lanes converged on both {float(dev.max()):.3e} (median {float(dev.median()):.3e})")
    if same < 0.99 or not bool(both.any()) or float(dev.max()) > 1e-3:
        raise AssertionError("the f64 IPM on the card disagrees with the host CPU")


def fov_ipm_path(batch: int = 8192) -> None:
    """The f32 IPM control step (bench.py's default solver) at 8192 lanes."""
    ctrl, inputs = bench_problem("fov", batch)
    simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)
    step = lambda: simpc.optimize_batch(*inputs)
    step()                                    # warm-up (cuSOLVER, cuBLAS, torch.func)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, times = timed_calls(step, 3)
    if KERNEL.launches:
        raise AssertionError("the IPM control step launched the ADMM kernel")
    usable = check_result(res, batch)
    t = statistics.median(times)
    log(f"fov f32 IPM, {batch} lanes: usable {usable:.4f}, {spread(times)}, "
        f"{batch * 2 / t:.1f} solves/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if usable < 0.98:
        raise AssertionError(f"fov f32 IPM usable rate {usable:.4f} < 0.98")
    stage_split(simpc, inputs)
    profile_call(step)

    whole = StructuredIMPC(ctrl, dataclasses.replace(IPM_F32_ENTRY, chunk=0))
    step0 = lambda: whole.optimize_batch(*inputs)
    step0()
    res0, times0 = timed_calls(step0, 1)
    usable0 = check_result(res0, batch)
    log(f"  chunk = 0 (one chunk of {batch}): usable {usable0:.4f}, {spread(times0)}; "
        f"chunk = {IPM_F32_ENTRY.chunk}: {t * 1e3:.2f} ms; success flags differ on "
        f"{int((res0.success != res.success).sum())} lanes")


def connectivity_ipm_path(batch: int = 32768) -> None:
    ctrl, inputs = bench_problem("connectivity", batch)
    simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)
    step = lambda: simpc.optimize_batch(*inputs)
    step()
    res, times = timed_calls(step, 1)
    usable = check_result(res, batch)
    log(f"connectivity f32 IPM, {batch} lanes: usable {usable:.4f}, {spread(times)}, "
        f"{batch * 2 / statistics.median(times):.1f} solves/s")
    if usable < 0.99:
        raise AssertionError(f"connectivity f32 IPM usable rate {usable:.4f} < 0.99")


def fov_hybrid_path(batch: int = 8192) -> None:
    """HYBRID_PROD, the certified pipeline (f64 tail in native float64)."""
    ctrl, inputs = bench_problem("fov", batch)
    simpc = StructuredIMPC(ctrl, HYBRID_PROD)
    step = lambda: simpc.optimize_batch(*inputs)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, times = timed_calls(step, 1)
    usable = check_result(res, batch)
    cert = float(res.certified.float().mean())
    log(f"fov HYBRID_PROD, {batch} lanes: usable {usable:.4f}, certified {cert:.4f}, "
        f"{spread(times)}, {batch * 2 / statistics.median(times):.1f} solves/s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if bool((res.certified & ~res.success).any()):
        raise AssertionError("a certified lane is not a usable lane")
    if cert < 0.95:
        raise AssertionError(f"HYBRID_PROD certified rate {cert:.4f} < 0.95")
    stage_split(simpc, inputs)


def iteration0(ctrl, inputs):
    """The IMPC-iteration-0 QPs of optimize_batch's inputs, in the structured
    split: (q, lb_s, ub_s, A_d, lb_d, ub_d)."""
    cur, ref, nbr, mask = inputs
    H = ctrl.impc.cbf_horizon
    pred = cur.stacked[:, None, :].expand(cur.pos.shape[0], H, cur.stacked.shape[-1])
    A_d, lb_d, ub_d = ctrl.dynamic_rows(cur, nbr, mask, pred, torch.arange(H, device=DEV) == 0)
    return (ctrl.cost_vector(cur, ref, nbr, mask), *ctrl.shared_bounds(cur), A_d, lb_d, ub_d)


def polish_path(mode: str, batch: int = 8192) -> dict:
    """bench.py's +polish mode (bench.py:139-141,185-189): StructuredIMPC
    with StructuredConfig(iters=200, iters_tail=64, polish=True), the f32
    ADMM (4 launches a call of the shape's kernel) and the f64 active-set polish on
    the card. Bars: finite flyable lanes, certified lanes a subset of usable
    ones, usable at or above the raw ADMM's in the same run; connectivity
    certified >= 0.99 (fov's rate is reported: the polish needs a
    near-optimal entry, tests/test_polish.py:27-76)."""
    ctrl, inputs = bench_problem(mode, batch)
    simpc = admm_stepper(ctrl, polish=True)
    step = lambda: simpc.optimize_batch(*inputs)
    step()                                    # warm-up (cuSOLVER/MAGMA, cuBLAS, torch.func)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = step()
    torch.cuda.synchronize()
    variant = kernel_of_shape(FOV_SHAPES if mode == "fov" else CONN_SHAPES)
    if KERNEL.launches != 4 or KERNEL.launches_by_variant[variant] != 4:
        raise AssertionError(f"{mode} +polish launched {KERNEL.launches_by_variant}, "
                             f"expected the {variant} kernel 4 times a call")
    peak = torch.cuda.max_memory_allocated() / 2**30
    usable = check_result(res, batch)
    cert = float(res.certified.float().mean())
    if bool((res.certified & ~res.success).any()):
        raise AssertionError(f"{mode} +polish: a certified lane is not a usable lane")
    raw = admm_stepper(ctrl).optimize_batch(*inputs)
    usable_raw = check_result(raw, batch)
    _, times = timed_calls(step, 3)
    log(f"{mode} +polish, {batch} lanes: usable {usable:.4f} (raw ADMM {usable_raw:.4f}), "
        f"certified {cert:.4f}, {spread(times)}, {batch * 2 / statistics.median(times):.1f} "
        f"solves/s, peak device memory {peak:.3f} GiB, {variant} kernel x4 a call")
    if usable < usable_raw:
        raise AssertionError(f"{mode} +polish usable {usable:.4f} below the raw ADMM's "
                             f"{usable_raw:.4f}")
    if mode == "connectivity" and cert < 0.99:
        raise AssertionError(f"connectivity +polish certified rate {cert:.4f} < 0.99")
    split = stage_split(simpc, inputs, polish=True)
    log(f"  polish share of the call: {100 * split['polish (f64)'] / split['total']:.1f} % "
        f"({split['polish (f64)'] * 1e3:.2f} ms of {split['total'] * 1e3:.2f} ms, two polishes)")
    launches, busy, wall = profile_call(step, top=12)
    return dict(usable=usable, usable_raw=usable_raw, certified=cert,
                ms=statistics.median(times) * 1e3, polish_ms=split["polish (f64)"] * 1e3,
                total_split_ms=split["total"] * 1e3, launches=launches, busy_ms=busy,
                wall_ms=wall, peak_gib=peak)


def polish_card_vs_host(batch: int = 512) -> None:
    """polish_structured on the card against the same call on the host CPU
    (LAPACK), on one f32 ADMM iterate of each recipe's IMPC-iteration-0 QPs:
    certified flags equal on every lane, z within 1e-7 on lanes certified in
    both."""
    for mode in ("fov", "connectivity"):
        ctrl, inputs = bench_problem(mode, batch)
        op = admm_stepper(ctrl, polish=True).op_qp
        args = iteration0(ctrl, inputs)
        entry = op.solve(*args).z
        card = polish_structured(op._P0, op._A_s0, *args, entry, max_eq=op._n_eq,
                                 guards=op._guards)
        host_guards = make_guards(op._guards.rows, [
            g.nonzero().flatten().tolist() for g in op._guards.group_mask.cpu()]
            if op._guards.group_mask is not None else (), op.m_s + op.m_d, "cpu")
        host = polish_structured(op._P0.cpu(), op._A_s0.cpu(), *(a.cpu() for a in args),
                                 entry.cpu(), max_eq=op._n_eq, guards=host_guards)
        ok_c, ok_h = card.ok.cpu(), host.ok
        both = ok_c & ok_h
        dz = (card.z.cpu() - host.z).abs().amax(-1)[both]
        log(f"polish, card against host CPU, {mode} ({batch} lanes, f32 ADMM entry): certified "
            f"{float(ok_c.float().mean()):.4f} / {float(ok_h.float().mean()):.4f}, flags differ on "
            f"{int((ok_c != ok_h).sum())} lanes; max |dz| on {int(both.sum())} lanes certified on "
            f"both {float(dz.max()) if both.any() else float('nan'):.3e}")
        if not torch.equal(ok_c, ok_h) or (both.any() and float(dz.max()) > 1e-7):
            raise AssertionError(f"{mode}: the polish on the card disagrees with the host CPU")


def polish_vs_oracle(lanes: int = 256, fov_batch: int = 8192) -> None:
    """Certified lanes against the exact oracle (native/qp_oracle.cpp built
    into build/oracle/ on the host): the first ``lanes`` lanes that
    solve_polished certifies on each recipe's IMPC-iteration-0 QPs (of
    ``lanes`` connectivity lanes, of 8192 fov lanes, where fewer certify),
    control deviation through op.U_basis below 1e-3 (tests/test_polish.py)."""
    for mode, batch in (("connectivity", lanes), ("fov", fov_batch)):
        ctrl, inputs = bench_problem(mode, batch)
        op = admm_stepper(ctrl, polish=True).op_qp
        args = iteration0(ctrl, inputs)
        sol = op.solve_polished(*args)
        pick = sol.certified.nonzero().flatten()[:lanes]
        # the oracle gets the very QPs the polish saw: the f32 data of the
        # structured split, stacked into dense rows in float64
        q, lb_s, ub_s, A_d, lb_d, ub_d = (a[pick].double().cpu().numpy() for a in args)
        B = len(pick)
        P0, A_s0 = op._P0.cpu().numpy(), op._A_s0.cpu().numpy()
        dense = (np.broadcast_to(P0, (B,) + P0.shape), q,
                 np.concatenate([np.broadcast_to(A_s0, (B,) + A_s0.shape), A_d], axis=1),
                 np.concatenate([lb_s, lb_d], axis=1), np.concatenate([ub_s, ub_d], axis=1))
        t0 = time.perf_counter()
        x_ref, status = solve_oracle_batch(*dense)
        t_oracle = time.perf_counter() - t0
        U = ctrl.op.U_basis
        n_dec = ctrl.op.n_dec
        dev = np.abs((sol.z[pick, :n_dec].double().cpu().numpy() - x_ref[:, :n_dec]) @ U.T).max(-1)
        over = {int(lane): float(d) for lane, d in zip(pick.tolist(), dev) if d >= 1e-3}
        jax_over = JAX_CPU_ORACLE_OVER[mode]
        log(f"polish against the exact oracle, {mode}: {len(pick)} certified lanes (of {batch}, "
            f"certified {float(sol.certified.float().mean()):.4f}), oracle status 0 on "
            f"{int((status == 0).sum())}, {t_oracle:.2f} s on the host; control deviation max "
            f"{dev.max():.3e}, median {np.median(dev):.3e} (bar 1e-3); lanes over the bar "
            f"{ {k: f'{v:.4e}' for k, v in over.items()} } (the JAX package on the CPU: "
            f"{ {k: f'{v:.4e}' for k, v in jax_over.items() if k <= int(pick[-1])} })")
        unexplained = [lane for lane, d in over.items()
                       if lane not in jax_over or abs(d - jax_over[lane]) > 1e-4]
        if not len(pick) or (status != 0).any() or unexplained:
            raise AssertionError(f"{mode}: certified lanes off the exact oracle: {unexplained}")


#: certified lanes of each recipe's IMPC-iteration-0 QPs (numpy seed 0; 256
#: connectivity, 8192 fov lanes) whose controls the JAX package's own f32 ADMM +
#: f64 polish leaves 1e-3 or more from the oracle on the CPU, with that
#: deviation (scripts/polish_oracle_reference.py): the reference misses the bar
#: of tests/test_polish.py there too
JAX_CPU_ORACLE_OVER = {"connectivity": {120: 1.2492e-3}, "fov": {5410: 1.4909e-3, 6071: 1.2054e-3}}


#: the reference's grid (ScaleScript.sh, apps/sweep.py:12-23): connectivity
#: teams of 2-10 robots, fov teams of 8 at three fields of view, 15 seeds
SWEEP_SIZES = (2, 4, 6, 8, 10)
SWEEP_SEEDS = 15


def sweep_shapes(R: int) -> dict:
    """The structured solve of a connectivity sweep team (base_config.json:
    slack on): 36 + R - 1 variables, 126 + R - 1 shared rows, 2 (R - 1)
    dynamic rows."""
    return dict(n=35 + R, m_s=125 + R, m_d=2 * (R - 1))


def sweep_grid(rows: dict) -> None:
    """mpc_cbf_torch.apps.sweep.main on the card, one call per grid cell:
    --controller connectivity --sizes R --seeds 15 --sim-runtime 6.0 for R
    in SWEEP_SIZES (the generic kernel, 4 launches a step, and success and
    success_ref 1.0 on every seed, asserted), then
    --controller fov --sizes 8 --fovs F --seeds 15 (the f32 IPM, no kernel)
    for F in 120, 240, 360. Prints each cell's wall time, success and
    success_ref shares and launches; fills the launches of the
    generic_sweep_r<R> rows. Returns every cell's rows."""
    out = _build.BUILD_ROOT / "sweep.jsonl"
    grid = []
    out.parent.mkdir(parents=True, exist_ok=True)
    cells = [("connectivity", R, None) for R in SWEEP_SIZES] + \
        [("fov", 8, fov) for fov in (120, 240, 360)]
    for controller, R, fov in cells:
        argv = ["--base", BASE_CONFIG, "--controller", controller, "--sizes", str(R),
                "--seeds", str(SWEEP_SEEDS), "--sim-runtime", "6.0", "--out", str(out)]
        if fov is not None:
            argv += ["--fovs", str(fov)]
        reset_counts()
        buf = io.StringIO()
        t0 = sync_clock()
        with contextlib.redirect_stdout(buf):
            rc = sweep.main(argv)                                     # --device: cuda
        wall = sync_clock() - t0
        recs = [json.loads(line) for line in out.read_text().splitlines()]
        if rc != 0 or len(recs) != SWEEP_SEEDS:
            raise AssertionError(f"sweep {controller} R={R}: rc {rc}, {len(recs)} rows")
        steps = recs[0]["steps"]
        by = {k: v for k, v in KERNEL.launches_by_variant.items() if v}
        log(f"sweep {controller} R={R}" + (f" fov={fov}" if fov else "") + f", {SWEEP_SEEDS} seeds x "
            f"{R} robots = {SWEEP_SEEDS * R} lanes, {steps} steps: {wall:.2f} s "
            f"({wall * 1e3 / steps:.2f} ms a step), success {np.mean([r['success'] for r in recs]):.4f}, "
            f"success_ref {np.mean([r['success_ref'] for r in recs]):.4f}, solver success "
            f"{np.mean([r['solver_success_rate'] for r in recs]):.4f}, min separation "
            f"{min(r['min_separation'] for r in recs):.3f} m; structured-kernel launches {by}")
        if controller == "connectivity":
            generic_launches(f"sweep connectivity R={R}", steps)
            if not all(r["success"] and r["success_ref"] for r in recs):
                raise AssertionError(f"sweep connectivity R={R}: a seed failed")
            rows[f"generic_sweep_r{R}"]["launches"] = by["generic"]
        elif by:
            raise AssertionError(f"sweep fov launched the structured kernel: {by}")
        grid.extend(recs)
    return grid


def sweep_cluster_cells(rows: dict, runtime: float = 1.0) -> None:
    """apps/sweep.py's connectivity cell at R = 128 and 256 robots, one seed
    for ``runtime`` seconds, through sweep.main on the card: the structured
    solve is (35 + R, 125 + R, 2R - 2), past every one-block layout, so each
    step must launch the cluster kernel 4 times (asserted; the launches of
    the cluster_conn<R> rows). The reference's radius-4 circle crowds such
    teams (0.2 m apart at 128 robots): the phase drives the kernel's route,
    it does not score the flight."""
    out = _build.BUILD_ROOT / "sweep_cluster.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    for R in (128, 256):
        argv = ["--base", BASE_CONFIG, "--controller", "connectivity", "--sizes", str(R),
                "--seeds", "1", "--sim-runtime", str(runtime), "--out", str(out)]
        reset_counts()
        buf = io.StringIO()
        t0 = sync_clock()
        with contextlib.redirect_stdout(buf):
            rc = sweep.main(argv)                                     # --device: cuda
        wall = sync_clock() - t0
        recs = [json.loads(line) for line in out.read_text().splitlines()]
        if rc != 0 or len(recs) != 1:
            raise AssertionError(f"sweep connectivity R={R}: rc {rc}, {len(recs)} rows")
        steps = recs[0]["steps"]
        by = {k: v for k, v in KERNEL.launches_by_variant.items() if v}
        if by != {"cluster": len(RUN_SIM_PHASES) * steps}:
            raise AssertionError(f"sweep connectivity R={R} launched {by} in {steps} steps, "
                                 f"expected the cluster kernel {len(RUN_SIM_PHASES)} times a step")
        if not np.isfinite(recs[0]["final_goal_dist_max"]):
            raise AssertionError(f"sweep connectivity R={R}: a trajectory is not finite")
        rows[f"cluster_conn{R}"]["launches"] = by["cluster"]
        log(f"sweep connectivity R={R}, 1 seed x {R} robots = {R} lanes, {steps} steps: "
            f"{wall:.2f} s ({wall * 1e3 / steps:.2f} ms a step), solver success "
            f"{recs[0]['solver_success_rate']:.4f}, min separation {recs[0]['min_separation']:.3f} "
            f"m; structured-kernel launches {by}")


def stamp_steps(sim) -> list:
    """Make sim.control_step note the synchronised host time it is entered
    at; returns the list the times go to (the sims are frozen dataclasses,
    so the method is shadowed on the object)."""
    stamps = []
    control_step = sim.control_step

    def stamped(*a, **k):
        stamps.append(sync_clock())
        return control_step(*a, **k)
    object.__setattr__(sim, "control_step", stamped)
    return stamps


def closed_loop(robots: int = 8, scenarios: int = 1024, steps: int = 10) -> None:
    """MultiAgentSim rollout of fov teams with the f32 IPM, all scenarios
    as one batch of robots x scenarios lanes per step: every trajectory
    finite (not timed: the benchmark's fov8.fleet times this traffic)."""
    tasks = [random_instance(robots, seed=s)["tasks"] for s in range(scenarios)]
    so = np.array([t["so"] for t in tasks])
    sf = np.array([t["sf"] for t in tasks])
    T = lambda a: torch.as_tensor(a, dtype=F32, device=DEV)
    sim = MultiAgentSim(fov_controller(robots - 1), robots, structured=True,
                        solver_cfg=IPM_F32_ENTRY)
    res = sim.rollout(State(T(so), T(np.zeros_like(so))), T(sf), steps)
    traj = res.traj_pos.cpu().numpy()                     # [S, T, A, 3]
    if not (np.isfinite(traj).all() and np.isfinite(res.traj_vel.cpu().numpy()).all()):
        raise AssertionError("closed loop: a trajectory is not finite")
    passed = [instance_success(traj[s].transpose(1, 0, 2), sf[s])[0] for s in range(scenarios)]
    log(f"closed loop, fov f32 IPM, {robots} robots x {scenarios} scenarios = "
        f"{robots * scenarios} lanes, {steps} steps: every trajectory finite; mean per-step "
        f"solver success {float(res.success.float().mean()):.4f}; instance_success "
        f"{np.mean(passed):.4f} of scenarios")


# ---------------------------------------------------------------------------
# the dense ADMM and the controllers that run on it
# ---------------------------------------------------------------------------

RUN_SIM_ITERS = 200          # run_sim's --solver-iters default


def sweep_instance(robots: int, scenarios: int):
    """apps/sweep.py's batch (:60-70): circle_rotate_instance at the
    reference's fixed radius 4 with 0.05 m of start noise per scenario (numpy
    seed 0). Returns (init State [S, A, 3], goals [S, A, 3], sf)."""
    tasks = circle_rotate_instance(robots, radius=4.0)["tasks"]
    so, sf = np.asarray(tasks["so"]), np.asarray(tasks["sf"])
    rng = np.random.default_rng(0)
    so_b = so[None] + np.concatenate([rng.normal(0, 0.05, (scenarios, robots, 2)),
                                      np.zeros((scenarios, robots, 1))], -1)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F32, device=DEV)
    init = State(T(so_b), T(np.zeros_like(so_b)))
    return init, T(np.broadcast_to(sf, so_b.shape)), sf


def dense_vs_f64(what: str, qp, n_cmp: int, lanes64: int = 512) -> None:
    """One batch of QPs through the dense ADMM as run_sim configures it:
    converged share, wall time, launches, and the distance to the same
    solver in float64 on the card on the first lanes64 lanes, taken on the
    first n_cmp columns of z (the control or the curve: the slack columns
    behind them reach 1e5 on violated rows and are compared relatively)."""
    cfg = ADMMConfig(iters=RUN_SIM_ITERS)
    B, n, m = qp.q.shape[0], qp.n, qp.m
    solve = lambda: solve_batch(qp, cfg)
    solve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sol, times = timed_calls(solve, 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, busy, wall = profile_counts(solve)
    if KERNEL.launches:
        raise AssertionError("the dense ADMM launched the structured kernel")
    if tuple(sol.z.shape) != (B, n) or tuple(sol.y.shape) != (B, m):
        raise AssertionError(f"{what}: solution shapes {tuple(sol.z.shape)}, {tuple(sol.y.shape)}")
    conv = float(sol.converged.float().mean())
    if not bool(torch.isfinite(sol.z[sol.converged]).all()):
        raise AssertionError(f"{what}: a converged lane is not finite")
    head = type(qp)(*(a[:lanes64].double() if a.shape[0] == B else a.double() for a in qp))
    ref = solve_batch(head, cfg)
    # float64 keeps tighter bars (1e-5 primal, 1e-3 dual) and seldom meets
    # them in 200 iterations, so the distance is taken on every lane that
    # is finite in both runs and, apart, on the lanes float32 calls converged
    z32 = sol.z[:lanes64].double()
    finite = torch.isfinite(z32).all(-1) & torch.isfinite(ref.z).all(-1)
    dz = (z32 - ref.z)[:, :n_cmp].abs().amax(-1)
    slack_rel = ((z32 - ref.z)[:, n_cmp:].abs() / ref.z[:, n_cmp:].abs().clamp_min(1.0))[finite]
    conv32 = sol.converged[:lanes64] & finite
    if not bool(finite.any()) or not bool(conv32.any()):
        raise AssertionError(f"{what}: no lane of the first {lanes64} is finite and converged")
    log(f"dense ADMM, {what} (n = {n}, m = {m}), {B} lanes, {cfg.iters} iterations: converged "
        f"{conv:.4f}, primal residual <= 0.05 on {float((sol.pri_res <= 0.05).float().mean()):.4f}, "
        f"{spread(times)}, {launches} kernel launches a solve, device busy "
        f"{busy:.2f} ms of {wall:.2f} ms under the profiler, peak device memory {peak:.3f} GiB; "
        f"float64 on the card, first {lanes64} lanes: converged by its own bars "
        f"{float(ref.converged.float().mean()):.4f} (float32 "
        f"{float(sol.converged[:lanes64].float().mean()):.4f}), primal residual <= 0.05 on "
        f"{float((ref.pri_res <= 0.05).float().mean()):.4f} (float32 "
        f"{float((sol.pri_res[:lanes64] <= 0.05).float().mean()):.4f}), |dz| on {int(finite.sum())} finite "
        f"lanes median {float(dz[finite].median()):.3e}, max {float(dz[finite].max()):.3e}; on "
        f"the {int(conv32.sum())} lanes float32 calls converged max {float(dz[conv32].max()):.3e}"
        + (f"; slack columns, relative: max {float(slack_rel.max()):.3e}" if slack_rel.numel()
           else ""))
    # No bar on |dz| or on the shares: after 200 iterations neither precision
    # is at the optimum of the badly scaled QPs (capped bounds of -1e6 against
    # slacks of 1e6), two unconverged runs drift apart, and what float32
    # costs in lanes is the finding this phase reports.
    if not bool(torch.isfinite(sol.z).all()):
        raise AssertionError(f"{what}: a lane of the float32 dense ADMM is not finite")


def dense_admm_phase() -> None:
    """The dense ADMM against float64: the fov flagship's IMPC-iteration-0
    QPs at 8192 lanes and the cbf-fov QPs of an 8-robot sweep batch at 32768
    lanes; then FovIMPCCBF.optimize (the dense IMPC step) at 8192 lanes."""
    reset_counts()
    ctrl, (cur, ref, nbr, mask) = bench_problem("fov", 8192)
    ctrl.solver = ADMMConfig(iters=RUN_SIM_ITERS)
    H = ctrl.impc.cbf_horizon
    pred = cur.stacked[:, None, :].expand(8192, H, 6)
    qp = ctrl.assemble(cur, ref, nbr, mask, pred, torch.arange(H, device=DEV) == 0)
    dense_vs_f64("fov flagship QPs", qp, n_cmp=ctrl.op.n_dec)
    del qp

    cfg = cfgmod.load_config(BASE_CONFIG)
    sim, _ = run_sim.build_sim(cfg, "cbf-fov", 8, RUN_SIM_ITERS, device=DEV)
    init, goals, _ = sweep_instance(8, 4096)
    xy, cov = sim._true_estimates(init)
    flat = lambda x: x.reshape(8 * 4096, *x.shape[2:])
    qp = sim.controller.assemble(flat(init.stacked), flat(sim._nominal(init, goals)), flat(xy),
                                 flat(cov), torch.ones((8 * 4096, 7), dtype=torch.bool, device=DEV))
    dense_vs_f64("cbf-fov QPs", qp, n_cmp=3)
    del qp

    step = lambda: ctrl.optimize(cur, ref, nbr, mask)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, times = timed_calls(step, 2)
    usable = check_result(res, 8192)
    log(f"dense IMPC step, FovIMPCCBF.optimize, 8192 lanes, ADMM {RUN_SIM_ITERS} iterations: "
        f"usable {usable:.4f} (all iterations converged {float(res.all_converged.float().mean()):.4f}), "
        f"{spread(times)}, {8192 * 2 / statistics.median(times):.1f} solves/s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if usable < 0.5:
        raise AssertionError(f"dense IMPC step usable rate {usable:.4f} < 0.5")


def lambda2_path(timed: dict, batch: int = 32768) -> int:
    """ConnectivityIMPCCBF(enable_connectivity=True) through StructuredIMPC:
    m_d = 6 + H (1 + N) = 14 has a tiled instantiation of its own, so the
    step must launch the tiled kernel, 4 times."""
    ctrl, inputs = bench_problem("connectivity", batch, enable_connectivity=True)
    if controller_shapes(ctrl) != LAMBDA2_SHAPES:
        raise AssertionError(f"λ₂ connectivity shapes {controller_shapes(ctrl)}")
    simpc = admm_stepper(ctrl)
    phases = [p[0] for op in (simpc.op_qp, simpc.op_qp_tail) for p in op.phases]
    if (batch, phases) != (timed["lanes"], timed["phases"]):
        raise AssertionError(f"λ₂ step launches {batch} lanes for {phases}; timed alone at "
                             f"{timed['lanes']}, {timed['phases']}")
    step = lambda: simpc.optimize_batch(*inputs)
    step()
    torch.cuda.synchronize()
    reset_counts()
    res, times = timed_calls(step, 3)
    launches = KERNEL.launches // 3
    if KERNEL.launches != 12 or KERNEL.launches_by_variant["tiled"] != 12:
        raise AssertionError(f"λ₂ connectivity launched {KERNEL.launches_by_variant} in 3 calls, "
                             "expected the tiled kernel 4 times a call")
    usable = check_result(res, batch)
    plain = control_step(ctrl, inputs, use_kernel=False)
    plain()
    res_t, times_t = timed_calls(plain, 1)
    usable_t = check_result(res_t, batch)
    if KERNEL.launches != 12:
        raise AssertionError("the plain loop launched the kernel")
    lam2, _ = ctrl.cbf.lambda2(torch.cat([inputs[0].pos[:, None, :2], inputs[2][..., :2]], 1))
    conn = lam2 > ctrl.LAMBDA2_THRESHOLD
    log(f"λ₂ connectivity, {batch} lanes, ADMM through StructuredIMPC, tiled kernel x{launches} "
        f"a call: usable {usable:.4f} (plain loop {usable_t:.4f}, {times_t[0] * 1e3:.2f} ms; flags "
        f"differ on {int((res.success != res_t.success).sum())} lanes), {spread(times)}, "
        f"{batch * 2 / statistics.median(times):.1f} solves/s; λ₂ > 0.1 on "
        f"{float(conn.float().mean()):.4f} of lanes (the λ₂ row: usable "
        f"{float(res.success[conn].float().mean()):.4f}), the hard CLF rows on the rest (usable "
        f"{float(res.success[~conn].float().mean()):.4f})")
    # bench.py's random teams sit 2.5-4 m apart with d_max = 4 m: most are
    # barely connected, and three hard CLF rows at once are often infeasible
    # (the JAX package gives the same flags lane for lane on the CPU), so the
    # bar is agreement with the plain route, not a rate
    if abs(usable - usable_t) > 0.01 or usable < 0.3:
        raise AssertionError(f"λ₂ connectivity usable rates: kernel {usable:.4f}, plain "
                             f"{usable_t:.4f} (bars: within 0.01, kernel >= 0.3)")
    return launches


def eigh_check(scenarios: int = 4096, robots: int = 8) -> None:
    """The batched float32 eigh of [S, A, A] Laplacians on the card (cuSOLVER)
    against a float64 eigh on the host: time and deviation of λ₂."""
    init, _, _ = sweep_instance(robots, scenarios)
    cbf = ConnectivityCBF(2.0, 4.0, MPCParams().v_min, MPCParams().v_max)
    xy = init.pos[..., :2]
    lam2, vec = cbf.lambda2(xy)
    ms = cuda_ms(lambda: cbf.lambda2(xy), reps=5)
    lam2_host, _ = cbf.lambda2(xy.double().cpu())
    dev = (lam2.double().cpu() - lam2_host).abs()
    log(f"λ₂ of {scenarios} teams of {robots} (float32 torch.linalg.eigh of [{scenarios}, {robots}, "
        f"{robots}] on the card): {ms:.3f} ms with the adjacency; against a float64 eigh on the "
        f"host max |dλ₂| {float(dev.max()):.3e} (λ₂ {float(lam2_host.min()):.4f}.."
        f"{float(lam2_host.max()):.4f}); eigenvector norms {float(vec.norm(dim=-1).min()):.6f}.."
        f"{float(vec.norm(dim=-1).max()):.6f}")
    if float(dev.max()) > 1e-3 or not bool(torch.isfinite(vec).all()):
        raise AssertionError("the float32 eigh on the card is far from float64 on the host")


def sweep_loop(what: str, sim, robots: int, scenarios: int, steps: int,
               profile_step: bool = False) -> None:
    """A closed loop of `scenarios` sweep instances as one batch: ms per
    step, solver success, instance_success share, minimum pairwise distance
    and peak device memory. Every trajectory must be finite. No bar on the
    solver's success: on these 8-robot rings the single-step CBF-QPs mostly
    fail to converge in 200 iterations in the JAX package too
    (tests/test_torch_cbf_sims.py holds the two packages together there)."""
    init, goals, sf = sweep_instance(robots, scenarios)
    sim.control_step(init, goals)                        # warm-up (torch.func, cuSOLVER)
    torch.cuda.synchronize()
    if profile_step:
        launches, busy, wall = profile_counts(lambda: sim.control_step(init, goals))
        log(f"  one {what} control step of {robots * scenarios} lanes under torch.profiler: "
            f"{launches} kernel launches, device busy {busy:.2f} ms of {wall:.2f} ms "
            f"({100 * busy / wall:.1f} %)")
    stamps = stamp_steps(sim)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = sim.rollout(init, goals, steps)
    stamps.append(sync_clock())
    per_step = np.diff(stamps) * 1e3
    traj = res.traj_pos.cpu().numpy()                     # [S, T, A, 3]
    if not (np.isfinite(traj).all() and np.isfinite(res.traj_vel.cpu().numpy()).all()):
        raise AssertionError(f"{what}: a trajectory is not finite")
    if traj.shape != (scenarios, steps, robots, 3):
        raise AssertionError(f"{what}: trajectory shape {traj.shape}")
    passed = np.mean([instance_success(traj[s].transpose(1, 0, 2), sf)[0]
                      for s in range(scenarios)])
    d = np.linalg.norm(traj[:, :, :, None, :2] - traj[:, :, None, :, :2], axis=-1)
    d += 1e9 * np.eye(robots)
    success = float(res.success.float().mean())
    log(f"{what}, {robots} robots x {scenarios} scenarios = {robots * scenarios} lanes, {steps} "
        f"steps of 0.1 s: median {np.median(per_step):.2f} ms per step ({per_step.min():.2f}.."
        f"{per_step.max():.2f}), solver success {success:.4f}, instance_success {passed:.4f} of "
        f"scenarios, minimum pairwise distance {d.min():.3f} m, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, structured-kernel launches "
        f"{KERNEL.launches}")
    if hasattr(res, "est_mean") and not bool(torch.isfinite(res.est_mean).all()):
        raise AssertionError(f"{what}: an estimate is not finite")


def sweep_loops() -> None:
    """The closed loops that run on the dense ADMM, built as run_sim builds
    them from configs/base_config.json (slack mode on, zero noise here), at
    the width of a sweep."""
    cfg = cfgmod.load_config(BASE_CONFIG)
    cfg["physical_limits"] = dict(cfg["physical_limits"], pos_std=0.0, vel_std=0.0)
    build = lambda name, **kw: run_sim.build_sim(cfg, name, 8, RUN_SIM_ITERS, device=DEV, **kw)[0]
    sweep_loop("CBFOnlySim, cbf-fov", build("cbf-fov"), 8, 4096, 30, profile_step=True)
    sweep_loop("CBFOnlySim, cbf-fov with the particle filter (229376 filters of 256 particles)",
               build("cbf-fov", use_pf=True), 8, 4096, 30)
    sweep_loop("CBFOnlySim, cbf-connectivity", build("cbf-connectivity"), 8, 4096, 30)
    sweep_loop("BezierMPCSim, mpc", build("mpc"), 8, 1024, 20)
    dense = build("fov")
    sweep_loop("MultiAgentSim(structured=False), fov through the dense ADMM",
               MultiAgentSim(dense.controller, 8), 8, 256, 5)


#: what the JAX package's runner gives for the same command on a CPU
#: (python -m mpc_cbf_tpu.apps.run_sim ... --platform cpu, 3r/rotate, 8 s):
#: (success, solver_success_rate). Where the port misses the bar below and
#: the JAX package misses it too, the run reports both and goes on.
JAX_CPU_RUN_SIM = {
    "connectivity": (True, 0.9958), "connectivity --enable-connectivity": (True, 1.0),
    "fov": (True, 1.0), "single-shot": (True, 0.9875), "mpc": (True, 1.0),
    "cbf-connectivity": (True, 0.9917), "cbf-fov": (True, 0.9958), "cbf-fov --pf": (True, 0.9958),
}


def run_sim_team() -> tuple:
    """(shapes, phase lengths) of the structured solve that run_sim
    --controller connectivity makes for a 3-robot team (3 lanes a launch)."""
    sim, _ = run_sim.build_sim(cfgmod.load_config(BASE_CONFIG), "connectivity", 3,
                               RUN_SIM_ITERS, device=DEV)
    simpc = sim._structured_impc()
    return controller_shapes(sim.controller), tuple(
        p[0] for op in (simpc.op_qp, simpc.op_qp_tail or simpc.op_qp) for p in op.phases)


def command_line() -> int:
    """mpc_cbf_torch.apps.run_sim.main, the command a user types, on the
    3-robot rotate instance for 8 s of flight: every controller, the λ₂/CLF
    family and the particle filter. Bars (what the JAX package's runner
    reaches on these rotate instances): success and solver_success_rate >= 0.95.
    Returns the kernel launches of --controller connectivity, which must be
    the generic kernel's, one per phase of RUN_SIM_PHASES and step."""
    variants = [("connectivity",), ("connectivity", "--enable-connectivity"), ("fov",),
                ("single-shot",), ("mpc",), ("cbf-connectivity",), ("cbf-fov",),
                ("cbf-fov", "--pf")]
    out = _build.BUILD_ROOT / "run_sim_states.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    for variant in variants:
        argv = ["--base", BASE_CONFIG, "--task", TASK_3R, "--controller", variant[0],
                *variant[1:], "--sim-runtime", "8.0", "--out", str(out)]     # --device: cuda
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_sim.main(argv)
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        states = json.loads(out.read_text())
        name = " ".join(variant)
        traj = np.array([states["robots"][str(i)]["states"] for i in range(3)])
        if traj.shape != (3, summary["steps"], 6) or not np.isfinite(traj).all():
            raise AssertionError(f"run_sim {name}: states.json holds {traj.shape}")
        ms = summary["wall_s"] * 1e3 / summary["steps"]
        log(f"run_sim --controller {name}, 3r/rotate, 8 s on cuda: success {summary['success']}, "
            f"makespan {summary['makespan']}, solver_success_rate "
            f"{summary['solver_success_rate']:.4f}, {ms:.2f} ms per replan step of one team "
            f"(mean of {summary['steps']} steps, the first included; budget 100 ms: "
            f"{'within' if ms <= 100 else 'OVER'}), structured-kernel launches {KERNEL.launches} "
            f"{dict((k, v) for k, v in KERNEL.launches_by_variant.items() if v)}")
        ok = rc == 0 and summary["success"] and summary["solver_success_rate"] >= 0.95
        if not ok:
            jax_ok, jax_rate = JAX_CPU_RUN_SIM[name]
            log(f"  below the bar (success and solver_success_rate >= 0.95); the JAX package on "
                f"a CPU: success {jax_ok}, solver_success_rate {jax_rate:.4f}")
            if jax_ok and jax_rate >= 0.95:
                raise AssertionError(f"run_sim {name} misses the bar the JAX package meets")
        if variant[0] in ("connectivity", "single-shot") and not KERNEL.launches:
            raise AssertionError(f"run_sim {name} did not launch the structured ADMM kernel")
        if name == "connectivity":
            launches = KERNEL.launches
            if KERNEL.launches_by_variant["generic"] != launches \
                    or launches != len(RUN_SIM_PHASES) * summary["steps"]:
                raise AssertionError(f"run_sim {name} launched {KERNEL.launches_by_variant} in "
                                     f"{summary['steps']} steps, expected the generic kernel "
                                     f"{len(RUN_SIM_PHASES)} times a step")
    return launches


# ---------------------------------------------------------------------------
# the last modules: checkpoint/resume, scenario sharding, the deploy graph,
# the apps on the card's output, the failed-lane audit
# ---------------------------------------------------------------------------

CKPT_TEAM = 4                # the sweep's connectivity cell of 4 robots x 15 seeds


def sweep_cell_sim():
    """apps/sweep.py's connectivity cell at R = CKPT_TEAM: the sim run_cell
    builds (base_config.json, its state noise included) and its batch."""
    sim, _ = run_sim.build_sim(cfgmod.load_config(BASE_CONFIG), "connectivity", CKPT_TEAM,
                               RUN_SIM_ITERS, device=DEV)
    init, goals, _ = sweep_instance(CKPT_TEAM, SWEEP_SEEDS)
    return sim, init, goals


def generic_launches(what: str, steps: int) -> None:
    """The launches since reset_counts() must be the generic kernel's, one per
    phase of RUN_SIM_PHASES and step."""
    by = {k: v for k, v in KERNEL.launches_by_variant.items() if v}
    if by != {"generic": len(RUN_SIM_PHASES) * steps}:
        raise AssertionError(f"{what} launched {by} in {steps} steps, expected the generic "
                             f"kernel {len(RUN_SIM_PHASES)} times a step")


def checkpoint_phase(steps: int = 60, every: int = 20, crash_at: int = 40) -> None:
    """utils/checkpoint.py::checkpointed_rollout on the sweep's R = 4 cell
    (60 lanes, the generic kernel) into build/smoke_ckpt/: one run of
    ``steps`` in segments of ``every``, then a crash (a fresh directory
    stopped at ``crash_at``) and a fresh call that resumes to ``steps``.
    The resumed steps must equal the uninterrupted run's within 1e-6 and
    the success flags exactly; every call launches generic 4 times a step."""
    sim, init, goals = sweep_cell_sim()
    root = _build.BUILD_ROOT.parent / "smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(name: str, n: int):
        reset_counts()
        t0 = sync_clock()
        (tp, tv, sc), final = checkpointed_rollout(
            sim, init, goals, n, torch.Generator(device=DEV).manual_seed(0),
            Checkpointer(str(root / name)), every=every)
        wall = sync_clock() - t0
        ran = tp.shape[1]                                   # [S, T, A, 3]
        generic_launches(f"checkpointed_rollout {name} to {n}", ran)
        return (tp, tv, sc), final, wall, ran

    full, final, wall_full, _ = run("uninterrupted", steps)
    first, _, wall_a, _ = run("crashed", crash_at)
    rest, final_b, wall_b, ran = run("crashed", steps)
    if ran != steps - crash_at:
        raise AssertionError(f"the resumed call ran {ran} steps, expected {steps - crash_at}")
    dev = max(float((torch.cat([a, b], dim=1) - f).abs().max())
              for a, b, f in zip(first[:2], rest[:2], full[:2]))
    dev = max(dev, float((final_b.pos - final.pos).abs().max()))
    same_flags = torch.equal(torch.cat([first[2], rest[2]], dim=1), full[2])
    log(f"checkpoint/resume, sweep connectivity cell R={CKPT_TEAM} x {SWEEP_SEEDS} seeds "
        f"({CKPT_TEAM * SWEEP_SEEDS} lanes), {steps} steps in segments of {every}: "
        f"uninterrupted {wall_full:.2f} s; crashed at {crash_at} ({wall_a:.2f} s) and resumed "
        f"for {ran} steps ({wall_b:.2f} s); max |Δ| resumed against uninterrupted {dev:.3e} "
        f"(bar 1e-6), success flags {'equal' if same_flags else 'DIFFER'}; generic "
        f"{len(RUN_SIM_PHASES)} launches a step in each call")
    if dev > 1e-6 or not same_flags:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {dev:.3e}")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharding_phase(steps: int = 20) -> None:
    """parallel.sharded_rollout over make_mesh() (this card) against
    sim.rollout on the same R = 4 sweep cell: bitwise equal. Then
    init_distributed in a world of one (NCCL for CUDA tensors, a localhost
    port): host_scenarios_to_global returns the local batch unchanged, and
    sharded_rollout over global_mesh() is sim.rollout again."""
    sim, init, goals = sweep_cell_sim()
    mesh = make_mesh()
    reset_counts()
    t0 = sync_clock()
    res = sharded_rollout(sim, mesh, init, goals, steps)
    wall = sync_clock() - t0
    generic_launches("sharded_rollout", steps)
    ref = sim.rollout(init, goals, steps)
    fields = ("traj_pos", "traj_vel", "success", "coeffs", "certified")
    same = all(torch.equal(getattr(res, f), getattr(ref, f)) for f in fields) \
        and torch.equal(res.states.pos, ref.states.pos)
    log(f"sharded_rollout over make_mesh() {mesh.shape} on {list(mesh.devices.ravel())}, "
        f"{SWEEP_SEEDS} scenarios x {CKPT_TEAM} robots, {steps} steps: {wall:.2f} s, "
        f"{'bitwise equal to' if same else 'DIFFERS from'} sim.rollout")
    if not same:
        raise AssertionError("sharded_rollout on one card is not sim.rollout")

    distributed.init_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        gmesh = distributed.global_mesh()
        g_init, g_goals = distributed.host_scenarios_to_global(gmesh, (init, goals))
        unchanged = torch.equal(g_init.pos, init.pos) and torch.equal(g_init.vel, init.vel) \
            and torch.equal(g_goals, goals) and g_goals.device == goals.device
        g_res = sharded_rollout(sim, gmesh, g_init, g_goals, 2)
        again = torch.equal(g_res.traj_pos, sim.rollout(init, goals, 2).traj_pos)
        log(f"init_distributed, a world of one (backend {backend}): global_mesh {gmesh.shape} on "
            f"{gmesh.devices[0, 0]}; host_scenarios_to_global returns the local batch "
            f"{'unchanged' if unchanged else 'CHANGED'}; sharded_rollout over it "
            f"{'equals' if again else 'DIFFERS from'} sim.rollout")
        if not (unchanged and again):
            raise AssertionError("host_scenarios_to_global or sharded_rollout changed a world "
                                 "of one")
    finally:
        torch.distributed.destroy_process_group()


def deploy_phase(run_until: float = 8.0) -> None:
    """deploy.launch_formation on the card: tests/test_deploy.py's two robots
    (FovCBF(2π, 0.3, 20.0), ADMMConfig(iters=200), takeoff 0.5 s, filters at
    10 Hz) for ``run_until`` s of virtual time. Both plants must end within
    0.5 of their goals and the pair stay more than 0.3 apart. Prints the
    median and p95 wall ms of a ControlNode replan (the dense ADMM, no K3
    launch) beside h, and the kernel launches of one replan."""
    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device=DEV, dtype=F32)
    cbf = FovCBF(2 * np.pi, 0.3, 20.0, mpc.v_min, mpc.v_max)
    starts = np.array([[0.0, 0.7, 0.0], [4.0, -0.7, 0.0]])
    goals = np.array([[4.0, 0.7, 0.0], [0.0, -0.7, 0.0]])
    reset_counts()
    t0 = sync_clock()
    _, sched, nodes = launch_formation(
        2, starts, goals, lambda i: FovIMPCCBF(op, cbf, IMPCParams(), max_neighbors=1,
                                               solver=ADMMConfig(iters=200)),
        takeoff_time=0.5, filter_rate=10.0, device=DEV)
    sched.run_until(run_until)
    wall = sync_clock() - t0
    err = [float(np.linalg.norm(p._pos[:2] - goals[i][:2])) for i, p in enumerate(nodes["plants"])]
    p0, p1 = (np.asarray(c.path_log) for c in nodes["controllers"])
    n = min(len(p0), len(p1))
    d_min = float(np.linalg.norm(p0[:n, :2] - p1[:n, :2], axis=-1).min())
    replan = np.concatenate([c.replan_s for c in nodes["controllers"]]) * 1e3
    h_ms = mpc.h * 1e3
    launches, busy, one_ms = profile_counts(nodes["controllers"][0]._optimization_callback)
    log(f"deploy, two robots on {DEV}, {run_until} s of virtual time in {wall:.2f} s of wall: "
        f"goal errors {err[0]:.3f} / {err[1]:.3f} m (bar 0.5), min distance {d_min:.3f} m "
        f"(bar 0.3); {len(replan)} ControlNode replans, median {np.median(replan):.2f} ms, p95 "
        f"{np.percentile(replan, 95):.2f} ms, max {replan.max():.2f} ms against h = {h_ms:.0f} ms "
        f"({'within' if np.percentile(replan, 95) <= h_ms else 'OVER'} the budget); one replan "
        f"under torch.profiler: {launches} kernel launches, device busy {busy:.2f} ms of "
        f"{one_ms:.2f} ms; structured-kernel launches {KERNEL.launches}")
    if max(err) >= 0.5 or d_min <= 0.3:
        raise AssertionError(f"deploy: goal errors {err}, min distance {d_min:.3f}")
    if KERNEL.launches:
        raise AssertionError("deploy: the dense controller launched the structured kernel")


def apps_phase(grid: list) -> None:
    """The experiment apps on the card's output: statistics.aggregate over
    the sweep grid's rows (its success rates must be the rows' means), then
    generate_instances writes a 3-robot rotate task into build/, and
    run_sim.main --device cuda flies it (connectivity: success, the generic
    kernel 4 times a step)."""
    summary = sweep_statistics.aggregate(grid)
    for cell in summary:
        rows = [r for r in grid if (r["controller"], r["fov"], r["num_robots"])
                == (cell["controller"], cell["fov"], cell["num_robots"])]
        if cell["n"] != len(rows) or cell["success_rate"] != np.mean([r["success"] for r in rows]) \
                or cell["success_ref_rate"] != np.mean([r["success_ref"] for r in rows]):
            raise AssertionError(f"statistics.aggregate: {cell} against {len(rows)} rows")
        log(f"statistics: {cell['controller']} fov={cell['fov']} R={cell['num_robots']} "
            f"n={cell['n']}: success {cell['success_rate']:.4f}, success_ref "
            f"{cell['success_ref_rate']:.4f}, makespan {cell['makespan_mean']:.2f} ± "
            f"{cell['makespan_ci95']:.2f} steps")
    task = _build.BUILD_ROOT.parent / "smoke_task_3r_rotate.json"
    out = _build.BUILD_ROOT.parent / "smoke_task_states.json"
    with contextlib.redirect_stdout(io.StringIO()):
        generate_instances.main(["--kind", "rotate", "-n", "3", "-r", "2.0", "--out", str(task)])
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main(["--base", BASE_CONFIG, "--task", str(task), "--controller",
                           "connectivity", "--sim-runtime", "8.0", "--out", str(out),
                           "--device", str(DEV)])
    summ = json.loads(buf.getvalue().strip().splitlines()[-1])
    generic_launches("run_sim on the generated task", summ["steps"])
    log(f"generate_instances --kind rotate -n 3 -> {task.name}; run_sim --controller connectivity "
        f"on it ({DEV}): rc {rc}, success {summ['success']}, makespan {summ['makespan']}, solver "
        f"success {summ['solver_success_rate']:.4f}, {summ['wall_s'] * 1e3 / summ['steps']:.2f} ms "
        f"a replan step")
    if rc != 0 or not summ["success"]:
        raise AssertionError(f"run_sim on the generated task: {summ}")


def audit_phase(batch: int = 8192) -> None:
    """apps.audit_failed_lanes at ``batch`` lanes on the card: the f32 IPM's
    usable rate, its failed lanes and the oracle's status on each (host).
    Passes when the audit runs to its end; the classification is reported
    beside the JAX package's TPU record, not held to it."""
    reset_counts()
    t0 = sync_clock()
    out = audit_failed_lanes.run(batch, DEV)
    wall = sync_clock() - t0
    more = " ..." if out["failed"] > 24 else ""
    log(f"audit_failed_lanes, {batch} lanes on {DEV}: f32 IPM usable {out['usable']:.4f} (the "
        f"fov f32 IPM phase above: 0.9974 in earlier runs), failed "
        f"{out['failed']} (lanes {out['failed_lanes'][:24]}{more}); "
        f"oracle statuses on them {out.get('status_counts', {})} (0 optimal, 1 max-iter, 2 "
        f"numerical failure)" + (f", oracle's own violation on the solvable ones "
                                 f"{out['oracle_viol_max']:.2e}, the IPM's pri_res there "
                                 f"{out['pri_res_of_solvable']}" if "oracle_viol_max" in out
                                 else "") + f"; {wall:.2f} s. The JAX package on a TPU v5e "
        "(BENCH.md:192-194, 2048 lanes): 14 failed, all 14 max-iter at the oracle")
    if out["failed"] and sum(out["status_counts"].values()) != out["failed"]:
        raise AssertionError(f"audit: {out['status_counts']} for {out['failed']} failed lanes")
    if KERNEL.launches:
        raise AssertionError("audit: the f32 IPM launched the structured kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = card()
    phase("kernel build", build)
    swarm = {mode: swarm_problem(mode, scenarios=128) for mode in ("connectivity", "fov")}
    swarm_shapes = {mode: controller_shapes(ctrl) for mode, (ctrl, _) in swarm.items()}
    if swarm_shapes != {"connectivity": SWARM_CONN_SHAPES, "fov": SWARM_FOV_SHAPES}:
        raise AssertionError(f"32-agent shapes {swarm_shapes}")
    # a team size without a compiled kernel, beyond a block's shared memory: 32 rings of 24
    team24 = swarm_problem("fov", scenarios=32, A=24)
    if controller_shapes(team24[0]) != TEAM24_FOV_SHAPES:
        raise AssertionError(f"24-agent fov shapes {controller_shapes(team24[0])}")
    if run_sim_team() != (RUN_SIM_CONN_SHAPES, RUN_SIM_PHASES):
        raise AssertionError(f"run_sim's 3-robot connectivity solve is {run_sim_team()}")
    errs = phase("kernels against the twin", check_kernel)
    phase("coverage of the team sizes", coverage)

    def time_kernels() -> dict:
        return {
            # the fov flagship's route (folded, the lane's C) and the connectivity shapes' (tiled)
            "folded_fov": time_phases("fov", FOV_SHAPES, 8192),
            "tiled_connectivity": time_phases("connectivity", CONN_SHAPES, 32768),
            # at the lanes and phase lengths the 32-agent steps below give a launch:
            # all 4096 lanes (the fov step's auto lane_chunk holds them all)
            "folded_swarm_connectivity": time_phases(
                "32-agent connectivity", SWARM_CONN_SHAPES, 4096,
                phases=SWARM_PHASES["connectivity"]),
            "folded_swarm_fov": time_phases("32-agent fov", SWARM_FOV_SHAPES,
                                            launch_lanes(SWARM_FOV_SHAPES, 4096),
                                            phases=SWARM_PHASES["fov"], reps=3),
            # the 4-robot connectivity step with the λ₂/CLF rows
            "tiled_lambda2": time_phases("connectivity with the λ₂/CLF rows", LAMBDA2_SHAPES,
                                         32768),
            # the generic kernel, at the lanes a launch gets from run_sim's 3-robot team
            # (the command-line phase) and from the 24-agent step below
            "generic": time_phases("run_sim's 3-robot connectivity", RUN_SIM_CONN_SHAPES, 3,
                                   phases=RUN_SIM_PHASES),
            "generic_team24": time_phases("24-agent fov", TEAM24_FOV_SHAPES, 768,
                                          phases=SWARM_PHASES["fov"], reps=1),
            # the 40- and 64-agent fov steps below: the lanes of a launch
            **{f"cluster_fov{A}": time_phases(
                f"{A}-agent fov", shapes, TEAM_FOV_RINGS[A] * A, phases=SWARM_PHASES["fov"],
                reps=1)
               for A, shapes in ((40, TEAM40_FOV_SHAPES), (64, TEAM64_FOV_SHAPES))},
            # the 96-, 128- and 400-agent fov steps below: one ring of 96, 4 rings of 128
            # (one lane chunk of 512), a lane chunk of 256 of one ring of 400 (rows and C
            # streamed)
            "cluster_fov96": time_phases("96-agent fov", TEAM96_FOV_SHAPES, 96,
                                         phases=SWARM_PHASES["fov"], reps=3),
            "cluster_fov128": time_phases("128-agent fov", TEAM128_FOV_SHAPES,
                                          launch_lanes(TEAM128_FOV_SHAPES, 512),
                                          phases=SWARM_PHASES["fov"], reps=3),
            "cluster_fov400": time_phases("400-agent fov (rows and C streamed)",
                                          TEAM400_FOV_SHAPES, launch_lanes(TEAM400_FOV_SHAPES, 400),
                                          phases=SWARM_PHASES["fov"], reps=1),
            # alone: a lane chunk of a 256-agent fov step (rows streamed), one run_sim team
            # of 128 and of 256
            "cluster_fov256": time_phases("256-agent fov (rows streamed)", TEAM256_FOV_SHAPES,
                                          CHUNK, phases=SWARM_PHASES["fov"], reps=1),
            **{f"cluster_conn{R}": time_phases(
                f"{R}-robot connectivity", shapes, R, phases=RUN_SIM_PHASES, reps=3)
               for R, shapes in ((128, TEAM128_CONN_SHAPES), (256, TEAM256_CONN_SHAPES))},
            # the sweep's connectivity teams: 15 seeds x R robots a launch
            **{f"generic_sweep_r{R}": time_phases(
                f"sweep connectivity team of {R}", sweep_shapes(R), SWEEP_SEEDS * R,
                phases=RUN_SIM_PHASES) for R in SWEEP_SIZES},
        }
    rows = phase("kernels timed alone", time_kernels)
    _phase_inputs.cache_clear()
    torch.cuda.empty_cache()
    rows["folded_fov"]["launches"] = phase("fov ADMM step", fov_main_path)
    rows["tiled_connectivity"]["launches"] = phase("connectivity ADMM step", connectivity_path)
    rows["folded_swarm_connectivity"]["launches"] = phase(
        "32-agent connectivity step", swarm_path, "connectivity", *swarm["connectivity"],
        "folded", rows["folded_swarm_connectivity"], usable_bar=0.99)
    rows["folded_swarm_fov"]["launches"] = phase(
        "32-agent fov step", swarm_path, "fov", *swarm["fov"], "folded",
        rows["folded_swarm_fov"], usable_bar=0.97, plain=True, split=True, profile=True)
    for mode in ("connectivity", "fov"):
        phase(f"32-agent {mode} step, f32 IPM", swarm_ipm_path, mode, *swarm[mode],
              rows[f"folded_swarm_{mode}"]["step"])
    rows["generic_team24"]["launches"] = phase(
        "24-agent fov step", swarm_path, "fov", *team24, "generic", rows["generic_team24"],
        plain=True)
    del swarm, team24
    torch.cuda.empty_cache()
    for A, shapes, variant in ((40, TEAM40_FOV_SHAPES, "cluster"),
                               (64, TEAM64_FOV_SHAPES, "cluster"),
                               (96, TEAM96_FOV_SHAPES, "cluster"),
                               (128, TEAM128_FOV_SHAPES, "cluster"),
                               (400, TEAM400_FOV_SHAPES, "cluster")):
        team = swarm_problem("fov", scenarios=TEAM_FOV_RINGS[A], A=A)
        if controller_shapes(team[0]) != shapes:
            raise AssertionError(f"{A}-agent fov shapes {controller_shapes(team[0])}")
        # the cluster steps: flags against the plain loop, the wall time a median of 3 calls
        big = variant == "cluster"
        rows[f"{variant}_fov{A}"]["launches"] = phase(
            f"{A}-agent fov step", swarm_path, "fov", *team, variant, rows[f"{variant}_fov{A}"],
            plain=big, calls=3 if big else 1, split=A in (128, 400))
        del team
        torch.cuda.empty_cache()
    rows["tiled_lambda2"]["launches"] = phase("λ₂ connectivity step", lambda2_path,
                                              rows["tiled_lambda2"])
    phase("f64 IPM, card against host", ipm_device_parity)
    phase("fov f32 IPM", fov_ipm_path)
    phase("connectivity f32 IPM", connectivity_ipm_path)
    phase("fov HYBRID_PROD", fov_hybrid_path)
    phase("closed loop, fov f32 IPM", closed_loop)
    phase("dense ADMM", dense_admm_phase)
    torch.cuda.empty_cache()
    phase("batched eigh", eigh_check)
    phase("sweep loops", sweep_loops)
    rows["generic"]["launches"] = phase("command line", command_line)
    polished = {mode: phase(f"{mode} +polish", polish_path, mode)
                for mode in ("fov", "connectivity")}
    phase("polish, card against host", polish_card_vs_host)
    phase("polish against the oracle", polish_vs_oracle)
    grid = phase("sweep grid", sweep_grid, rows)
    phase("sweep cells of 128 and 256 robots", sweep_cluster_cells, rows)
    phase("checkpoint/resume", checkpoint_phase)
    phase("scenario sharding", sharding_phase)
    phase("deploy", deploy_phase)
    phase("apps on the card's output", apps_phase, grid)
    phase("audit", audit_phase)
    log("polish summary: " + json.dumps({m: {k: round(v, 4) for k, v in r.items()}
                                         for m, r in polished.items()}))
    log(f"  [all phases: {time.perf_counter() - t_start:.1f} s]")
    log(smi)                  # the card again, beside the records below
    print(json.dumps({"kernels": [{
        "name": f"structured_admm_{row}", "route": "cuda",
        "source": SOURCES[row.split("_")[0]],
        "replaces": "mpc_cbf_tpu/ops/qp/pallas_admm.py:35",
        "launches": r["launches"], "max_abs_err": errs[row], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "library_ms": None, "lanes": r["lanes"], "phases": r["phases"],
        "us_per_iter": r["us_per_iter"], "clocks_per_iter": r["clocks_per_iter"],
        "c_build_ms": r["c_build_ms"], "wk_build_ms": r["wk_build_ms"]}
        for row, r in rows.items() if row not in ALONE]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
