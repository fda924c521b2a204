"""Smoke run of the PyTorch/CUDA port (mpc_cbf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU (built for
sm_90a: an H100). It
1. prints the card (nvidia-smi name and power limit);
2. builds the CUDA kernels from csrc/ into build/kernels/ and times it;
3. holds the fused ADMM kernel against its plain PyTorch twin at the fov
   flagship shapes (ragged batch of 1000 lanes, 40 iterations) to
   rtol = atol = 2e-4, and times both at 8192 lanes for each rho phase
   length of a control step (150 + 50 cold, 32 + 32 warm);
4. drives the main path — StructuredIMPC(FovIMPCCBF) with the structured
   ADMM (iters 200, tail 64) on 8192 lanes of bench.py's fov recipe —
   checks that it launched the kernel 4 times per call and that every
   flyable lane is finite, times 5 calls, and runs the same call through
   the plain loop: the usable-lane rates must agree within 1 point;
5. runs one connectivity control step at 32768 lanes;
6. holds the f64 IPM on the card against the same solve on the host CPU
   (512 fov lanes: converged flags, z to 1e-3);
7. drives the f32 Mehrotra IPM (IPM_F32_ENTRY, bench.py's default solver)
   on the fov recipe at 8192 lanes: 5 timed calls after a warm-up, the
   usable rate (bar 0.98), peak device memory, one call with a sync around
   each stage, one call under torch.profiler (kernel launches per call,
   device share of cholesky_ex + cholesky_solve) and one call at chunk = 0;
8. the f32 IPM on connectivity at 32768 lanes (usable bar 0.99);
9. HYBRID_PROD (f32 entry + 12-iteration f64 tail) on the fov recipe at
   8192 lanes: certified lanes must be usable lanes, certified rate >= 0.95;
10. a closed loop: MultiAgentSim(structured=True) with IPM_F32_ENTRY, 8 fov
    robots x 1024 scenarios (random_instance seeds 0..1023) = 8192 lanes a
    step, 60 steps (6 s); every trajectory must be finite, and the mean
    per-step solver success and the instance_success share are reported.
Any failure raises (exit code 1). The last two lines are a JSON record of
the kernels and {"ok": true, "device": {...}}. Without a GPU, or without
the repository beside it, it exits non-zero and prints no result.

Expected on one NVIDIA H100 80GB HBM3 at 700 W (four runs, PERF.md;
the wall times follow the host): the kernel within 1.4e-5 of its twin,
38.5-38.9 ms per ADMM control step; fov ADMM usable 0.7089, 170-237 ms per
call; connectivity ADMM usable 0.9933, ~95 ms; the f64 IPM on the card
within 2.5e-4 of the host CPU; fov f32 IPM usable 0.9974, 530-850 ms per
call at chunk 2048 and 268-377 ms at chunk 0, ~46k kernel launches per
call, peak 0.48 GiB; connectivity f32 IPM usable 1.0000, 2.8-3.2 s;
HYBRID_PROD certified 0.9873, 0.93-1.23 s; closed loop 0.85-1.0 s per
step, solver success 0.9888, instance_success 0.0 (the JAX package flies
these 6-s random instances to the same places). About 135-160 s in all.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mpc_cbf_torch import _build
from mpc_cbf_torch.types import State
from mpc_cbf_torch.ops.cbf import ConnectivityCBF, FovCBF
from mpc_cbf_torch.ops.qp import fused_admm
from mpc_cbf_torch.ops.qp.ipm import HYBRID_PROD, IPM_F32_ENTRY, IPMConfig, StructuredIPM
from mpc_cbf_torch.ops.qp.structured import StructuredConfig
from mpc_cbf_torch.controllers import (
    BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
    ConnectivityIMPCCBF, FovIMPCCBF, StructuredIMPC)
from mpc_cbf_torch.parallel import MultiAgentSim
from mpc_cbf_torch.utils.instances import random_instance
from mpc_cbf_torch.utils.metrics import instance_success

DEV = torch.device("cuda")
F32 = torch.float32
FOV_SHAPES = dict(n=43, m_s=127, m_d=84)      # fov flagship: 36 + 7 slack columns
PHASES = (150, 50, 32, 32)                   # cold soft/stiff, warm soft/stiff
RTOL = ATOL = 2e-4                           # tests/test_pallas_admm.py:53-55
KERNEL = fused_admm.structured_admm_iterations


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs, after one warm-up run."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
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
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "# " in line[:2]:
            log(f"  {line.strip()}")


def phase_inputs(B: int, seed: int):
    arrays = fused_admm.random_phase_inputs(np.random.default_rng(seed), B, **FOV_SHAPES)
    return [torch.from_numpy(a).to(DEV) for a in arrays]


def check_kernel(B: int = 1000, iters: int = 40) -> float:
    """Kernel against the twin on one ragged batch; returns the max abs error."""
    args = phase_inputs(B, seed=0)
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    out_k = KERNEL(*args, **kw)
    out_t = fused_admm.structured_admm_iterations_ref(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, k, t in zip(("x", "zs", "zd", "ys", "yd"), out_k, out_t):
        dev = (k - t).abs()
        bad = int((dev > ATOL + RTOL * t.abs()).sum())
        if bad or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"kernel vs twin, {name}: {bad} entries beyond "
                                 f"rtol=atol={RTOL}, max |dev| {float(dev.max()):.3e}")
        err = max(err, float(dev.max()))
    log(f"kernel vs twin at B={B}, {iters} iterations: max |dev| {err:.3e} "
        f"(rtol = atol = {RTOL})")
    return err


def time_phases(B: int = 8192):
    """Device ms of kernel and twin per rho phase length at B lanes."""
    args = phase_inputs(B, seed=1)
    out = {}
    for iters in sorted(set(PHASES)):
        kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
        k_ms = cuda_ms(lambda: KERNEL(*args, **kw), reps=5)
        t_ms = cuda_ms(lambda: fused_admm.structured_admm_iterations_ref(*args, **kw), reps=2)
        out[iters] = (k_ms, t_ms)
        log(f"phase of {iters:3d} iterations at B={B}: kernel {k_ms:.3f} ms, "
            f"plain twin {t_ms:.3f} ms ({t_ms / k_ms:.1f}x)")
    k_sum = sum(out[i][0] for i in PHASES)
    t_sum = sum(out[i][1] for i in PHASES)
    log(f"one control step's 4 phases at B={B}: kernel {k_sum:.3f} ms, twin {t_sum:.3f} ms")
    return k_sum, t_sum


def fov_controller(N: int = 7):
    """bench.py's fov controller (bench.py:73-86): an (N+1)-robot team."""
    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device=DEV, dtype=F32)
    cbf = FovCBF(120.0 * np.pi / 180.0, 0.3, 6.0, mpc.v_min, mpc.v_max)
    return FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), N,
                      box_half_extents=np.array([0.1, 0.1, 0.0]))


def bench_problem(mode: str, batch: int):
    """bench.py's recipe (bench.py:73-108,143-147), numpy seed 0, on the card."""
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
                                   IMPCParams(), N)
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


def control_step(ctrl, inputs, **cfg):
    simpc = StructuredIMPC(ctrl, StructuredConfig(iters=200, iters_tail=64, **cfg))
    return lambda: simpc.optimize_batch(*inputs)


def check_result(res, batch: int) -> float:
    if tuple(res.coeffs.shape) != (batch, 36):
        raise AssertionError(f"coeffs shape {tuple(res.coeffs.shape)}")
    if not bool(torch.isfinite(res.coeffs[res.flyable]).all()):
        raise AssertionError("a flyable lane has non-finite coefficients")
    return float(res.success.float().mean())


def fov_main_path(batch: int = 8192):
    ctrl, inputs = bench_problem("fov", batch)
    step = control_step(ctrl, inputs)
    step()                                   # warm-up (torch.func, cuBLAS, cuSOLVER)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    res = step()
    torch.cuda.synchronize()
    launches = KERNEL.launches
    if launches != 4:
        raise AssertionError(f"main path launched the kernel {launches} times, expected 4")
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

    plain = control_step(ctrl, inputs, use_kernel=False)
    plain()
    t0 = sync_clock()
    res_t = plain()
    t_t = sync_clock() - t0
    if KERNEL.launches != launches + 20:
        raise AssertionError("the plain loop launched the kernel")
    usable_t = check_result(res_t, batch)
    log(f"fov main path, {batch} lanes, plain loop: usable {usable_t:.4f}, "
        f"{t_t * 1e3:.2f} ms, {batch * 2 / t_t:.1f} solves/s")
    if abs(usable - usable_t) > 0.01:
        raise AssertionError(f"usable rates differ: kernel {usable:.4f}, plain {usable_t:.4f}")
    both = res_k.success & res_t.success
    dev = (res_k.coeffs - res_t.coeffs).abs().amax(-1)[both]
    log(f"  kernel vs plain coefficients on {int(both.sum())} lanes usable in both: "
        f"median {float(dev.median()):.2e}, p99 {float(dev.quantile(0.99)):.2e}, "
        f"max {float(dev.max()):.2e}; success flags differ on "
        f"{int((res_k.success != res_t.success).sum())} lanes")
    return launches


def connectivity_path(batch: int = 32768) -> None:
    ctrl, inputs = bench_problem("connectivity", batch)
    step = control_step(ctrl, inputs)
    step()
    before = KERNEL.launches
    t0 = sync_clock()
    res = step()
    dt = sync_clock() - t0
    if KERNEL.launches - before != 4:
        raise AssertionError("connectivity step did not launch the kernel 4 times")
    usable = check_result(res, batch)
    log(f"connectivity, {batch} lanes, kernel: usable {usable:.4f}, {dt * 1e3:.2f} ms, "
        f"{batch * 2 / dt:.1f} solves/s")


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


def stage_split(simpc, inputs) -> None:
    """One call with a sync around each stage: the assembly (cost vector,
    shared bounds, dynamic rows) and each IMPC iteration's solve."""
    rec = []

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = sync_clock()
            out = fn(*a, **k)
            rec.append((label, sync_clock() - t0))
            return out
        setattr(obj, name, timed)             # shadows the method on this object only

    hooks = [(simpc.ctrl, "cost_vector", "assembly: cost_vector"),
             (simpc.ctrl, "shared_bounds", "assembly: shared_bounds"),
             (simpc.ctrl, "dynamic_rows", "assembly: dynamic_rows"),
             (simpc.op_qp, "solve", "solve")]
    tail = simpc.op_qp_tail
    if tail is not None:
        # a HybridIPM's entry is op_qp itself, so time only its f64 tail
        hooks.append((tail.tail, "solve", "solve: f64 tail") if hasattr(tail, "tail")
                     else (tail, "solve", "solve (tail operator)"))
    for obj, name, label in hooks:
        wrap(obj, name, label)
    try:
        t0 = sync_clock()
        simpc.optimize_batch(*inputs)
        total = sync_clock() - t0
    finally:
        for obj, name, _ in hooks:
            delattr(obj, name)
    log(f"  stage split of one call (sync around each stage), {total * 1e3:.2f} ms in all:")
    for label, sec in rec:
        log(f"    {label:28s} {sec * 1e3:9.2f} ms")
    log(f"    {'rest of optimize_batch':28s} {(total - sum(s for _, s in rec)) * 1e3:9.2f} ms")


def _device_us(evt, total: bool) -> float:
    names = ("device_time_total", "cuda_time_total") if total else \
        ("self_device_time_total", "self_cuda_time_total")
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_call(step) -> int:
    """One call under torch.profiler: kernel launches, device busy time and
    the share of cholesky_ex + cholesky_solve. Returns the launch count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = sync_clock()
        step()
        wall = sync_clock() - t0
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in kernels)
    busy = sum(_device_us(e, total=False) for e in kernels)
    chol = sum(_device_us(e, total=True) for e in avgs
               if e.key in ("aten::linalg_cholesky_ex", "aten::cholesky_solve"))
    if busy <= 0:
        log(f"  profiled call ({wall * 1e3:.2f} ms wall): {launches} kernel launches; "
            "device time not measured (the profiler saw none)")
        return launches
    log(f"  profiled call ({wall * 1e3:.2f} ms wall under the profiler): {launches} kernel "
        f"launches, device busy {busy / 1e3:.2f} ms; cholesky_ex + cholesky_solve "
        f"{chol / 1e3:.2f} ms = {100 * chol / busy:.1f} % of device time")
    for e in sorted(kernels, key=lambda e: -_device_us(e, total=False))[:8]:
        log(f"    {_device_us(e, total=False) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return launches


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
    KERNEL.launches = 0
    res, times = timed_calls(step, 5)
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
    res0, times0 = timed_calls(step0, 3)
    usable0 = check_result(res0, batch)
    log(f"  chunk = 0 (one chunk of {batch}): usable {usable0:.4f}, {spread(times0)}; "
        f"chunk = {IPM_F32_ENTRY.chunk}: {t * 1e3:.2f} ms; success flags differ on "
        f"{int((res0.success != res.success).sum())} lanes")


def connectivity_ipm_path(batch: int = 32768) -> None:
    ctrl, inputs = bench_problem("connectivity", batch)
    simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)
    step = lambda: simpc.optimize_batch(*inputs)
    step()
    res, times = timed_calls(step, 3)
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
    res, times = timed_calls(step, 3)
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


def closed_loop(robots: int = 8, scenarios: int = 1024, steps: int = 60) -> None:
    """MultiAgentSim rollout of fov teams with the f32 IPM, all scenarios
    as one batch of robots x scenarios lanes per step."""
    tasks = [random_instance(robots, seed=s)["tasks"] for s in range(scenarios)]
    so = np.array([t["so"] for t in tasks])
    sf = np.array([t["sf"] for t in tasks])
    T = lambda a: torch.as_tensor(a, dtype=F32, device=DEV)
    sim = MultiAgentSim(fov_controller(robots - 1), robots, structured=True,
                        solver_cfg=IPM_F32_ENTRY)
    stamps = []
    control_step = sim.control_step

    def stamped(*a, **k):
        stamps.append(sync_clock())
        return control_step(*a, **k)
    object.__setattr__(sim, "control_step", stamped)      # the sim is a frozen dataclass

    t0 = sync_clock()
    res = sim.rollout(State(T(so), T(np.zeros_like(so))), T(sf), steps)
    stamps.append(sync_clock())
    per_step = np.diff(stamps)
    traj = res.traj_pos.cpu().numpy()                     # [S, T, A, 3]
    if not (np.isfinite(traj).all() and np.isfinite(res.traj_vel.cpu().numpy()).all()):
        raise AssertionError("closed loop: a trajectory is not finite")
    passed = [instance_success(traj[s].transpose(1, 0, 2), sf[s])[0] for s in range(scenarios)]
    log(f"closed loop, fov f32 IPM, {robots} robots x {scenarios} scenarios = "
        f"{robots * scenarios} lanes, {steps} steps: {(stamps[-1] - t0):.2f} s in all, "
        f"median {np.median(per_step) * 1e3:.2f} ms per step "
        f"({per_step.min() * 1e3:.2f}..{per_step.max() * 1e3:.2f}); mean per-step solver "
        f"success {float(res.success.float().mean()):.4f}; instance_success "
        f"{np.mean(passed):.4f} of scenarios")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card()
    build()
    err = check_kernel()
    k_ms, t_ms = time_phases()
    launches = fov_main_path()
    connectivity_path()
    ipm_device_parity()
    fov_ipm_path()
    connectivity_ipm_path()
    fov_hybrid_path()
    closed_loop()
    print(json.dumps({"kernels": [{
        "name": "structured_admm", "route": "cuda",
        "source": "mpc_cbf_torch/csrc/structured_admm.cu",
        "replaces": "mpc_cbf_tpu/ops/qp/pallas_admm.py:35",
        "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": t_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
