"""The benchmark of mpc_cbf_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``portbench/configs/<config>.json``,
its traffic ``portbench/workloads/<traffic>.json``, and each per-layer
metric it reports ``portbench/metrics/<metric>.py``: a cell, a
configuration or a metric is added by adding files and entries.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (and with ``--trace 1``
``breakdown``), and last ``check``: each number compared with its limit.
There is no CPU fallback: without a CUDA device it exits with code 2.

The two controls of the correctness check, which no cell runs:
``--control tf32`` runs the program with PyTorch's TF32 matmul path on (the
step below the float32 with TF32 off that the configurations state);
``--control reference_tf32`` judges, in the program's place, the
reference's own answers and flights with their products in TF32;
``--control c_float32`` runs the program with its ADMM's x-update operand C,
which the configuration states in float64, built in float32.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# run as a script, the folder itself heads the path; its modules (trace,
# check) would hide the standard library's, so the checkout's root goes there
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_cbf_tpu")


def process_start_s() -> float:
    """Seconds since this process was started (Linux), else since import."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the kernel library goes to build/kernels/ by the program's own rule),
    and one host thread for the libraries' own pools: the run's host work is
    launches from one thread, and idle pool threads only add jitter."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traced(bench: dict, cell: str, cfg: dict, traffic: dict, load, spans, win: dict,
           on_gpu: bool):
    """Whole steps under torch.profiler after the window, and the cell's
    per-layer metrics read from them and from the window's spans. Returns
    (metrics, breakdown, the device's busy_s and window_s, a line to print)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import roofline
    from portbench.reference.assembly import Reference
    from portbench.trace import Trace

    steps = int(traffic["trace_steps"])
    window_ms = dict(spans.ms)
    # the profiled steps overlap host and device as the untimed ones do
    spans.sync = False
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu else [])
    with profile(activities=acts) as prof:
        load.traced(steps, spans)
    tr = Trace(prof)
    lo, hi = tr.window()
    bound = None
    if cfg["solver"]["kind"] == "admm":
        shapes = Reference(cfg, torch.device("cpu"))
        bound = roofline.admm_bound_s(win["lanes"], shapes.n, shapes.m_s, shapes.m_d,
                                      list(cfg["solver"]["phases"]) * shapes.impc_iter)
    run = {"kind": traffic["kind"], "steps": win["steps"], "span_ms": window_ms, "trace": tr,
           "traced_steps": steps, "window_ns": (lo, hi), "admm_bound_s": bound}
    reported = {e["name"] for e in bench["end_to_end"] if cell in e.get("workloads", [cell])}
    metrics = {}
    for m in bench["per_layer"]:
        if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in reported):
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    busy = tr.busy_ns(lo, hi)
    line = (f"traced {steps} steps: {(hi - lo) * 1e-9:.4f} s, device busy {busy * 1e-9:.4f} s, "
            f"{len(tr.kernels)} kernels, {tr.launched} of them matched to their launch call")
    return metrics, tr.breakdown(), {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9}, line


def folded_c_float32(M_s, Ad, rho_d):
    """The control ``c_float32``: the program's C = (M_s + Ad' diag(rho_d)
    Ad)^-1, a Cholesky factor and two triangular solves, all in float32,
    handed on as the float64 the kernel takes."""
    import torch

    B, _, n = Ad.shape
    lo = torch.float32
    Aw = Ad.to(lo) * torch.sqrt(rho_d.to(lo))[..., None]
    L, info = torch.linalg.cholesky_ex(torch.baddbmm(M_s.to(lo), Aw.mT, Aw))
    L = L.masked_fill((info != 0)[:, None, None], float("nan"))
    eye = torch.eye(n, dtype=lo, device=Ad.device).expand(B, n, n)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, L_inv, upper=True).to(torch.float64)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, *, device=None, control=None, fault=None, bench_path=None) -> int:
    """device, fault and bench_path are for the benchmark's own tests, which
    drive a run on the CPU with the program broken underneath."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "reference_tf32", "c_float32"),
                   default=control)
    args = p.parse_args(argv)

    environment()
    import torch
    torch.set_num_threads(1)

    bench = load_json(Path(bench_path) if bench_path else ROOT / "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"device_count {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_gpu = device.type == "cuda"

    from portbench import check, drive
    from portbench.trace import Spans

    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "workloads" / f"{cell['traffic']}.json")
    R = int(cfg["robots"])
    seed = args.seed % (2 ** 63)
    import numpy as np
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)

    t_built = process_start_s()
    sim = drive.build(cfg, device)
    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    simpc = sim._structured_impc()
    if args.control == "c_float32":
        if not hasattr(simpc.op_qp, "folded_c") or simpc.op_qp.wk_form:
            raise SystemExit("portbench: --control c_float32 needs an ADMM that builds C")
        object.__setattr__(simpc.op_qp, "folded_c", folded_c_float32)
    spans = Spans(sync=on_gpu) if args.trace else None
    if spans is not None:
        for attr in ("cost_vector", "shared_bounds", "dynamic_rows"):
            spans.wrap(simpc.ctrl, attr, "assembly")
        spans.wrap(simpc.op_qp, "solve", "solve")
        spans.wrap(sim, "control_step", "control_step")
        spans.wrap(sim, "fly", "fly")
    if fault is not None:
        fault(sim, simpc)
    rec = drive.Recorder(sim, R)
    if traffic["kind"] != "fleet":
        raise SystemExit(f"portbench: traffic kind {traffic['kind']!r} has no driver")
    load = drive.Fleet(sim, traffic, R, rng, device, rec)

    from mpc_cbf_torch.ops.qp import fused_admm
    counter = fused_admm.structured_admm_iterations.launches_by_variant

    t_warm = process_start_s()
    load.warm_up()
    setup_s = process_start_s()
    if spans is not None:
        spans.ms.clear()
    before = dict(counter)
    # what set-up made is kept for good: the collector then walks only what
    # the window makes
    gc.collect()
    gc.freeze()
    rec.on = True
    win = load.window(args.seconds)
    rec.on = False
    after = dict(counter)
    mem_peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    mem_reserved = torch.cuda.max_memory_reserved(device) if on_gpu else 0
    per_step = {k: (after[k] - before.get(k, 0)) / win["steps"] for k in after
                if after[k] != before.get(k, 0)}

    # the quantities an end-to-end metric can be; a metric's name before its
    # first dot says which one it reports (solves_per_s.admm is solves_per_s)
    e2e = {"setup_s": (setup_s, "s"),
           "usable_rate": (win["usable"] / win["lane_steps"], "share")}
    e2e["solves_per_s"] = (win["lanes"] * int(cfg["base"]["cbf_params"]["impc_iter"])
                           * win["steps"] / win["window_s"], "solves/s")
    lines = [f"set-up: {t_built:.2f} s of imports, {t_warm - t_built:.2f} s to reach the device and "
             f"build the closed loop, {setup_s - t_warm:.2f} s of warm-up steps",
             f"window: {win['steps']} steps of {win['lanes']} lanes in {win['window_s']:.3f} s; "
             f"usable {win['usable']} of {win['lane_steps']} lane-steps"]
    lines.append("episodes: " + ", ".join(f"{t:.3f}" for t in win["episode_s"]) + " s")
    expect = cfg.get("kernel_route", {})
    route = ", ".join(f"{k} x{v:g}" for k, v in sorted(per_step.items())) or "no K3 launch"
    lines.append(f"kernel route per step: {route} (the configuration expects "
                 f"{', '.join(f'{k} x{v:g}' for k, v in expect.items()) or 'no K3 launch'})"
                 + ("" if per_step == {k: float(v) for k, v in expect.items()}
                    else "  ROUTE DIFFERS FROM THE EXPECTED ONE"))
    lines.append(f"device memory: peak allocated {mem_peak} B, peak reserved {mem_reserved} B")

    metrics, breakdown, dev_extra = {}, None, {}
    if args.trace:
        metrics, breakdown, dev_extra, line = traced(bench, args.workload, cfg, traffic, load,
                                                     spans, win, on_gpu)
        lines.append(line)
    else:
        for m in bench["end_to_end"]:
            base = m["name"].split(".")[0]
            if base in e2e and args.workload in m.get("workloads", [args.workload]):
                v, unit = e2e[base]
                metrics[m["name"]] = {"value": v, "unit": unit}

    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}; the benchmark may load "
              "no JAX and no JAX package", file=sys.stderr)
        return 3

    # the window's state goes before the reference runs on the same device
    del load, sim, simpc
    if on_gpu:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    judged = check.judge(cfg, rec, device, tf32_reference=args.control == "reference_tf32")
    limits = cfg["check_limits"]
    compared = {k: [v, limits[k]] for k, v in judged.numbers.items() if k in limits}
    correct = bool(compared) and set(compared) == set(limits) and \
        all(v <= lim for v, lim in compared.values())
    lines += judged.notes
    lines.append("read, not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in judged.numbers.items() if k not in limits))
    lines.append(f"check took {time.perf_counter() - t_check:.2f} s")
    for line in lines:
        print(f"portbench: {line}", file=sys.stderr)
    for k, (v, lim) in compared.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)

    device_info = {"platform": "gpu" if on_gpu else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(mem_peak)}
    device_info.update(dev_extra)
    out = {"correct": bool(correct), "attempted": int(win["lane_steps"]),
           "failed": int(win["lane_steps"] - win["usable"]), "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
