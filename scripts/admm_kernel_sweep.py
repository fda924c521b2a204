"""Time other block layouts of the structured-ADMM kernels on the card.

    python3 scripts/admm_kernel_sweep.py [--fov LAYOUT ...] [--conn LAYOUT ...]
                                         [--lambda2 LAYOUT ...]
                                         [--swarm-conn LAYOUT ...] [--swarm-fov LAYOUT ...]
                                         [--folded-at fov|lambda2 LAYOUT ...]
                                         [--generic LAYOUT ...] [--generic-team24 LAYOUT ...]
                                         [--generic-wide LAYOUT ...] [--cluster [LAYOUT ...]]
                                         [--timing-check]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
The package's kernel sources carry one layout per shape: the ``Shape<...>``
lines at the end of mpc_cbf_torch/csrc/structured_admm_tiled.cu (fov,
connectivity, connectivity with the λ₂/CLF rows) and the ``FoldedShape<...>``
lines at the end of csrc/structured_admm_folded.cu (32-agent fov, 32-agent
connectivity). A LAYOUT of the tiled kernel is G,L,TPL (groups a block,
lanes a group, threads a lane) or G,L,TPL,RG,CG (also the grid of register
tiles A_d is cut into); one of the folded kernel is T,RG,CG (threads a
block, the grid of register tiles [A_s; A_d] is cut into) or T,RG,CG,KC
(also the rows of A_d the prologue stages at a time). Only the shapes named
by an option are built and timed; with no option, the fov, connectivity and
λ₂ shapes with their defaults. The i-th layout of every shape is built
together (a shorter list repeats its last): this script writes a copy of
csrc/ with those lines changed into build/sweep/<layouts>/, compiles it with
the package's flags, prints ptxas' registers and spills of the
instantiations, holds the kernel against the plain twin on 256 lanes (20
iterations) and times one rho phase of each length of a control step at the
lanes a launch gets there (CUDA events, mean of 3 launches after a warm-up):
150 + 50 + 32 + 32 iterations at 8192 fov lanes and 32768 connectivity
lanes, 4 x 50 at the 4096 lanes of the 32-agent connectivity step, 550 + 50
+ 150 + 50 at one 2048-lane chunk of the 32-agent fov step. --folded-at tries the folded kernel at a shape the package gives to
the tiled kernel (fov or lambda2): the copy's ``SwarmConn`` line of the
folded source becomes that shape with the layouts T,RG,CG,KC, launched by
name beside the tiled kernel of the same copy (so not together with
--swarm-conn, which rewrites the same line). --generic times the generic
kernel (csrc/structured_admm_generic.cu) at the sweep's team of 10 (45, 135,
18) on 150 lanes and run_sim's 3-robot team (38, 128, 4) on 3 lanes (150 +
50 + 150 + 50 iterations), with the copy's ``RegN64`` line (the one both
shapes take) changed; --generic-team24 at the 24-agent fov team (59, 143,
276) on 768 lanes (550 + 50 + 150 + 50), with the ``RegN64Tall`` line
changed; --generic-wide at the fov teams of 40 and 64 agents (75, 159, 468),
(99, 183, 756) on 768 lanes (the same phases), with the ``FromMemory`` line
changed. --cluster times the cluster kernel (csrc/structured_admm_cluster.cu)
with the copy's ``kLayouts`` line reduced to one layout CS,chip or CS,mem
(blocks a lane, the rows of [A_s; A_d] in the cluster's shared memory or
read from device memory; none named: 2, 4 and 8 blocks each way) at the fov
teams of 96, 128 and 256 agents on 96, 256 and 256 lanes (the lanes of one
launch of benchmarks/swarm.py's step: one ring of 96, a lane chunk of 256;
550 + 50 + 150 + 50) and the connectivity teams of 128 and 256 robots on
128 and 256 lanes (one run_sim team; 150 + 50 + 150 + 50); a layout that
does not hold a shape is reported as refused. Inputs of the cluster shapes
repeat 8 distinct lanes. A LAYOUT of
the generic kernel is TC,MAXW,REG[,P[,MINB]]: GenericShape<TC, MAXW, REG, P,
MINB> (column slots a lane, warps a block at most, [A_s; A_d] in registers
(true) or read each iteration (false), threads a row of C (default 4),
blocks an SM for the launch bounds (default 1)). --timing-check builds
nothing: it times the package's generic kernel at the sweep's team of 10 on
150 lanes, one 50- and one 150-iteration phase, ten windows of each with the
card spun first (as ``cuda_ms`` does) and ten without, and prints every
window. The package and its build are left as they are.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from mpc_cbf_torch import _build                      # noqa: E402
from mpc_cbf_torch.ops.qp import fused_admm           # noqa: E402

PHASES = (150, 50, 32, 32)
#: what an option times: lanes a launch, (n, m_s, m_d), the step's phases, the using-name
#: in the source, the source, its variant, the variant timed beside it (or None)
Target = collections.namedtuple("Target", "lanes shape phases alias source variant beside")
TILED, FOLDED = "structured_admm_tiled.cu", "structured_admm_folded.cu"
GENERIC, CLUSTER = "structured_admm_generic.cu", "structured_admm_cluster.cu"
RUN_SIM_PHASES = (150, 50, 150, 50)
SWARM_FOV_PHASES = (550, 50, 150, 50)
SHAPES = {"fov": Target(8192, (43, 127, 84), PHASES, "Fov", TILED, "tiled", None),
          "conn": Target(32768, (36, 126, 6), PHASES, "Conn", TILED, "tiled", None),
          "lambda2": Target(32768, (36, 126, 14), PHASES, "ConnLambda2", TILED, "tiled", None),
          "swarm_conn": Target(4096, (36, 126, 62), (50, 50, 50, 50), "SwarmConn", FOLDED, "folded",
                               None),
          "swarm_fov": Target(2048, (67, 151, 372), SWARM_FOV_PHASES, "SwarmFov", FOLDED,
                              "folded", None),
          # --folded-at: the folded kernel at shapes the package gives to the tiled kernel
          "fov_folded": Target(8192, (43, 127, 84), PHASES, "SwarmConn", FOLDED, "folded", "tiled"),
          "lambda2_folded": Target(32768, (36, 126, 14), PHASES, "SwarmConn", FOLDED, "folded",
                                   "tiled"),
          # --generic: both shapes take the RegN64 line of the generic source
          "generic_sweep_r10": Target(150, (45, 135, 18), RUN_SIM_PHASES, "RegN64", GENERIC,
                                      "generic", None),
          "generic_run_sim": Target(3, (38, 128, 4), RUN_SIM_PHASES, "RegN64", GENERIC, "generic",
                                    None),
          # --generic-team24: the RegN64Tall line
          "generic_team24": Target(768, (59, 143, 276), SWARM_FOV_PHASES, "RegN64Tall", GENERIC,
                                   "generic", None),
          # --generic-wide: the FromMemory line
          "generic_team40": Target(768, (75, 159, 468), SWARM_FOV_PHASES, "FromMemory", GENERIC,
                                   "generic", None),
          "generic_team64": Target(768, (99, 183, 756), SWARM_FOV_PHASES, "FromMemory", GENERIC,
                                   "generic", None),
          # --cluster: the kLayouts line
          **{f"cluster_fov{A}": Target(lanes, fused_admm.fov_team_shape(A), SWARM_FOV_PHASES,
                                       "kLayouts", CLUSTER, "cluster", None)
             for A, lanes in ((96, 96), (128, 256), (256, 256))},
          **{f"cluster_conn{R}": Target(R, (35 + R, 125 + R, 2 * R - 2), RUN_SIM_PHASES,
                                        "kLayouts", CLUSTER, "cluster", None)
             for R in (128, 256)}}
GENERIC_TARGETS = {"generic": ("generic_sweep_r10", "generic_run_sim"),
                   "generic_team24": ("generic_team24",),
                   "generic_wide": ("generic_team40", "generic_team64")}
CLUSTER_TARGETS = tuple(name for name in SHAPES if name.startswith("cluster"))
CLUSTER_LAYOUTS = ["2,chip", "4,chip", "8,chip", "2,mem", "4,mem", "8,mem"]
KW = dict(sigma=1e-6, alpha=1.6)


def cuda_ms(fn, reps=3, spin=True):
    """Mean device time of reps runs; the card spins first (torch.cuda._sleep) so
    that the launches are queued before the window opens (spin=False: not)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build(layouts: dict):
    """Compile a copy of csrc/ with each shape's layout; returns (library, ptxas report)."""
    out = ROOT / "build" / "sweep" / "_".join(
        f"{name}{layout}" for name, layout in layouts.items()).replace(",", "-")
    out.mkdir(parents=True, exist_ok=True)
    for src in _build.SOURCES + _build.HEADERS:
        text = src.read_text()
        for name, layout in layouts.items():
            alias = SHAPES[name].alias
            numbers = layout.count(",") + 1           # tiled: 3 (G,L,TPL) or 5 (RG,CG too); folded: 3
            if name.startswith("cluster"):           # one layout: CS,chip or CS,mem
                cs, place = layout.split(",")
                text, n = re.subn(r"constexpr ClusterChoice kLayouts\[\] = \{.*\};",
                                  f"constexpr ClusterChoice kLayouts[] = {{{{{cs}, "
                                  f"{'true' if place == 'chip' else 'false'}}}}};", text)
                n = min(n, 1)                         # every cluster target names the same line
            elif name.startswith("generic"):           # the whole line: another layout
                fields = layout.split(",")
                text, n = re.subn(rf"using {alias} = GenericShape<[^>]*>",
                                  f"using {alias} = GenericShape<{', '.join(fields)}>", text)
            elif name.endswith("_folded"):            # the whole line: another shape
                shape = ", ".join(map(str, SHAPES[name].shape))
                text, n = re.subn(rf"using {alias} = FoldedShape<[^>]*>",
                                  f"using {alias} = FoldedShape<{shape}, {layout}>", text)
            else:
                text, n = re.subn(rf"(using {alias} = \w*Shape<\d+, \d+, \d+)"
                                  + r", \d+" * numbers, rf"\1, {layout}", text)
            if n != (src.name == SHAPES[name].source):
                raise RuntimeError(f"{src.name}: {n} lines name the layout of {alias}")
        (out / src.name).write_text(text)
    lib = out / "kernels.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           *(str(out / src.name) for src in _build.SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}"[-4000:])
    lines = (proc.stdout + proc.stderr).splitlines()
    report = {}                                       # using-name -> ptxas' registers and spills
    for name in layouts:
        n, m_s, m_d = SHAPES[name].shape
        key = f"ShapeILi{n}ELi{m_s}ELi{m_d}E"
        if name.startswith("cluster"):                # cluster_kernel<ROWS>
            key = f"ILb{int(layouts[name].endswith('chip'))}E"
        elif name.startswith("generic"):                # GenericShape<TC, MAXW, REG, P>
            tc, maxw, reg, *rest = (f.strip() for f in layouts[name].split(","))
            p, minb = (rest + ["4", "1"][len(rest):])[:2]
            key = f"GenericShapeILi{tc}ELi{maxw}ELb{int(reg == 'true')}ELi{p}ELi{minb}E"
        at = [i for i, ln in enumerate(lines) if "Compiling entry function" in ln
              and key in ln and f"{SHAPES[name].variant}_kernel" in ln]
        report[name] = " | ".join(ln.strip() for i in at[:1] for ln in lines[i + 1:i + 4]
                                  if "registers" in ln or "spill" in ln)
    return fused_admm.bind(ctypes.CDLL(str(lib))), report


def step_ms(lib, variant, args, phases, reps=3):
    per = {it: cuda_ms(lambda: fused_admm.launch_variant(lib, variant, args, iters=it, **KW), reps)
           for it in sorted(set(phases))}
    return sum(per[it] for it in phases), per


def timing_check(windows=10, reps=3):
    """Windows of the package's generic kernel at the sweep's team of 10 (150
    lanes), with and without the spin before each, interleaved."""
    B, shape = SHAPES["generic_sweep_r10"].lanes, SHAPES["generic_sweep_r10"].shape
    args = [torch.from_numpy(a).cuda()
            for a in fused_admm.random_phase_inputs(np.random.default_rng(1), B, *shape)]
    lib = fused_admm._lib()
    for it in (50, 150):
        got = {True: [], False: []}
        for _ in range(windows):
            for spin in (True, False):
                got[spin].append(cuda_ms(
                    lambda: fused_admm.launch_variant(lib, "generic", args, iters=it, **KW),
                    reps, spin))
        for spin, ms in got.items():
            print(f"timing check, generic {shape} at B={B}, {it} iterations, "
                  f"{'spun' if spin else 'not spun'}: " + ", ".join(f"{v:.4f}" for v in ms)
                  + f" ms (min {min(ms):.4f}, max {max(ms):.4f})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fov", nargs="*", help="default: 1,4,160 1,4,128 2,2,128")
    ap.add_argument("--conn", nargs="*", help="default: 2,4,64 1,8,64 2,4,96")
    ap.add_argument("--lambda2", nargs="*", help="default: 2,4,64,2,12 2,4,64,2,9 2,4,64,7,9")
    ap.add_argument("--swarm-conn", nargs="*",
                    help="T,RG,CG, e.g. 192,24,8 256,32,8 (timed at 4096 lanes, 4 x 50 iterations)")
    ap.add_argument("--swarm-fov", nargs="*",
                    help="T,RG,CG, e.g. 640,80,8 512,64,8 (2048 lanes, 550 + 50 + 150 + 50)")
    ap.add_argument("--folded-at", nargs="+", metavar=("SHAPE", "LAYOUT"),
                    help="fov or lambda2, then T,RG,CG,KC layouts of the folded kernel at that "
                         "shape, e.g. fov 256,32,8,32")
    ap.add_argument("--generic", nargs="*",
                    help="TC,MAXW,REG[,P[,MINB]] layouts of the generic kernel, e.g. "
                         "2,8,true,4,2 2,8,true,8,2 2,8,false,4,2 (timed at the sweep's team of "
                         "10 and run_sim's team)")
    ap.add_argument("--generic-team24", nargs="*",
                    help="TC,MAXW,REG[,P[,MINB]] layouts of the generic kernel at the 24-agent "
                         "fov team, e.g. 2,16,true")
    ap.add_argument("--generic-wide", nargs="*",
                    help="TC,MAXW,REG[,P[,MINB]] layouts of the generic kernel at the fov teams "
                         "of 40 and 64 agents, e.g. 5,8,false 5,16,false")
    ap.add_argument("--cluster", nargs="*",
                    help="CS,chip or CS,mem layouts of the cluster kernel (none named: "
                         + " ".join(CLUSTER_LAYOUTS) + ")")
    ap.add_argument("--timing-check", action="store_true",
                    help="time the package's generic kernel with and without the spin")
    opt = ap.parse_args()
    asked = {name: getattr(opt, name) for name in SHAPES
             if not name.endswith("_folded") and not name.startswith(("generic", "cluster"))
             and getattr(opt, name)}
    if opt.cluster is not None:
        asked.update({name: opt.cluster or CLUSTER_LAYOUTS for name in CLUSTER_TARGETS})
    for option, targets in GENERIC_TARGETS.items():
        held = []              # layouts every target of the option holds: they rewrite one line
        for layout in getattr(opt, option) or ():
            tc, maxw, reg = (f.strip() for f in layout.split(",")[:3])
            short = [name for name in targets if 32 * int(tc) < SHAPES[name].shape[0] or (
                reg == "true" and 32 * int(maxw) < sum(SHAPES[name].shape[1:]))]
            if short:
                print(f"generic layout {layout} does not hold {short}; another line of the "
                      "source would run them, so it is not timed")
            else:
                held.append(layout)
        asked.update({name: held for name in targets if held})
    if opt.folded_at:
        shape, *layouts = opt.folded_at
        if f"{shape}_folded" not in SHAPES or not layouts or opt.swarm_conn:
            sys.exit("admm_kernel_sweep: --folded-at takes fov or lambda2 and at least one "
                     "layout, and not beside --swarm-conn (both rewrite the SwarmConn line)")
        asked[f"{shape}_folded"] = layouts
    if not torch.cuda.is_available():
        sys.exit("admm_kernel_sweep: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if opt.timing_check:
        timing_check()
        if not asked:
            return
    if not asked:           # no option: the three shapes of the 8- and 4-robot steps
        asked = {"fov": ["1,4,160", "1,4,128", "2,2,128"], "conn": ["2,4,64", "1,8,64", "2,4,96"],
                 "lambda2": ["2,4,64,2,12", "2,4,64,2,9", "2,4,64,7,9"]}
    data, ref = {}, {}
    for name in asked:
        B, shape = SHAPES[name].lanes, SHAPES[name].shape
        big = name.startswith("cluster")
        arrays = fused_admm.random_phase_inputs(np.random.default_rng(1), B, *shape,
                                                distinct=8 if big else None)
        data[name] = [torch.from_numpy(a).cuda() for a in arrays]
        keep = 16 if big else 256
        small = [a[:keep].contiguous() if a.shape[0] == B else a for a in data[name]]
        ref[name] = (small, fused_admm.structured_admm_iterations_ref(*small, iters=20, **KW))

    for i in range(max(map(len, asked.values()))):
        layouts = {name: lst[min(i, len(lst) - 1)] for name, lst in asked.items()}
        print("layouts " + ", ".join(f"{name} {layout}" for name, layout in layouts.items()) + ":",
              flush=True)
        try:
            lib, report = build(layouts)
        except RuntimeError as err:                   # a layout the source's static_asserts refuse
            print(f"  not built: {str(err)[-600:]}")
            continue
        if i == 0:
            for name, args in data.items():
                phases, old = SHAPES[name].phases, SHAPES[name].beside
                if old is None:
                    continue
                total, per = step_ms(lib, old, args, phases)
                print(f"{name}: beside it the {old} kernel, control step {total:.3f} ms ("
                      + ", ".join(f"{it}: {ms:.3f}" for it, ms in per.items()) + ")")
        for name, args in data.items():
            phases, variant = SHAPES[name].phases, SHAPES[name].variant
            small, want = ref[name]
            try:
                got = fused_admm.launch_variant(lib, variant, small, iters=20, **KW)
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                total, per = step_ms(lib, variant, args, phases)
            except RuntimeError as err:               # a launch the card refuses (shared memory)
                print(f"  {name}: {err}")
                continue
            print(f"  {name} [{report[name]}]: control step {total:.3f} ms ("
                  + ", ".join(f"{it}: {ms:.3f}" for it, ms in per.items())
                  + f"), max |dev| from the twin {err:.1e}", flush=True)


if __name__ == "__main__":
    main()
