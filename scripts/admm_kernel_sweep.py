"""Time other block layouts of the structured-ADMM kernels on the card.

    python3 scripts/admm_kernel_sweep.py [--conn LAYOUT ...] [--lambda2 LAYOUT ...]
                                         [--swarm-conn LAYOUT ...] [--swarm-fov LAYOUT ...]
                                         [--folded-at fov|conn|lambda2 LAYOUT ...]
                                         [--generic LAYOUT ...] [--generic-team24 LAYOUT ...]
                                         [--cluster [LAYOUT ...]] [--cluster-at TARGET ...]
                                         [--reg-shapes NW,RW,TC[,true] ...] [--stream [NW ...]]
                                         [--stage-clocks [SHAPE ...]] [--timing-check]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
The package's kernel sources carry one layout per shape: the ``TcShape<...>``
lines at the end of mpc_cbf_torch/csrc/structured_admm_tiled.cu
(connectivity, connectivity with the λ₂/CLF rows) and the ``FoldedShape<...>``
lines at the end of csrc/structured_admm_folded.cu (32-agent fov, 32-agent
connectivity, the fov flagship). A LAYOUT of the tiled kernel (--conn,
--lambda2: its tensor-core loop) is L,RP,RG,CG (lanes a block, row parts a
lane group of 16, the grid of register tiles A_d is cut into); one of the
folded kernel is T,RG,CG,P (threads a block, the grid of register tiles
[A_s; A_d] is cut into, threads a row of C). Every kernel gets the operand
it takes (random_phase_inputs: WK for tiled, the float64 C for the others)
of the same draw, and is held to the twin of that form. Only the shapes
named by an option are built and timed; with no option, the connectivity
and λ₂ shapes with their defaults. The i-th layout of every shape is built
together (a shorter list repeats its last): this script writes a copy of
csrc/ with those lines changed into build/sweep/<layouts>/, compiles it with
the package's flags, prints ptxas' registers and spills of the
instantiations, holds the kernel against the plain twin on 256 lanes (20
iterations) and times one rho phase of each length of a control step at the
lanes a launch gets there (CUDA events, mean of 3 launches after a warm-up):
150 + 50 + 32 + 32 iterations at 32768 connectivity lanes, 4 x 50 at the
4096 lanes of the 32-agent connectivity step, 550 + 50 + 150 + 50 at the
4096 lanes of the 32-agent fov step (one lane chunk).
--folded-at times the folded kernel at the fov flagship's, the
connectivity or the λ₂/CLF connectivity shape (fov: the copy's ``Flagship``
line of the folded source, changed; conn or lambda2: a ``FoldedShape`` line
and its launch inserted into the copy, as the package compiles no folded
instance at a shape that takes tiled) with the layouts T,RG,CG,P, launched
by name beside the tiled kernel (at the fov flagship, which tiled does not
hold, beside nothing) at 8192 and 32768 lanes, 150 + 50 + 32 + 32
iterations. --generic times the generic
kernel (csrc/structured_admm_generic.cu) at the sweep's team of 10 (45, 135,
18) on 150 lanes and run_sim's 3-robot team (38, 128, 4) on 3 lanes (150 +
50 + 150 + 50 iterations), with the copy's ``RegN64`` line (the one both
shapes take) changed; --generic-team24 at the 24-agent fov team (59, 143,
276) on 768 lanes (550 + 50 + 150 + 50), with the ``RegN64Tall`` line
changed. --cluster times the cluster kernel (csrc/structured_admm_cluster.cu)
with the copy's ``kLayouts`` line reduced to one layout CS,chip[,NW] or
CS,mem (blocks a lane, the rows of [A_s; A_d] in the registers of NW warps a
block (default 16) or streamed from device memory; CS = 1: the lane on one
SM, no cluster; none named: 1 block of 8 warps, 2, 4 and 8 in registers of
16 warps, 2, 4 and 8 of 8 warps, 8 streamed) at the fov teams of 40, 64, 96,
128, 256 and 400 agents on 760, 512, 96, 512, 256 and 256 lanes (the lanes
of one launch of benchmarks/swarm.py's step: 19 rings of 40, 8 of 64, one
ring of 96, 4 rings of 128, a lane chunk of 256; 550 + 50 + 150 + 50), the
connectivity teams of 128 and 256 robots on 128 and 256 lanes (one run_sim
team) and conn32's 32 robots on 32768 lanes (1024 teams; 150 + 50 + 150 +
50 for both); a layout that does not hold a shape is reported as refused
(the report names the register layout's instance the shape takes,
RegShape<NW, RW, TC, ONE_SM>).
--cluster-at names the targets timed (none: all). --reg-shapes adds
instances NW,RW,TC[,true] (true: one SM) to the copy's ``RegShapes`` line,
so that a layout the package has no instance for can be timed (16 warps on
one SM at conn32: 16,14,3,true). Inputs of the cluster shapes repeat 8
distinct lanes.
--stream times the streamed layout of the cluster kernel with the copy's
``kStreamWarps`` line reduced to one count NW of warps a block (none named:
8 and 4; at most 8, the kernel's launch bounds) at the fov teams of 256 and
400 agents on 256 lanes (550 + 50 + 150 + 50); a count that does not fit a
block is reported as refused.
--stage-clocks builds a copy of csrc/ with ADMM_STAGE_CLOCKS defined (the
STAGE markers of the cluster, folded and tiled kernels then count clocks;
the package's build leaves them empty) and prints, for one launch of 150
iterations at each SHAPE (none named: cluster_fov128 and cluster_fov64; the
one-SM layout: cluster_conn32; the
folded kernel's: swarm_fov, swarm_conn, fov_folded; the tiled kernel's:
conn, lambda2; on the lanes of one launch of their steps), the clocks
thread 0 of block 0 spent an iteration in each stage of the loop: for
cluster the column sums, the block meeting, barrier 1, RHS, xt = C RHS,
barrier 2, the row sums and updates (on one SM: the column sums, barrier 1,
the meeting and RHS, barrier 2, xt = C RHS, barrier 3, the row sums and
updates); for folded the column sums (with the r
of the rows), barrier 1, RHS, barrier 2, xt = C RHS, barrier 3, the row
sums, barrier 4, the row updates, barrier 5 (a stage the loop does not have
counts 0); for tiled, its tensor-core loop's RHS and S = Ms_inv RHS (thread
0 is in a RHS warp), wait 1, t and xt = S - WK t, the dynamic rows, wait 2,
A_s xt, the shared rows' updates and A_s' r_s, wait 3.
A LAYOUT of the generic kernel is TC,MAXW[,P[,MINB]]: GenericShape<TC, MAXW,
P, MINB> (column slots a lane, warps a block at most, threads a row of C
(default 4), blocks an SM for the launch bounds (default 1)). --timing-check builds
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
SHAPES = {"conn": Target(32768, (36, 126, 6), PHASES, "Conn", TILED, "tiled", None),
          "lambda2": Target(32768, (36, 126, 14), PHASES, "ConnLambda2", TILED, "tiled", None),
          "swarm_conn": Target(4096, (36, 126, 62), (50, 50, 50, 50), "SwarmConn", FOLDED, "folded",
                               None),
          "swarm_fov": Target(4096, (67, 151, 372), SWARM_FOV_PHASES, "SwarmFov", FOLDED,
                              "folded", None),
          # --folded-at: the folded kernel at the fov flagship's shape (its line of the folded
          # source) and at the connectivity shapes (a line inserted), beside the tiled kernel
          "fov_folded": Target(8192, (43, 127, 84), PHASES, "Flagship", FOLDED, "folded", None),
          "conn_folded": Target(32768, (36, 126, 6), PHASES, "Conn", FOLDED, "folded", "tiled"),
          "lambda2_folded": Target(32768, (36, 126, 14), PHASES, "ConnLambda2", FOLDED, "folded",
                                   "tiled"),
          # --generic: both shapes take the RegN64 line of the generic source
          "generic_sweep_r10": Target(150, (45, 135, 18), RUN_SIM_PHASES, "RegN64", GENERIC,
                                      "generic", None),
          "generic_run_sim": Target(3, (38, 128, 4), RUN_SIM_PHASES, "RegN64", GENERIC, "generic",
                                    None),
          # --generic-team24: the RegN64Tall line
          "generic_team24": Target(768, (59, 143, 276), SWARM_FOV_PHASES, "RegN64Tall", GENERIC,
                                   "generic", None),
          # --cluster: the kLayouts line
          **{f"cluster_fov{A}": Target(lanes, fused_admm.fov_team_shape(A), SWARM_FOV_PHASES,
                                       "kLayouts", CLUSTER, "cluster", None)
             for A, lanes in ((40, 760), (64, 512), (96, 96), (128, 512), (256, 256),
                              (400, 256))},
          **{f"cluster_conn{R}": Target(R, (35 + R, 125 + R, 2 * R - 2), RUN_SIM_PHASES,
                                        "kLayouts", CLUSTER, "cluster", None)
             for R in (128, 256)},
          # conn32.fleet's launch: 1024 teams of 32 robots
          "cluster_conn32": Target(32768, (67, 157, 62), RUN_SIM_PHASES, "kLayouts", CLUSTER,
                                   "cluster", None),
          # --stream: the kStreamWarps line
          **{f"stream_fov{A}": Target(256, fused_admm.fov_team_shape(A), SWARM_FOV_PHASES,
                                      "kStreamWarps", CLUSTER, "cluster", None)
             for A in (256, 400)}}
GENERIC_TARGETS = {"generic": ("generic_sweep_r10", "generic_run_sim"),
                   "generic_team24": ("generic_team24",)}
CLUSTER_TARGETS = tuple(name for name in SHAPES if name.startswith("cluster"))
CLUSTER_LAYOUTS = ["1,chip,8", "2,chip", "4,chip", "8,chip", "2,chip,8", "4,chip,8", "8,chip,8",
                   "8,mem"]
STREAM_TARGETS = tuple(name for name in SHAPES if name.startswith("stream"))
STREAM_LAYOUTS = ["8", "4"]
STAGE_TARGETS = ["cluster_fov128", "cluster_fov64"]
FOLDED_STAGE_TARGETS = ["swarm_fov", "swarm_conn", "fov_folded"]
TILED_STAGE_TARGETS = ["conn", "lambda2"]
#: the stages of an iteration, by kernel; the reader of its clocks
STAGES = {"cluster": ("column sums", "block meeting", "barrier 1", "RHS", "xt = C RHS",
                      "barrier 2", "row sums and updates"),
          "cluster cs=1": ("column sums", "barrier 1", "meeting and RHS", "barrier 2",
                           "xt = C RHS", "barrier 3", "row sums and updates"),
          "folded": ("column sums", "barrier 1", "RHS", "barrier 2", "xt = C RHS", "barrier 3",
                     "row sums", "barrier 4", "row updates", "barrier 5"),
          "tiled": ("RHS and S = Ms_inv RHS", "wait 1", "t and xt = S - WK t", "dynamic rows",
                    "wait 2", "A_s xt", "shared row updates and A_s' r_s", "wait 3")}
STAGE_READERS = {"cluster": "structured_admm_stage_clocks",
                 "folded": "structured_admm_folded_stage_clocks",
                 "tiled": "structured_admm_tiled_stage_clocks"}
STAGE_SLOTS = 10                                      # kStageSlots of csrc/structured_admm.cuh
KW = dict(sigma=1e-6, alpha=1.6)
#: the tensor-core loop's layout timed by default: the shipped one
TILED_DEFAULTS = ["32,8,2,8"]


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


def build(layouts: dict, defines=(), reg_shapes=()):
    """Compile a copy of csrc/ with each shape's layout, the register layout's instances
    ``reg_shapes`` (NW,RW,TC[,true]) added and the macros ``defines``; returns (library, ptxas
    report)."""
    out = ROOT / "build" / "sweep" / ("_".join(
        f"{name}{layout}" for name, layout in layouts.items()).replace(",", "-")
        + "".join(f"_r{s.replace(',', '-')}" for s in reg_shapes)
        + "".join(f"_{d}" for d in defines))
    out.mkdir(parents=True, exist_ok=True)
    for src in _build.SOURCES + _build.HEADERS:
        text = src.read_text()
        if src.name == CLUSTER and reg_shapes:
            text, n = re.subn(r"(using RegShapes = ShapeList<)", r"\g<1>" + "".join(
                f"RegShape<{s.replace(',', ', ')}>, " for s in reg_shapes), text)
            if n != 1:
                raise RuntimeError(f"{src.name}: {n} RegShapes lines")
        for name, layout in layouts.items():
            if src.name != SHAPES[name].source:      # an alias may name a line of another source
                continue
            alias = SHAPES[name].alias
            # the numbers replaced after the shape: tiled's L,RP,RG,CG
            numbers = layout.count(",") + 1
            if name.startswith("stream"):            # one count of warps
                text, n = re.subn(r"constexpr int kStreamWarps\[\] = \{[^;]*\};",
                                  f"constexpr int kStreamWarps[] = {{{layout}}};", text)
                n = min(n, 1)                         # every stream target names the same line
            elif name.startswith("cluster"):         # one layout: CS,chip[,NW] or CS,mem
                cs, place, *nw = layout.split(",")
                chip = place == "chip"
                text, n = re.subn(r"constexpr ClusterChoice kLayouts\[\] = \{.*?\};",
                                  f"constexpr ClusterChoice kLayouts[] = {{{{{cs}, "
                                  f"{'true' if chip else 'false'}, "
                                  f"{(nw or ['16'])[0] if chip else '0'}}}}};", text, flags=re.S)
                n = min(n, 1)                         # every cluster target names the same line
            elif name.startswith("generic"):           # the whole line: another layout
                fields = layout.split(",")
                text, n = re.subn(rf"using {alias} = GenericShape<[^>]*>",
                                  f"using {alias} = GenericShape<{', '.join(fields)}>", text)
            elif name.endswith("_folded"):            # the whole line: another shape
                text, n = folded_instance(text, alias, SHAPES[name].shape, layout)
            else:
                text, n = re.subn(rf"(using {alias} = \w*Shape<\d+, \d+, \d+)"
                                  + r", \d+" * numbers, rf"\1, {layout}", text)
            if n != 1:
                raise RuntimeError(f"{src.name}: {n} lines name the layout of {alias}")
        (out / src.name).write_text(text)
    lib = out / "kernels.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared", "-o",
           str(lib),
           *(str(out / src.name) for src in _build.SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}"[-4000:])
    lines = (proc.stdout + proc.stderr).splitlines()
    report = {}                                       # using-name -> ptxas' registers and spills
    for name in layouts:
        n, m_s, m_d = SHAPES[name].shape
        key, kernel = f"ShapeILi{n}ELi{m_s}ELi{m_d}E", f"{SHAPES[name].variant}_kernel"
        if name.startswith("stream"):
            key = kernel = "stream_kernel"
        elif name.startswith("cluster"):              # an instance of reg_kernel, or stream_kernel
            cs, place, *nw = layouts[name].split(",")
            key = kernel = "stream_kernel"
            if place == "chip":
                inst = reg_instance((out / CLUSTER).read_text(), SHAPES[name].shape, int(cs),
                                    int((nw or [16])[0]))
                key, kernel = "reg_kernel", "reg_kernelILi%dELi%dELi%dELb%dE" % (
                    inst or (0, 0, 0, 0))
        elif name.startswith("generic"):                # GenericShape<TC, MAXW, P, MINB>
            tc, maxw, *rest = (f.strip() for f in layouts[name].split(","))
            p, minb = (rest + ["4", "1"][len(rest):])[:2]
            key = f"GenericShapeILi{tc}ELi{maxw}ELi{p}ELi{minb}E"
        at = [i for i, ln in enumerate(lines) if "Compiling entry function" in ln
              and key in ln and kernel in ln]
        report[name] = " | ".join(ln.strip() for i in at[:1] for ln in lines[i + 1:i + 4]
                                  if "registers" in ln or "spill" in ln)
    return fused_admm.bind(ctypes.CDLL(str(lib))), report


def folded_instance(text, alias, shape, layout):
    """(text, lines changed): the folded source ``text`` with the instance ``alias`` of the
    shape at the layout T,RG,CG,P: its ``FoldedShape`` line changed where the source has one,
    else the line inserted before the instances' lookup and its launch by name added to
    structured_admm_folded_launch (not to _has: the shape keeps the kernel it takes)."""
    line = f"using {alias} = FoldedShape<{', '.join(map(str, shape))}, {layout}>"
    text, n = re.subn(rf"using {alias} = FoldedShape<[^>]*>", line, text)
    if n:
        return text, n
    lookup = "\ntemplate <class S>\nbool is_shape"
    head = "int structured_admm_folded_launch(const AdmmArgs& a, cudaStream_t stream) {\n"
    if text.count(lookup) != 1 or text.count(head) != 1:
        return text, 0
    branch = f"  if (is_shape<{alias}>(a.n, a.m_s, a.m_d)) return launch<{alias}>(a, stream);\n"
    return text.replace(lookup, f"\n{line};{lookup}").replace(head, head + branch), 1


def reg_instance(text, shape, cs, nw):
    """(NW, RW, TC, ONE_SM) of the first RegShape of the source ``text`` that holds the
    shape with cs blocks of nw warps (the kernel's reg_instance; cs = 1 takes the
    ONE_SM instances, else the others), or None."""
    start = text.index("using RegShapes")
    n, m = shape[0], shape[1] + shape[2]
    cdiv = lambda a, b: -(-a // b)
    for NW, RW, TC, one_sm in ((int(a), int(b), int(c), d == "true") for a, b, c, d in re.findall(
            r"RegShape<(\d+), (\d+), (\d+)(?:, (true|false))?>",
            text[start:text.index(";", start)])):
        if NW == nw and one_sm == (cs == 1) and cdiv(n, 32) <= TC and cdiv(cdiv(m, cs), nw) <= RW:
            return NW, RW, TC, one_sm
    return None


def step_ms(lib, variant, args, phases, reps=3):
    per = {it: cuda_ms(lambda: fused_admm.launch_variant(lib, variant, args, iters=it, **KW), reps)
           for it in sorted(set(phases))}
    return sum(per[it] for it in phases), per


def stage_clocks(names, iters=150):
    """Clocks an iteration of each stage of the loop of the cluster, folded or tiled kernel (thread
    0 of block 0, one launch of ``iters`` iterations after a warm-up) at the shapes ``names``."""
    lib, report = build({}, defines=("ADMM_STAGE_CLOCKS",))
    got = np.zeros(STAGE_SLOTS, np.uint64)
    for name in names:
        B, shape, variant = SHAPES[name].lanes, SHAPES[name].shape, SHAPES[name].variant
        read = getattr(lib, STAGE_READERS[variant])
        read.argtypes = [ctypes.c_void_p]
        distinct = 8 if variant == "cluster" else 64 if shape[2] > 300 else None
        args = [torch.from_numpy(a).cuda() for a in fused_admm.random_phase_inputs(
            np.random.default_rng(1), B, *shape, distinct=distinct,
            operand="wk" if variant == "tiled" else "c")]
        for _ in range(2):                            # a warm-up launch, then the one read
            fused_admm.launch_variant(lib, variant, args, iters=iters, **KW)
            torch.cuda.synchronize()
            if read(got.ctypes.data):
                raise RuntimeError("reading the stage clocks failed")
        stages, label = STAGES[variant], variant
        if variant == "cluster":                      # the layout the shape runs in
            cs, nw = ctypes.c_int(), ctypes.c_int()
            lib.structured_admm_cluster_layout(*shape, ctypes.byref(cs), ctypes.byref(nw))
            stages = STAGES["cluster cs=1"] if cs.value == 1 else stages
            label = f"cluster cs={cs.value} nw={nw.value}"
        per = got[:len(stages)].astype(np.float64) / iters
        print(f"stage clocks, {name} {shape} at B={B}, {iters} iterations ({label}): "
              + ", ".join(f"{stage} {c:.0f}" for stage, c in zip(stages, per))
              + f"; an iteration {per.sum():.0f} clocks", flush=True)


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
    ap.add_argument("--conn", nargs="*",
                    help="L,RP,RG,CG; default: " + " ".join(TILED_DEFAULTS))
    ap.add_argument("--lambda2", nargs="*",
                    help="L,RP,RG,CG; default: " + " ".join(TILED_DEFAULTS))
    ap.add_argument("--swarm-conn", nargs="*",
                    help="T,RG,CG,P, e.g. 192,48,4,4 192,24,8,4 (timed at 4096 lanes, 4 x 50 "
                         "iterations)")
    ap.add_argument("--swarm-fov", nargs="*",
                    help="T,RG,CG,P, e.g. 544,136,4,8 640,80,8,8 (4096 lanes, 550 + 50 + 150 + "
                         "50)")
    ap.add_argument("--folded-at", nargs="+", metavar=("SHAPE", "LAYOUT"),
                    help="fov, conn or lambda2, then T,RG,CG,P layouts of the folded kernel at "
                         "that shape, e.g. fov 224,56,4,4 256,32,8,4")
    ap.add_argument("--generic", nargs="*",
                    help="TC,MAXW[,P[,MINB]] layouts of the generic kernel, e.g. 2,8,4,2 "
                         "2,8,8,2 (timed at the sweep's team of 10 and run_sim's team)")
    ap.add_argument("--generic-team24", nargs="*",
                    help="TC,MAXW[,P[,MINB]] layouts of the generic kernel at the 24-agent fov "
                         "team, e.g. 2,16")
    ap.add_argument("--cluster", nargs="*",
                    help="CS,chip[,NW] or CS,mem layouts of the cluster kernel (none named: "
                         + " ".join(CLUSTER_LAYOUTS) + ")")
    ap.add_argument("--cluster-at", nargs="+", choices=CLUSTER_TARGETS,
                    help="the shapes --cluster times (none named: all)")
    ap.add_argument("--reg-shapes", nargs="+", default=(),
                    help="NW,RW,TC[,true] instances of the register layout added to the copy "
                         "(true: one SM), e.g. 16,14,3,true")
    ap.add_argument("--stream", nargs="*",
                    help="warps a block of the cluster kernel's streamed layout (none named: "
                         + " ".join(STREAM_LAYOUTS) + ")")
    ap.add_argument("--stage-clocks", nargs="*", choices=CLUSTER_TARGETS + tuple(
                        FOLDED_STAGE_TARGETS + TILED_STAGE_TARGETS),
                    help="clocks an iteration of each stage of the cluster, folded or tiled "
                         "kernel's loop (none named: " + " ".join(STAGE_TARGETS) + ")")
    ap.add_argument("--timing-check", action="store_true",
                    help="time the package's generic kernel with and without the spin")
    opt = ap.parse_args()
    asked = {name: getattr(opt, name) for name in SHAPES
             if not name.endswith("_folded")
             and not name.startswith(("generic", "cluster", "stream"))
             and getattr(opt, name)}
    if opt.cluster is not None:
        asked.update({name: opt.cluster or CLUSTER_LAYOUTS
                      for name in opt.cluster_at or CLUSTER_TARGETS})
    if opt.stream is not None:
        asked.update({name: opt.stream or STREAM_LAYOUTS for name in STREAM_TARGETS})
    for option, targets in GENERIC_TARGETS.items():
        held = []              # layouts every target of the option holds: they rewrite one line
        for layout in getattr(opt, option) or ():
            tc, maxw = (f.strip() for f in layout.split(",")[:2])
            short = [name for name in targets if 32 * int(tc) < SHAPES[name].shape[0] or
                     32 * int(maxw) < sum(SHAPES[name].shape[1:])]
            if short:
                print(f"generic layout {layout} does not hold {short}; another line of the "
                      "source would run them, so it is not timed")
            else:
                held.append(layout)
        asked.update({name: held for name in targets if held})
    if opt.folded_at:
        shape, *layouts = opt.folded_at
        if f"{shape}_folded" not in SHAPES or not layouts:
            sys.exit("admm_kernel_sweep: --folded-at takes fov, conn or lambda2 and at least one "
                     "layout")
        asked[f"{shape}_folded"] = layouts
    if not torch.cuda.is_available():
        sys.exit("admm_kernel_sweep: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if opt.timing_check:
        timing_check()
    if opt.stage_clocks is not None:
        stage_clocks(opt.stage_clocks or STAGE_TARGETS)
    if (opt.timing_check or opt.stage_clocks is not None) and not asked:
        return
    if not asked:           # no option: the two shapes of the 4-robot steps
        asked = {"conn": TILED_DEFAULTS, "lambda2": TILED_DEFAULTS}
    data, beside, ref = {}, {}, {}
    for name in asked:
        B, shape = SHAPES[name].lanes, SHAPES[name].shape
        big = name.startswith(("cluster", "stream"))

        def arrays(operand):
            return [torch.from_numpy(a).cuda() for a in fused_admm.random_phase_inputs(
                np.random.default_rng(1), B, *shape,
                distinct=8 if big else 64 if shape[2] > 300 else None,
                operand=operand)]
        keep = 16 if big else 256
        short = lambda a: [x[:keep].contiguous() if x.shape[0] == B else x for x in a]
        wk = SHAPES[name].variant == "tiled"
        data[name] = arrays("wk" if wk else "c")
        if SHAPES[name].beside is not None:          # the tiled kernel, on the same draw's WK
            beside[name] = arrays("wk")
        twin = fused_admm.woodbury_iterations_ref if wk else fused_admm.folded_iterations_ref
        ref[name] = (short(data[name]), twin(*short(data[name]), iters=20, **KW))

    for i in range(max(map(len, asked.values()))):
        layouts = {name: lst[min(i, len(lst) - 1)] for name, lst in asked.items()}
        print("layouts " + ", ".join(f"{name} {layout}" for name, layout in layouts.items()) + ":",
              flush=True)
        try:
            lib, report = build(layouts, reg_shapes=opt.reg_shapes)
        except RuntimeError as err:                   # a layout the source's static_asserts refuse
            print(f"  not built: {str(err)[-600:]}")
            continue
        if i == 0:
            for name, args in data.items():
                phases, old = SHAPES[name].phases, SHAPES[name].beside
                if old is None:
                    continue
                total, per = step_ms(lib, old, beside[name], phases)
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
