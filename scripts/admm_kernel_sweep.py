"""Time other block layouts of the compiled-per-shape structured-ADMM kernels
on the card.

    python3 scripts/admm_kernel_sweep.py [--fov LAYOUT ...] [--conn LAYOUT ...]
                                         [--lambda2 LAYOUT ...]
                                         [--swarm-conn LAYOUT ...] [--swarm-fov LAYOUT ...]
                                         [--folded-at fov|lambda2 LAYOUT ...]

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
+ 150 + 50 at one 2048-lane chunk of the 32-agent fov step. The kernel each
replaced (resident; streamed for the 32-agent fov shape) is timed beside
them. --folded-at tries the folded kernel at a shape the package gives to
the tiled kernel (fov or lambda2): the copy's ``SwarmConn`` line of the
folded source becomes that shape with the layouts T,RG,CG,KC, launched by
name beside the tiled kernel of the same copy (so not together with
--swarm-conn, which rewrites the same line). The package and its build are
left as they are.
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
#: in the source, the source, its variant, the variant timed beside it
Target = collections.namedtuple("Target", "lanes shape phases alias source variant beside")
TILED, FOLDED = "structured_admm_tiled.cu", "structured_admm_folded.cu"
SHAPES = {"fov": Target(8192, (43, 127, 84), PHASES, "Fov", TILED, "tiled", "resident"),
          "conn": Target(32768, (36, 126, 6), PHASES, "Conn", TILED, "tiled", "resident"),
          "lambda2": Target(32768, (36, 126, 14), PHASES, "ConnLambda2", TILED, "tiled", "resident"),
          "swarm_conn": Target(4096, (36, 126, 62), (50, 50, 50, 50), "SwarmConn", FOLDED, "folded",
                               "resident"),
          "swarm_fov": Target(2048, (67, 151, 372), (550, 50, 150, 50), "SwarmFov", FOLDED,
                              "folded", "streamed"),
          # --folded-at: the folded kernel at shapes the package gives to the tiled kernel
          "fov_folded": Target(8192, (43, 127, 84), PHASES, "SwarmConn", FOLDED, "folded", "tiled"),
          "lambda2_folded": Target(32768, (36, 126, 14), PHASES, "SwarmConn", FOLDED, "folded",
                                   "tiled")}
KW = dict(sigma=1e-6, alpha=1.6)


def cuda_ms(fn, reps=3):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
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
            if name.endswith("_folded"):              # the whole line: another shape
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
        at = [i for i, ln in enumerate(lines) if "Compiling entry function" in ln
              and f"ShapeILi{n}ELi{m_s}ELi{m_d}E" in ln and f"{SHAPES[name].variant}_kernel" in ln]
        report[name] = " | ".join(ln.strip() for i in at[:1] for ln in lines[i + 1:i + 4]
                                  if "registers" in ln or "spill" in ln)
    return fused_admm.bind(ctypes.CDLL(str(lib))), report


def step_ms(lib, variant, args, phases, reps=3):
    per = {it: cuda_ms(lambda: fused_admm.launch_variant(lib, variant, args, iters=it, **KW), reps)
           for it in sorted(set(phases))}
    return sum(per[it] for it in phases), per


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
    opt = ap.parse_args()
    asked = {name: getattr(opt, name) for name in SHAPES
             if not name.endswith("_folded") and getattr(opt, name)}
    if opt.folded_at:
        shape, *layouts = opt.folded_at
        if f"{shape}_folded" not in SHAPES or not layouts or opt.swarm_conn:
            sys.exit("admm_kernel_sweep: --folded-at takes fov or lambda2 and at least one "
                     "layout, and not beside --swarm-conn (both rewrite the SwarmConn line)")
        asked[f"{shape}_folded"] = layouts
    if not asked:           # no option: the three shapes of the 8- and 4-robot steps
        asked = {"fov": ["1,4,160", "1,4,128", "2,2,128"], "conn": ["2,4,64", "1,8,64", "2,4,96"],
                 "lambda2": ["2,4,64,2,12", "2,4,64,2,9", "2,4,64,7,9"]}
    if not torch.cuda.is_available():
        sys.exit("admm_kernel_sweep: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    data, ref = {}, {}
    for name in asked:
        B, shape = SHAPES[name].lanes, SHAPES[name].shape
        arrays = fused_admm.random_phase_inputs(np.random.default_rng(1), B, *shape)
        data[name] = [torch.from_numpy(a).cuda() for a in arrays]
        small = [a[:256].contiguous() if a.shape[0] == B else a for a in data[name]]
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
                total, per = step_ms(lib, old, args, phases, reps=1 if old == "streamed" else 3)
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
