"""Time other block layouts of the tiled structured-ADMM kernel on the card.

    python3 scripts/admm_kernel_sweep.py [--fov LAYOUT ...] [--conn LAYOUT ...]
                                         [--lambda2 LAYOUT ...]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
The package's kernel source carries one layout per shape: the ``Shape<...>``
lines at the end of mpc_cbf_torch/csrc/structured_admm_tiled.cu (fov,
connectivity, connectivity with the λ₂/CLF rows). A LAYOUT is G,L,TPL
(groups a block, lanes a group, threads a lane) or G,L,TPL,RG,CG (also the
grid of register tiles A_d is cut into). The i-th layout of every shape is
built together (a shorter list repeats its last): this script writes a copy
of csrc/ with those lines changed into build/sweep/<layouts>/, compiles it
with the package's flags, prints ptxas' registers and spills of the
instantiations, holds the kernel against the plain twin on 256 lanes (20
iterations) and times one rho phase of 150, 50 and 32 iterations at 8192
fov lanes and 32768 connectivity lanes (CUDA events, mean of 3 launches
after a warm-up); a control step is 150 + 50 + 32 + 32. The first version
of the kernel ("resident") is timed beside them. The package and its build
are left as they are.
"""

from __future__ import annotations

import argparse
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

SHAPES = {"fov": (8192, (43, 127, 84)), "conn": (32768, (36, 126, 6)),
          "lambda2": (32768, (36, 126, 14))}
ALIASES = {"fov": "Fov", "conn": "Conn", "lambda2": "ConnLambda2"}    # the using-names in the source
PHASES = (150, 50, 32, 32)
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
            numbers = layout.count(",") + 1           # 3: G,L,TPL; 5: RG,CG too
            text, n = re.subn(rf"(using {ALIASES[name]} = Shape<\d+, \d+, \d+)" + r", \d+" * numbers,
                              rf"\1, {layout}", text)
            if n != (src.name == "structured_admm_tiled.cu"):
                raise RuntimeError(f"{src.name}: {n} lines name the layout of {ALIASES[name]}")
        (out / src.name).write_text(text)
    lib = out / "kernels.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           *(str(out / src.name) for src in _build.SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}"[-4000:])
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return fused_admm.bind(ctypes.CDLL(str(lib))), report


def step_ms(lib, variant, args):
    per = {it: cuda_ms(lambda: fused_admm.launch_variant(lib, variant, args, iters=it, **KW))
           for it in sorted(set(PHASES))}
    return sum(per[it] for it in PHASES), per


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fov", nargs="*", default=["1,4,160", "1,4,128", "2,2,128"])
    ap.add_argument("--conn", nargs="*", default=["2,4,64", "1,8,64", "2,4,96"])
    ap.add_argument("--lambda2", nargs="*", default=["2,4,64,2,12", "2,4,64,2,9", "2,4,64,7,9"])
    opt = ap.parse_args()
    asked = {name: getattr(opt, name) for name in SHAPES}
    if not torch.cuda.is_available():
        sys.exit("admm_kernel_sweep: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    data, ref = {}, {}
    for name, (B, shape) in SHAPES.items():
        arrays = fused_admm.random_phase_inputs(np.random.default_rng(1), B, *shape)
        data[name] = [torch.from_numpy(a).cuda() for a in arrays]
        small = [a[:256].contiguous() if a.shape[0] == B else a for a in data[name]]
        ref[name] = (small, fused_admm.structured_admm_iterations_ref(*small, iters=20, **KW))

    for i in range(max(map(len, asked.values()))):
        layouts = {name: lst[min(i, len(lst) - 1)] for name, lst in asked.items()}
        lib, report = build(layouts)
        if i == 0:
            for name, args in data.items():
                total, per = step_ms(lib, "resident", args)
                print(f"{name}: first version (resident), control step {total:.3f} ms ("
                      + ", ".join(f"{it}: {ms:.3f}" for it, ms in per.items()) + ")")
        print("layouts " + ", ".join(f"{name} {layout}" for name, layout in layouts.items()) + ":")
        for line in report[-2 * len(SHAPES):]:       # the tiled source's kernels
            print(f"    {line}")
        for name, args in data.items():
            small, want = ref[name]
            got = fused_admm.launch_variant(lib, "tiled", small, iters=20, **KW)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            total, per = step_ms(lib, "tiled", args)
            print(f"  {name}: control step {total:.3f} ms ("
                  + ", ".join(f"{it}: {ms:.3f}" for it, ms in per.items())
                  + f"), max |dev| from the twin {err:.1e}")


if __name__ == "__main__":
    main()
