"""Time other block layouts of the tiled structured-ADMM kernel on the card.

    python3 scripts/admm_kernel_sweep.py [--fov G,L,TPL ...] [--conn G,L,TPL ...]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
The package's kernel source carries one layout per shape (groups a block,
lanes a group, threads a lane: the two ``Shape<...>`` lines at the end of
mpc_cbf_torch/csrc/structured_admm_tiled.cu). For each layout asked for,
this script writes a copy of csrc/ with those two lines changed into
build/sweep/<layout>/, compiles it with the package's flags, prints ptxas'
registers and spills of the two instantiations, holds the kernel against
the plain twin on 256 lanes (20 iterations) and times one rho phase of 150,
50 and 32 iterations at 8192 fov lanes and 32768 connectivity lanes (CUDA
events, mean of 3 launches after a warm-up); a control step is 150 + 50 +
32 + 32. The first version of the kernel ("resident") is timed beside them.
The package and its build are left as they are.
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

SHAPES = {"fov": (8192, (43, 127, 84)), "conn": (32768, (36, 126, 6))}
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


def build(fov: str, conn: str):
    """Compile a copy of csrc/ with the two layouts; returns (library, ptxas report)."""
    out = ROOT / "build" / "sweep" / f"fov{fov}_conn{conn}".replace(",", "-")
    out.mkdir(parents=True, exist_ok=True)
    for src in _build.SOURCES + _build.HEADERS:
        text = src.read_text()
        for alias, layout in (("Fov", fov), ("Conn", conn)):
            text, n = re.subn(rf"(using {alias} = Shape<\d+, \d+, \d+), \d+, \d+, \d+,",
                              rf"\1, {layout},", text)
            if n != (src.name == "structured_admm_tiled.cu"):
                raise RuntimeError(f"{src.name}: {n} lines name the layout of {alias}")
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
    opt = ap.parse_args()
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

    for i in range(max(len(opt.fov), len(opt.conn))):
        fov, conn = opt.fov[min(i, len(opt.fov) - 1)], opt.conn[min(i, len(opt.conn) - 1)]
        lib, report = build(fov, conn)
        if i == 0:
            for name, args in data.items():
                total, per = step_ms(lib, "resident", args)
                print(f"{name}: first version (resident), control step {total:.3f} ms ("
                      + ", ".join(f"{it}: {ms:.3f}" for it, ms in per.items()) + ")")
        print(f"layouts fov {fov}, conn {conn}:")
        for line in report[-4:]:                     # the tiled source's two kernels
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
