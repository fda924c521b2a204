"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package (one compiler process
per source, all started together) and links the objects into one shared
library with a plain C interface, which ``load`` opens with ``ctypes``.
The library goes to ``build/kernels/<hash>/`` at the root of the checkout,
keyed by a hash of the sources, the headers and the flags, and is built at
first use: seconds, since no source includes PyTorch's headers.

No ``--use_fast_math``: the ADMM loop divides by rho = 1e-12 on inactive
rows, so division must stay IEEE and denormals must not be flushed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_ROOT = _PKG.parent / "build" / "kernels"
LIB_NAME = "libmpc_cbf_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME (/usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels of mpc_cbf_torch cannot be built")


def build_dir() -> Path:
    """build/kernels/<hash of the sources and flags>."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless it is already built; returns its path.
    The compiler's output (with ptxas' register and shared-memory report)
    is kept beside it in build.log."""
    out = build_dir()
    lib_path = out / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f".{LIB_NAME}.{os.getpid()}"
    objects = [out / f".{src.stem}.{os.getpid()}.o" for src in SOURCES]
    compiles = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objects)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    log, failed = [], None
    for cmd, proc in zip(compiles, procs):      # every compiler is waited for
        text, _ = proc.communicate()
        log.append(f"{' '.join(cmd)}\n# exit {proc.returncode} at "
                   f"{time.perf_counter() - t0:.1f} s\n{text}")
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, text)
    if failed is None:
        link = [nvcc(), "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(f"{' '.join(link)}\n# exit {proc.returncode} at "
                   f"{time.perf_counter() - t0:.1f} s\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed = (proc.returncode, proc.stderr)
    (out / "build.log").write_text("\n".join(log))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed is not None:
        raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n" + failed[1][-4000:])
    os.replace(tmp, lib_path)   # atomic: a concurrent loader sees all or nothing
    return lib_path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (at first use) and open the kernel library."""
    return ctypes.CDLL(str(build()))
