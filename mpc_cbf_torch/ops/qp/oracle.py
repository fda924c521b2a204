"""ctypes bridge to the native C++ QP oracle (counterpart of
``mpc_cbf_tpu/ops/qp/oracle.py``).

The reference's exact solver is CPLEX (``qpcpp/src/solvers/CPLEX.cpp``),
which is proprietary and absent here. ``native/qp_oracle.cpp`` is the
stand-in: a dense Mehrotra predictor-corrector IPM in float64 that solves
the same box-row QPs to ~1e-9, used to measure a solver's control
deviation (target < 1e-3) and as a reference in tests. Host code on numpy
arrays, like its counterpart.

The port never writes into ``native/``: at first use it compiles the
source with ``g++ -O2 -shared -fPIC -std=c++17`` into
``build/oracle/<hash of the source>/`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[3]
SOURCE = _ROOT / "native" / "qp_oracle.cpp"
BUILD_ROOT = _ROOT / "build" / "oracle"
LIB_NAME = "libqp_oracle.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """build/oracle/<hash of the source and flags>/libqp_oracle.so."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the oracle unless it is built already; returns its path."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".{LIB_NAME}.{os.getpid()}"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.qp_solve.restype = ctypes.c_int
    lib.qp_solve.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp, dp, dp]
    lib.qp_solve_batch.restype = ctypes.c_int
    lib.qp_solve_batch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   dp, dp, dp, dp, dp, dp, ip]
    return lib


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a: np.ndarray, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def solve_oracle(P, q, A, lb, ub) -> Tuple[np.ndarray, int, np.ndarray]:
    """Solve one QP exactly. Returns (x [n], status, info [iter, mu, res]).

    status: 0 optimal, 1 max-iter, 2 numerical failure.
    """
    P, q, A, lb, ub = map(_f64, (P, q, A, lb, ub))
    n, m = q.shape[0], lb.shape[0]
    x = np.zeros(n)
    info = np.zeros(3)
    st = _load().qp_solve(n, m, _ptr(P), _ptr(q), _ptr(A), _ptr(lb), _ptr(ub),
                          _ptr(x), _ptr(info))
    return x, int(st), info


def solve_oracle_batch(P, q, A, lb, ub) -> Tuple[np.ndarray, np.ndarray]:
    """Batched exact solve: P [B,n,n], q [B,n], A [B,m,n], lb/ub [B,m].

    Returns (x [B,n], status [B]).
    """
    P, q, A, lb, ub = map(_f64, (P, q, A, lb, ub))
    B, n = q.shape
    m = lb.shape[1]
    x = np.zeros((B, n))
    status = np.zeros(B, dtype=np.int32)
    _load().qp_solve_batch(B, n, m, _ptr(P), _ptr(q), _ptr(A), _ptr(lb), _ptr(ub),
                           _ptr(x), _ptr(status, ctypes.c_int))
    return x, status
