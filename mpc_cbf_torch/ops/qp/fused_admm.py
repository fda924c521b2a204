"""The structured ADMM iteration loop: the hand-written CUDA kernel and its
plain PyTorch twin (counterpart of ``mpc_cbf_tpu/ops/qp/pallas_admm.py``).

``structured_admm_iterations`` runs one rho phase of the fixed-count loop
of ``StructuredQPOperator._solve`` for a whole batch of lanes. On CUDA
float32 tensors it launches one of the kernels of ``csrc/`` (built at first
use by ``mpc_cbf_torch._build``), chosen from the shape alone (``VARIANTS``):
``tiled`` for the shapes compiled in ``csrc/structured_admm_tiled.cu`` (the
fov and connectivity control steps), ``folded`` for those of
``csrc/structured_admm_folded.cu`` (the 32-agent fov and connectivity
teams: one lane a block, the Woodbury correction S - WK (Ad S) folded into
one float64 matrix a lane, C = (I - WK Ad) Ms_inv), ``generic`` for the
other shapes to n = 160 (``csrc/structured_admm_generic.cu``: the same
folded form for shapes known only at run time, such as the sweep's and
run_sim's connectivity teams and the fov teams of other sizes).
``resident`` and ``streamed``, the first versions of the kernel
(``csrc/structured_admm.cu``), take only the shapes that no layout of
``generic`` holds and that they held before it (n above 160, or thousands
of rows); ``launch_variant`` also runs them by name, to time them beside the
kernel that replaced them. A shape no kernel holds (a lane past a block's
shared memory in every kernel) raises. On CPU tensors it runs the twin
``structured_admm_iterations_ref``, which is the scan body of
``mpc_cbf_tpu/ops/qp/structured.py:442-463`` as a Python loop. Any other
CUDA input raises: there is no silent fallback.

Inputs are batch-first and already scaled (as ``_solve`` makes them):
  qb, x0 [B, n]; lbs, ubs, zs0, ys0 [B, m_s]; Ad [B, m_d, n]; lbd, ubd,
  rho_d, zd0, yd0 [B, m_d]; WK [B, n, m_d] (the folded Woodbury correction
  Ms_inv Ad' (R^-1 + Ad Ms_inv Ad')^-1); shared Ms_inv [n, n],
  A_sb [m_s, n], rho_s [m_s].
Both return (x [B, n], zs, zd, ys, yd): the full iteration state, so the
next rho phase resumes where this one stopped.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from mpc_cbf_torch import _build

Tensor = torch.Tensor
#: kernel variants, indexed by the code ``structured_admm_variant`` returns
#: (``AdmmVariant`` in csrc/structured_admm.cuh; -1: no kernel holds the shape)
VARIANTS = ("tiled", "resident", "streamed", "folded", "generic")
State5 = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]


def structured_admm_iterations_ref(
    Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
    x0, zs0, zd0, ys0, yd0, *, iters: int, sigma: float, alpha: float,
) -> State5:
    """Plain PyTorch twin of the kernel: same update order, same
    over-relaxation, batched einsums per iteration.

    One deliberate difference from the JAX scan body: the two Woodbury
    products Ms_inv RHS and WK t, and S - WK t, accumulate in float64 (a
    no-op for float64 inputs). S and WK t nearly cancel, and on the H100
    the fov flagship's usable-lane rate at 8192 lanes measured 0.663 with
    these products in float32, 0.7095 with them in float64, and 0.710 with
    the whole loop in float64; the kernel accumulates them the same way."""
    dt, hi = qb.dtype, torch.float64
    Ms_inv_hi, WK_hi = Ms_inv.to(hi), WK.to(hi)
    x, zs, zd, ys, yd = x0, zs0, zd0, ys0, yd0
    for _ in range(iters):
        # rhs = sigma x - q + As'(rho_s zs - ys) + Ad'(rho_d zd - yd)
        rs = rho_s * zs - ys                                     # [B, m_s]
        rd = rho_d * zd - yd                                     # [B, m_d]
        RHS = sigma * x - qb + rs @ A_sb + torch.einsum("bdj,bd->bj", Ad, rd)
        # Woodbury solve: shared Ms_inv, minus the folded per-lane correction
        S = (RHS.to(hi) @ Ms_inv_hi.T).to(dt)                    # [B, n]
        t = torch.einsum("bdj,bj->bd", Ad, S)                    # [B, m_d]
        xt = (S.to(hi) - torch.einsum("bie,be->bi", WK_hi, t.to(hi))).to(dt)
        zAs = xt @ A_sb.T                                        # [B, m_s]
        zAd = torch.einsum("bdj,bj->bd", Ad, xt)                 # [B, m_d]
        x_new = alpha * xt + (1 - alpha) * x
        zs_h = alpha * zAs + (1 - alpha) * zs + ys / rho_s
        zd_h = alpha * zAd + (1 - alpha) * zd + yd / rho_d
        zs_new = torch.clamp(zs_h, lbs, ubs)
        zd_new = torch.clamp(zd_h, lbd, ubd)
        ys = ys + rho_s * (alpha * zAs + (1 - alpha) * zs - zs_new)
        yd = yd + rho_d * (alpha * zAd + (1 - alpha) * zd - zd_new)
        x, zs, zd = x_new, zs_new, zd_new
    return x, zs, zd, ys, yd


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a kernel library (csrc/structured_admm.cu)."""
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.structured_admm_launch.argtypes = (
        [ptr] * 21 + [c_int] * 5 + [c_float, c_float, c_int, ptr, c_int])
    lib.structured_admm_launch.restype = c_int
    lib.structured_admm_variant.argtypes = [c_int] * 3
    lib.structured_admm_variant.restype = c_int
    lib.structured_admm_error_string.argtypes = [c_int]
    lib.structured_admm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load())


def launch_variant(lib: ctypes.CDLL, variant: str, args, *, iters: int, sigma: float,
                   alpha: float) -> State5:
    """Launch the kernel ``variant`` (a name from ``VARIANTS``) of ``lib`` on
    ``args`` (the sixteen tensors of ``structured_admm_iterations``: CUDA,
    float32, contiguous, of matching shapes; not checked here) and return
    the new state. It counts nothing. The package calls it from
    ``structured_admm_iterations`` alone, with the kernel of the shape;
    tests and measurements call it to hold one kernel against another on
    a shape that would take a different one."""
    qb, A_sb, Ad = args[3], args[1], args[6]
    (B, n), m_s, m_d = qb.shape, A_sb.shape[0], Ad.shape[1]
    outs = tuple(torch.empty((B, k), dtype=torch.float32, device=qb.device)
                 for k in (n, m_s, m_d, m_s, m_d))
    err = lib.structured_admm_launch(
        *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
        B, n, m_s, m_d, int(iters), float(sigma), float(alpha),
        qb.device.index, torch.cuda.current_stream(qb.device).cuda_stream,
        VARIANTS.index(variant))
    if err != 0:
        raise RuntimeError(f"structured_admm kernel ({variant}) launch failed: "
                           + lib.structured_admm_error_string(err).decode())
    return outs


def structured_admm_iterations(
    Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
    x0, zs0, zd0, ys0, yd0, *, iters: int, sigma: float, alpha: float,
) -> State5:
    """Run one rho phase of the loop: the CUDA kernel of the shape for CUDA
    float32 tensors, the plain twin for CPU tensors. Shapes in the module
    docstring. ``structured_admm_iterations.launches`` counts kernel
    launches and ``.launches_by_variant`` counts them per kernel."""
    args = (Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
            x0, zs0, zd0, ys0, yd0)
    if qb.device.type == "cpu":
        return structured_admm_iterations_ref(*args, iters=iters, sigma=sigma, alpha=alpha)
    if qb.device.type != "cuda":
        raise ValueError(f"structured_admm_iterations: no kernel for {qb.device}")

    B, n = qb.shape
    m_s, m_d = A_sb.shape[0], Ad.shape[1]
    shapes = {
        "Ms_inv": (n, n), "A_sb": (m_s, n), "rho_s": (m_s,), "qb": (B, n),
        "lbs": (B, m_s), "ubs": (B, m_s), "Ad": (B, m_d, n), "lbd": (B, m_d),
        "ubd": (B, m_d), "rho_d": (B, m_d), "WK": (B, n, m_d), "x0": (B, n),
        "zs0": (B, m_s), "zd0": (B, m_d), "ys0": (B, m_s), "yd0": (B, m_d),
    }
    for (name, shape), a in zip(shapes.items(), args):
        if a.device != qb.device or a.dtype != torch.float32:
            raise ValueError(f"structured_admm_iterations: {name} is {a.dtype} on "
                             f"{a.device}; the kernel takes float32 on {qb.device}")
        if tuple(a.shape) != shape:
            raise ValueError(f"structured_admm_iterations: {name} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"structured_admm_iterations: {name} is not contiguous")
    if B == 0:
        return tuple(torch.empty((0, k), dtype=torch.float32, device=qb.device)
                     for k in (n, m_s, m_d, m_s, m_d))
    lib = _lib()
    code = lib.structured_admm_variant(n, m_s, m_d)
    if code < 0:
        raise ValueError(f"structured_admm_iterations: no kernel holds the shape (n={n}, "
                         f"m_s={m_s}, m_d={m_d}): a lane's operands exceed a block's "
                         "shared memory")
    variant = VARIANTS[code]
    outs = launch_variant(lib, variant, args, iters=iters, sigma=sigma, alpha=alpha)
    structured_admm_iterations.launches += 1
    structured_admm_iterations.launches_by_variant[variant] += 1
    return outs


structured_admm_iterations.launches = 0
structured_admm_iterations.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def random_phase_inputs(rng: np.random.Generator, B: int, n: int, m_s: int, m_d: int,
                        inactive_frac: float = 0.25):
    """Seeded, well-posed inputs for one rho phase, made the way ``_solve``
    makes them: an SPD shared system M_s and its f64 inverse, per-lane
    dynamic rows with some inactive (rho_d = 1e-12, bounds +-1e20), the
    folded Woodbury WK, and a clipped initial state. Returns float32 numpy
    arrays in the argument order of ``structured_admm_iterations``.
    Used to hold the kernel against its twin."""
    A_s = rng.normal(size=(m_s, n)) / np.sqrt(n)
    G = rng.normal(size=(n, n)) / np.sqrt(n)
    # well-conditioned (cond(M_s) ~ 10), so that 40 float32 iterations stay
    # within 1e-5 of float64 ones and two f32 loops can be held to 2e-4
    P = 0.5 * np.eye(n) + 0.1 * G @ G.T
    eq = rng.random(m_s) < 0.1
    rho_s = np.where(eq, 1.0, 0.1)
    Ms_inv = np.linalg.inv(P + 1e-6 * np.eye(n) + (A_s.T * rho_s) @ A_s)

    Ad = rng.normal(size=(B, m_d, n)) / np.sqrt(n)
    inactive = rng.random((B, m_d)) < inactive_frac
    rho_d = np.where(inactive, 1e-12, 0.1)
    # matmul, not einsum: BLAS makes the 32-agent shapes a second, not a minute
    W = Ms_inv @ Ad.transpose(0, 2, 1)                  # [B, n, m_d]
    sr = np.sqrt(rho_d)
    Cp = np.eye(m_d) + sr[:, :, None] * (Ad @ W) * sr[:, None, :]
    K = sr[:, :, None] * np.linalg.inv(Cp) * sr[:, None, :]
    WK = W @ K

    qb = rng.normal(size=(B, n))
    ubs = rng.uniform(0.2, 2.0, (B, m_s))
    lbs = np.where(eq, ubs, -rng.uniform(0.2, 2.0, (B, m_s)))
    lbd = np.where(inactive, -1e20, -rng.uniform(0.2, 2.0, (B, m_d)))
    ubd = np.where(inactive, 1e20, rng.uniform(0.0, 1.0, (B, m_d)))
    x0 = rng.normal(0.0, 0.1, (B, n))
    zs0 = np.clip(x0 @ A_s.T, lbs, ubs)
    zd0 = np.clip(np.einsum("bdj,bj->bd", Ad, x0), lbd, ubd)
    ys0 = rng.normal(0.0, 0.1, (B, m_s))
    yd0 = np.where(inactive, 0.0, rng.normal(0.0, 0.1, (B, m_d)))
    arrays = (Ms_inv, A_s, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
              x0, zs0, zd0, ys0, yd0)
    return tuple(np.ascontiguousarray(a, np.float32) for a in arrays)
