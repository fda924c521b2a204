"""The structured ADMM iteration loop: the hand-written CUDA kernel and its
plain PyTorch twin (counterpart of ``mpc_cbf_tpu/ops/qp/pallas_admm.py``).

``structured_admm_iterations`` runs one rho phase of the fixed-count loop
of ``StructuredQPOperator._solve`` for a whole batch of lanes. On CUDA
float32 tensors it launches one of the kernels of ``csrc/`` (built at first
use by ``mpc_cbf_torch._build``), chosen from the shape alone (``VARIANTS``):
``tiled`` for the shapes of ``TILED_SHAPES`` in
``csrc/structured_admm_tiled.cu`` (the connectivity control steps: 32 lanes
a block, the shared A_s products on the TF32 tensor cores in 3xTF32),
``folded`` for those of ``csrc/structured_admm_folded.cu`` (the fov
flagship and the 32-agent fov and connectivity teams: one lane a block),
``generic`` for the other shapes
whose lane fits one block (``csrc/structured_admm_generic.cu``: shapes known
only at run time, such as the sweep's and run_sim's connectivity teams and
the small fov teams), and ``cluster`` for the larger lanes
(``csrc/structured_admm_cluster.cu``: one lane a thread-block cluster whose
blocks push their sums into each other's shared memory; the rows of [A_s;
A_d] in the blocks' registers where they fit, else streamed from device
memory once an iteration).
``launch_variant`` runs a kernel by name, to time or check it at a shape
that takes another. On CPU tensors it runs the twin
``structured_admm_iterations_ref``, which is the scan body of
``mpc_cbf_tpu/ops/qp/structured.py:442-463`` as a Python loop. Any other
CUDA input raises: there is no silent fallback.

The x-update xt = M_b^-1 RHS of a lane, M_b = M_s + Ad' diag(rho_d) Ad,
comes in one of two forms, decided by the shape alone (``takes_wk``):
- at ``TILED_SHAPES``, the JAX package's Woodbury form xt = S - WK (Ad S),
  S = Ms_inv RHS, with the folded correction WK [B, n, m_d];
- at every other shape, xt = C RHS with the lane's float64 C = M_b^-1
  [B, n, n], which ``StructuredQPOperator.folded_c`` factors on the device.

Inputs are batch-first and already scaled (as ``_solve`` makes them):
  qb, x0 [B, n]; lbs, ubs, zs0, ys0 [B, m_s]; Ad [B, m_d, n]; lbd, ubd,
  rho_d, zd0, yd0 [B, m_d]; W, the shape's operand (WK, or C in float64);
  shared Ms_inv [n, n] (read by the Woodbury form only), A_sb [m_s, n],
  rho_s [m_s].
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
VARIANTS = ("tiled", "folded", "generic", "cluster")
#: (n, m_s, m_d) of the shapes that take the tiled kernel of
#: csrc/structured_admm_tiled.cu: connectivity, and connectivity with the
#: λ₂/CLF rows. Their loop takes WK; every other shape takes C (the fov
#: flagship too, whose tiled instance runs by name only).
TILED_SHAPES = ((36, 126, 6), (36, 126, 14))
State5 = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]


def takes_wk(n: int, m_s: int, m_d: int) -> bool:
    """Whether the loop of a shape takes the Woodbury correction WK (the
    tiled kernel's shapes) rather than the folded float64 C."""
    return (n, m_s, m_d) in TILED_SHAPES


def _loop(xupdate, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, x0, zs0, zd0, ys0, yd0,
          iters, sigma, alpha) -> State5:
    """The fixed-count loop with the x-update ``xupdate(RHS) -> xt``."""
    x, zs, zd, ys, yd = x0, zs0, zd0, ys0, yd0
    for _ in range(iters):
        # rhs = sigma x - q + As'(rho_s zs - ys) + Ad'(rho_d zd - yd)
        rs = rho_s * zs - ys                                     # [B, m_s]
        rd = rho_d * zd - yd                                     # [B, m_d]
        RHS = sigma * x - qb + rs @ A_sb + torch.einsum("bdj,bd->bj", Ad, rd)
        xt = xupdate(RHS)
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


def folded_iterations_ref(
    Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, C,
    x0, zs0, zd0, ys0, yd0, *, iters: int, sigma: float, alpha: float,
) -> State5:
    """The twin's loop in the C form at any shape: xt = C RHS in float64 with
    the lane's C [B, n, n] (``Ms_inv`` is not read). The twin of every shape
    outside ``TILED_SHAPES``; tests and measurements also hold a C-form kernel
    launched by name at a tiled shape against it."""
    dt, hi = qb.dtype, torch.float64
    C = C.to(hi)
    return _loop(lambda RHS: torch.einsum("bij,bj->bi", C, RHS.to(hi)).to(dt),
                 A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, x0, zs0, zd0, ys0, yd0,
                 iters, sigma, alpha)


def woodbury_iterations_ref(
    Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
    x0, zs0, zd0, ys0, yd0, *, iters: int, sigma: float, alpha: float,
) -> State5:
    """The twin's loop in the Woodbury form at any shape: xt = S - WK (Ad S),
    S = Ms_inv RHS, the products and the difference in float64. The twin of
    ``TILED_SHAPES``; tests and measurements also hold the tiled kernel
    launched by name at another shape against it."""
    dt, hi = qb.dtype, torch.float64
    Ms_inv_hi, WK_hi = Ms_inv.to(hi), WK.to(hi)

    def woodbury(RHS):           # shared Ms_inv, minus the folded per-lane correction
        S = (RHS.to(hi) @ Ms_inv_hi.T).to(dt)                    # [B, n]
        t = torch.einsum("bdj,bj->bd", Ad, S)                    # [B, m_d]
        return (S.to(hi) - torch.einsum("bie,be->bi", WK_hi, t.to(hi))).to(dt)
    return _loop(woodbury, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, x0, zs0, zd0, ys0,
                 yd0, iters, sigma, alpha)


def structured_admm_iterations_ref(
    Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, W,
    x0, zs0, zd0, ys0, yd0, *, iters: int, sigma: float, alpha: float,
) -> State5:
    """Plain PyTorch twin of the kernel: same update order, same
    over-relaxation, batched einsums per iteration. ``W`` is the shape's
    operand: WK at ``TILED_SHAPES`` (``woodbury_iterations_ref``), C
    elsewhere (``folded_iterations_ref``).

    One deliberate difference from the JAX scan body: the x-update
    accumulates in float64 (a no-op for float64 inputs). In the Woodbury
    form the two products Ms_inv RHS and WK t, and S - WK t, are float64: S
    and WK t nearly cancel, and on the H100 the fov flagship's usable-lane
    rate at 8192 lanes measured 0.663 with them in float32, 0.7095 in
    float64, and 0.710 with the whole loop in float64. The C form is one
    float64 product C RHS, which skips the float32 rounding of S and Ad S
    altogether. The kernels accumulate the same way."""
    wk = takes_wk(qb.shape[1], A_sb.shape[0], Ad.shape[1])
    loop = woodbury_iterations_ref if wk else folded_iterations_ref
    return loop(Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, W, x0, zs0, zd0, ys0, yd0,
                iters=iters, sigma=sigma, alpha=alpha)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a kernel library (csrc/structured_admm.cu)."""
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.structured_admm_launch.argtypes = (
        [ptr] * 22 + [c_int] * 5 + [c_float, c_float, c_int, ptr, c_int])
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
    contiguous, of matching shapes, float32 but for C; not checked here, but
    for the operand: WK for ``tiled``, the float64 C for the others) and
    return the new state. It counts nothing. The package calls it from
    ``structured_admm_iterations`` alone, with the kernel of the shape;
    tests and measurements call it to hold one kernel against another on
    a shape that would take a different one."""
    qb, A_sb, Ad, W = args[3], args[1], args[6], args[10]
    (B, n), m_s, m_d = qb.shape, A_sb.shape[0], Ad.shape[1]
    wk = variant == "tiled"
    if wk == (W.dtype == torch.float64):
        raise ValueError(f"structured_admm kernel ({variant}) takes "
                         f"{'WK as float32' if wk else 'C as float64'}, got {W.dtype}")
    outs = tuple(torch.empty((B, k), dtype=torch.float32, device=qb.device)
                 for k in (n, m_s, m_d, m_s, m_d))
    ptrs = [a.data_ptr() for a in args]
    ptrs[10:11] = (ptrs[10], None) if wk else (None, ptrs[10])
    err = lib.structured_admm_launch(
        *ptrs, *(o.data_ptr() for o in outs),
        B, n, m_s, m_d, int(iters), float(sigma), float(alpha),
        qb.device.index, torch.cuda.current_stream(qb.device).cuda_stream,
        VARIANTS.index(variant))
    if err != 0:
        raise RuntimeError(f"structured_admm kernel ({variant}) launch failed: "
                           + lib.structured_admm_error_string(err).decode())
    return outs


def structured_admm_iterations(
    Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, W,
    x0, zs0, zd0, ys0, yd0, *, iters: int, sigma: float, alpha: float,
) -> State5:
    """Run one rho phase of the loop: the CUDA kernel of the shape for CUDA
    float32 tensors (C in float64), the plain twin for CPU tensors. Shapes
    in the module docstring. ``structured_admm_iterations.launches`` counts
    kernel launches and ``.launches_by_variant`` counts them per kernel."""
    args = (Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, W,
            x0, zs0, zd0, ys0, yd0)
    if qb.device.type == "cpu":
        return structured_admm_iterations_ref(*args, iters=iters, sigma=sigma, alpha=alpha)
    if qb.device.type != "cuda":
        raise ValueError(f"structured_admm_iterations: no kernel for {qb.device}")

    B, n = qb.shape
    m_s, m_d = A_sb.shape[0], Ad.shape[1]
    wk = takes_wk(n, m_s, m_d)
    shapes = {
        "Ms_inv": (n, n), "A_sb": (m_s, n), "rho_s": (m_s,), "qb": (B, n),
        "lbs": (B, m_s), "ubs": (B, m_s), "Ad": (B, m_d, n), "lbd": (B, m_d),
        "ubd": (B, m_d), "rho_d": (B, m_d), "WK" if wk else "C": (B, n, m_d) if wk else (B, n, n),
        "x0": (B, n), "zs0": (B, m_s), "zd0": (B, m_d), "ys0": (B, m_s), "yd0": (B, m_d),
    }
    for (name, shape), a in zip(shapes.items(), args):
        want = torch.float64 if name == "C" else torch.float32
        if a.device != qb.device or a.dtype != want:
            raise ValueError(f"structured_admm_iterations: {name} is {a.dtype} on "
                             f"{a.device}; the kernel takes {want} on {qb.device}")
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
        raise ValueError(
            f"structured_admm_iterations: no kernel holds the shape (n={n}, m_s={m_s}, "
            f"m_d={m_d}): the vectors and row state of a lane exceed the shared memory of "
            f"a cluster's blocks")
    variant = VARIANTS[code]
    outs = launch_variant(lib, variant, args, iters=iters, sigma=sigma, alpha=alpha)
    structured_admm_iterations.launches += 1
    structured_admm_iterations.launches_by_variant[variant] += 1
    return outs


def fov_team_shape(A: int) -> Tuple[int, int, int]:
    """(n, m_s, m_d) of a fov team of A agents (benchmarks/swarm.py's rings:
    A - 1 neighbours, slack mode), the family of shapes that grows fastest."""
    return 35 + A, 119 + A, 12 * (A - 1)


structured_admm_iterations.launches = 0
structured_admm_iterations.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def random_phase_inputs(rng: np.random.Generator, B: int, n: int, m_s: int, m_d: int,
                        inactive_frac: float = 0.25, distinct: int | None = None,
                        operand: str | None = None):
    """Seeded, well-posed inputs for one rho phase, made the way ``_solve``
    makes them: an SPD shared system M_s and its f64 inverse, per-lane
    dynamic rows with some inactive (rho_d = 1e-12, bounds +-1e20), the
    operand of the x-update, and a clipped initial state. Returns numpy
    arrays in the argument order of ``structured_admm_iterations``, float32
    but for C. ``operand``: "wk" (the folded Woodbury WK), "c" (the float64
    C = (M_s + Ad' diag(rho_d) Ad)^-1, of the float32-rounded Ad the loop
    reads) or None (the shape's, ``takes_wk``); the other arrays do not
    depend on it. Used to hold the kernel against its twin. ``distinct``:
    make that many lanes and repeat them to B."""
    if operand is None:
        operand = "wk" if takes_wk(n, m_s, m_d) else "c"
    if distinct is not None and distinct < B:
        arrays = random_phase_inputs(rng, distinct, n, m_s, m_d, inactive_frac, operand=operand)
        reps = -(-B // distinct)
        return arrays[:3] + tuple(np.ascontiguousarray(np.concatenate([a] * reps)[:B])
                                  for a in arrays[3:])
    A_s = rng.normal(size=(m_s, n)) / np.sqrt(n)
    G = rng.normal(size=(n, n)) / np.sqrt(n)
    # well-conditioned (cond(M_s) ~ 10), so that 40 float32 iterations stay
    # within 1e-5 of float64 ones and two f32 loops can be held to 2e-4
    P = 0.5 * np.eye(n) + 0.1 * G @ G.T
    eq = rng.random(m_s) < 0.1
    rho_s = np.where(eq, 1.0, 0.1)
    M_s = P + 1e-6 * np.eye(n) + (A_s.T * rho_s) @ A_s
    Ms_inv = np.linalg.inv(M_s)

    Ad = rng.normal(size=(B, m_d, n)) / np.sqrt(n)
    inactive = rng.random((B, m_d)) < inactive_frac
    rho_d = np.where(inactive, 1e-12, 0.1)
    if operand == "wk":
        # matmul, not einsum: BLAS makes the 32-agent shapes a second, not a minute
        W = Ms_inv @ Ad.transpose(0, 2, 1)              # [B, n, m_d]
        sr = np.sqrt(rho_d)
        Cp = np.eye(m_d) + sr[:, :, None] * (Ad @ W) * sr[:, None, :]
        K = sr[:, :, None] * np.linalg.inv(Cp) * sr[:, None, :]
        op = W @ K
    else:
        Ad32 = Ad.astype(np.float32).astype(np.float64)
        Aw = Ad32 * np.sqrt(rho_d)[..., None]
        op = np.linalg.inv(M_s + Aw.transpose(0, 2, 1) @ Aw)   # [B, n, n]

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
    arrays = (Ms_inv, A_s, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, op,
              x0, zs0, zd0, ys0, yd0)
    return tuple(np.ascontiguousarray(a, np.float64 if i == 10 and operand == "c"
                                      else np.float32) for i, a in enumerate(arrays))
