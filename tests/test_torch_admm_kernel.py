"""The structured ADMM loop of mpc_cbf_torch (ops/qp/fused_admm.py): the
plain twin against the JAX package's Pallas kernel, the wrapper's routing,
and — on a machine with an NVIDIA GPU — the CUDA kernel against the twin.

The twin is held against mpc_cbf_tpu.ops.qp.pallas_admm's kernel run in
interpret mode (as tests/test_pallas_admm.py runs it on the CPU), at the
fov flagship shapes (n = 43, m_s = 127, m_d = 84), the connectivity shapes
(36, 126, 6), the 32-agent connectivity shapes (36, 126, 62) and the
32-agent fov shapes (67, 151, 372), and the shapes without a compiled
kernel (run_sim's 3-robot connectivity (38, 128, 4), the sweep's teams of 2
and 10 (37, 127, 2), (45, 135, 18), a 24-agent fov team (59, 143, 276)) for
40 iterations, to rtol = atol = 2e-4: the bar of
tests/test_pallas_admm.py:53-55 between two float32 loops that sum in
another order. The twin takes the shape's operand (``random_phase_inputs``
makes it): the Woodbury WK at the tiled kernel's shapes, the float64 C
elsewhere; the Pallas kernel takes WK of the same draw. The C form of the
loop (``folded_loop``, the algebra of the ``folded`` kernel, also at the
tiled shapes), the ``folded`` kernel's float32 summation order
(``folded_register_loop``, at its instances) and the generic kernel's three
stages (``generic_loop``) are held to the twin and to the Pallas kernel at
the same bar (the ``cluster`` kernel's loops: tests/test_torch_cluster.py).
The twin's, the Pallas kernel's and each layout model's outputs are computed
once a (lanes, seed, shape, operand) and shared by the tests that compare
them (``_twin_out``, ``_pallas_out``, ``_model_out``; read only). Every
compiled instance of ``tiled`` and ``folded`` is a shape that takes it. On
the card every kernel variant (tiled, folded, generic, cluster) is held to
the twin too.

The cases marked ``cuda`` import no JAX, so that they also run where the
GPU is and JAX is not (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_admm_kernel.py
"""

import functools
import re

import numpy as np
import pytest
import torch

from mpc_cbf_torch import _build
from mpc_cbf_torch.ops.qp import fused_admm
from mpc_cbf_torch.controllers import StructuredIMPC
from mpc_cbf_torch.ops.qp.fused_admm import (
    VARIANTS, random_phase_inputs, structured_admm_iterations, structured_admm_iterations_ref)
from mpc_cbf_torch.ops.qp.structured import StructuredConfig
from mpc_cbf_torch.types import State

import torch_parity_cases as cases

FOV, CONN, SWARM_CONN, SWARM_FOV = (43, 127, 84), (36, 126, 6), (36, 126, 62), (67, 151, 372)
CONN_LAMBDA2 = (36, 126, 14)         # 4-robot connectivity with the λ₂/CLF rows
# shapes without a compiled kernel (the generic kernel's): run_sim's 3-robot
# connectivity, the sweep's connectivity teams of 2 and 10, a 24-agent fov team
RUN_SIM_CONN, TEAM24_FOV = (38, 128, 4), (59, 143, 276)
SWEEP_R2, SWEEP_R10 = (37, 127, 2), (45, 135, 18)
# the largest fov team the generic kernel holds (29 agents, (64, 148, 336): 16
# warps of rows in registers); fov teams of 40 and 64 agents (35 + N, 119 + N,
# 12 (N - 1)) and a 40-robot connectivity team (35 + R, 125 + R, 2 R - 2): the
# cluster kernel's
TEAM29_FOV = fused_admm.fov_team_shape(29)
TEAM40_FOV, TEAM64_FOV, TEAM40_CONN = (75, 159, 468), (99, 183, 756), (75, 165, 78)
# lanes larger than one SM (the cluster kernel): fov teams of 85, 96, 128, 256
# and 400 agents (the last two streamed from device memory, the 400-agent
# lane's C too), connectivity teams of 128, 256 and 320 robots (the last
# streamed, C too)
TEAM85_FOV, TEAM96_FOV = fused_admm.fov_team_shape(85), fused_admm.fov_team_shape(96)
TEAM128_FOV, TEAM256_FOV = fused_admm.fov_team_shape(128), fused_admm.fov_team_shape(256)
TEAM400_FOV = fused_admm.fov_team_shape(400)
TEAM128_CONN, TEAM256_CONN, TEAM320_CONN = (163, 253, 254), (291, 381, 510), (355, 445, 638)
# the 32-robot connectivity team of build_sim with slack on (the benchmark's
# conn32): past generic's n = 64 and no folded instance, so cluster's, on one
# SM; the connectivity teams of 30 and 33 robots, the smallest and the largest
# that take that layout, and of 34, the first past it
CONN32 = (67, 157, 62)
TEAM30_CONN, TEAM33_CONN, TEAM34_CONN = (65, 155, 58), (68, 158, 64), (69, 159, 66)
ONE_SM = "registers cs=1 nw=8"
KW = dict(iters=40, sigma=1e-6, alpha=1.6)


def _inputs(B, seed, shape=FOV, operand=None):
    return random_phase_inputs(np.random.default_rng(seed), B, *shape, operand=operand)


@functools.lru_cache(maxsize=None)
def _model_out(loop, B, seed, shape, operand=None):
    """``loop`` (the twin or a layout model) on ``_inputs(B, seed, shape,
    operand)`` for KW's 40 iterations, computed once for the tests that
    share it: inference tensors, which refuse an in-place write."""
    with torch.inference_mode():
        return loop(*map(torch.from_numpy, _inputs(B, seed=seed, shape=shape, operand=operand)),
                    **KW)


def _twin_out(B, seed, shape):
    """The twin on the shape's own operand (cached, read only)."""
    return _model_out(structured_admm_iterations_ref, B, seed, shape)


@functools.lru_cache(maxsize=None)
def _pallas_out(B, seed, shape):
    """The JAX package's Pallas kernel in interpret mode on WK of the same draw,
    as read-only numpy arrays (cached)."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.pallas_admm import structured_admm_iterations as pallas
    out = tuple(np.array(o) for o in pallas(
        *map(jnp.asarray, _inputs(B, seed=seed, shape=shape, operand="wk")), **KW, block=128,
        interpret=True))
    for o in out:
        o.flags.writeable = False
    return out


@pytest.mark.parametrize("B,shape", [(5, FOV), (3, FOV), (4, CONN), (3, SWARM_CONN),
                                     (6, CONN_LAMBDA2), (2, SWARM_FOV), (3, RUN_SIM_CONN),
                                     (4, SWEEP_R2), (3, SWEEP_R10), (2, TEAM24_FOV)])
def test_twin_matches_pallas_kernel(B, shape):
    out_t = _twin_out(B, B, shape)
    out_j = _pallas_out(B, B, shape)
    for name, t, j in zip(("x", "zs", "zd", "ys", "yd"), out_t, out_j):
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


#: the loop as the ``folded`` kernel computes it: the twin's update order with
#: the x-update one product xt = C RHS in float64 from the lane's float64
#: C = (M_s + Ad' R Ad)^-1, at any shape (the twin takes WK at the tiled
#: kernel's shapes). It pins the algebra of the kernel where there is no card,
#: and stands in for the twin where generic or cluster is launched by name at
#: another kernel's shape.
folded_loop = fused_admm.folded_iterations_ref


FOLDED_CASES = [(5, FOV), (4, CONN), (3, SWARM_CONN), (6, CONN_LAMBDA2), (2, SWARM_FOV)]


@pytest.mark.parametrize("B,shape", FOLDED_CASES)
def test_folded_loop_matches_twin(B, shape):
    """xt = C RHS with the lane's float64 C = (M_s + Ad' R Ad)^-1: the algebra
    of the folded kernel, held to the bar of two float32 loops against the
    twin of the shape (at the tiled shapes the Woodbury form S - WK (Ad S),
    from which it differs by the float32 rounding of S and Ad S that it
    skips)."""
    out_f = _model_out(folded_loop, B, B, shape, "c")
    out_t = _twin_out(B, B, shape)
    for name, f, t in zip(("x", "zs", "zd", "ys", "yd"), out_f, out_t):
        assert f.shape == t.shape and f.dtype == torch.float32
        torch.testing.assert_close(f, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape", FOLDED_CASES)
def test_folded_loop_matches_pallas_kernel(B, shape):
    """The folded algebra against the JAX package's kernel itself (interpret
    mode) on the same inputs, at the bar the twin is held to."""
    out_f = _model_out(folded_loop, B, B, shape, "c")
    out_p = _pallas_out(B, B, shape)
    for name, f, p in zip(("x", "zs", "zd", "ys", "yd"), out_f, out_p):
        np.testing.assert_allclose(f.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


def folded_layouts():
    """{(n, m_s, m_d): (T, RG, CG, P)} of the ``FoldedShape<...>`` lines of
    csrc/structured_admm_folded.cu: threads a block, the grid of register
    tiles, threads a row of C."""
    src = (_build.SOURCES[0].parent / "structured_admm_folded.cu").read_text()
    return {tuple(v[:3]): tuple(v[3:]) for v in (
        tuple(map(int, m.split(","))) for m in re.findall(r"= FoldedShape<([\d, ]+)>;", src))}


def _fold(v, dim):
    """Pairwise sums of the halves of ``dim`` until one entry is left: the order
    of a butterfly whose first step pairs the lanes furthest apart."""
    while v.shape[dim] > 1:
        h = v.shape[dim] // 2
        v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
    return v.squeeze(dim)


def _fma(a, b, s):
    """float32 a b + s with one rounding (the product of two float32 is exact in
    float64)."""
    return (a.double() * b.double() + s.double()).float()


def folded_register_loop(Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, C,
                         x0, zs0, zd0, ys0, yd0, *, iters, sigma, alpha, layout=None):
    """The loop in the float32 summation order of the ``folded`` kernel
    (csrc/structured_admm_folded.cu) with the layout (T, RG, CG, P) of the
    shape's ``FoldedShape`` line, from the lane's float64 C. An iteration: each thread's column sums of r over the
    TR rows of its tile (one multiply-add at a time), met across the warp's
    32 / CG row groups by the butterfly, then RHS_j = (sigma x - q) + the sum
    of every P-th warp's partial in warp order, met across the P threads by
    the butterfly; xt = C RHS in float64; each thread's row sums of xt over
    the TC columns of its tile, met across the row group's CG threads by the
    butterfly; the row update of ``row_update`` (structured_admm.cuh)."""
    layouts = folded_layouts()
    T, RG, CG, P = layout or layouts[qb.shape[1], A_sb.shape[0], Ad.shape[1]]
    B, n = qb.shape
    m_s, m_d = A_sb.shape[0], Ad.shape[1]
    m = m_s + m_d
    TR, TC, NW, G = -(-m // RG), -(-n // CG), T // 32, 32 // CG
    assert TR <= CG and RG * CG <= T and n * P <= T
    A = torch.zeros(B, RG * TR, CG * TC)
    A[:, :m_s, :n] = A_sb
    A[:, m_s:m, :n] = Ad
    A = A.view(B, RG, TR, CG, TC)
    # the rows' state, padded to the grid (pad rows: rho 1, bounds 0, never read back)
    pad = lambda a, v: torch.nn.functional.pad(a, (0, RG * TR - m), value=v)
    rho = pad(torch.cat([rho_s.expand(B, -1), rho_d], 1), 1.0)
    lo, up = pad(torch.cat([lbs, lbd], 1), 0.0), pad(torch.cat([ubs, ubd], 1), 0.0)
    z, y = pad(torch.cat([zs0, zd0], 1), 0.0), pad(torch.cat([ys0, yd0], 1), 0.0)
    x, C = x0, C.double()
    alpha32, beta = torch.tensor(alpha, dtype=torch.float32), torch.tensor(1 - alpha, dtype=torch.float32)
    r = rho * z - y
    for _ in range(iters):
        rr = r.view(B, RG, TR)
        cols = torch.zeros(B, RG, CG, TC)
        for i in range(TR):
            cols = _fma(A[:, :, i], rr[:, :, i, None, None], cols)
        # row groups past the grid's (threads without a tile) add zeros
        cols = torch.nn.functional.pad(cols, (0, 0, 0, 0, 0, NW * G - RG))
        warp = _fold(cols.view(B, NW, G, CG * TC), 2)[..., :n]           # [B, NW, n]
        s = torch.zeros(B, P, n)
        for k in range(-(-NW // P)):
            for p in range(P):
                if p + P * k < NW:
                    s[:, p] = s[:, p] + warp[:, p + P * k]
        RHS = (sigma * x - qb) + _fold(s, 1)
        xt = torch.einsum("bij,bj->bi", C, RHS.double()).float()
        xv = torch.nn.functional.pad(xt, (0, CG * TC - n)).view(B, 1, 1, CG, TC)
        rows = torch.zeros(B, RG, TR, CG)
        for c in range(TC):
            rows = _fma(A[..., c], xv[..., c], rows)
        zA = _fold(rows, 3).reshape(B, RG * TR)
        x = alpha32 * xt + beta * x
        zr = alpha32 * zA + beta * z
        zn = torch.minimum(torch.maximum(zr + y / rho, lo), up)
        y = y + rho * (zr - zn)
        z = zn
        r = rho * z - y
    return x, z[:, :m_s], z[:, m_s:m], y[:, :m_s], y[:, m_s:m]


REGISTER_LOOP_CASES = [(5, FOV), (2, SWARM_FOV), (3, SWARM_CONN)]


def test_folded_layouts_are_the_instances():
    """The model reads the instances of the kernel: the 32-agent fov and
    connectivity shapes and the fov flagship, which take it; each with a row
    of its group for every thread (TR <= CG) and P threads a row of C."""
    layouts = folded_layouts()
    assert set(layouts) == {SWARM_FOV, SWARM_CONN, FOV}
    for (n, m_s, m_d), (T, RG, CG, P) in layouts.items():
        assert -(-(m_s + m_d) // RG) <= CG and RG * CG <= T and n * P <= T and T % 32 == 0


@pytest.mark.parametrize("B,shape", REGISTER_LOOP_CASES)
def test_folded_register_loop_matches_twin(B, shape):
    """The folded kernel's summation order against the twin of the shape, at
    the bar of two float32 loops (rtol = atol = 2e-4); at the tiled shapes the
    twin is the Woodbury form, whose float32 rounding of S and Ad S the C form
    skips."""
    out_f = _model_out(folded_register_loop, B, B, shape, "c")
    out_t = _twin_out(B, B, shape)
    for name, f, t in zip(("x", "zs", "zd", "ys", "yd"), out_f, out_t):
        assert f.shape == t.shape and f.dtype == torch.float32
        torch.testing.assert_close(f, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape", REGISTER_LOOP_CASES)
def test_folded_register_loop_matches_pallas_kernel(B, shape):
    """The folded kernel's summation order against the JAX package's kernel
    itself (interpret mode) on the same inputs, at the bar the twin is held
    to."""
    out_f = _model_out(folded_register_loop, B, B, shape, "c")
    out_p = _pallas_out(B, B, shape)
    for name, f, p in zip(("x", "zs", "zd", "ys", "yd"), out_f, out_p):
        np.testing.assert_allclose(f.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


def generic_warps(n, m, rows_a_warp=32, threads_a_row=4):
    """Warps of a block of the generic kernel (csrc/structured_admm_generic.cu,
    ``generic_warps``): enough for the rows, 32 a warp, and for four threads
    on each row of C, at most 8 at the RegN64 line (n <= 64, m <= 256) and
    16 at RegN64Tall."""
    max_warps = 8 if n <= 64 and m <= 256 else 16
    return min(max_warps, max(-(-m // rows_a_warp), -(-threads_a_row * n // 32)))


def generic_loop(Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, C,
                 x0, zs0, zd0, ys0, yd0, *, iters, sigma, alpha):
    """The loop as the ``generic`` kernel computes it, in plain PyTorch, from
    the lane's float64 C [B, n, n]: the kernel's stages an iteration. 1: the
    rows of [A_s; A_d] split into the kernel's warps, each warp's column sums
    of r over its rows; 2: RHS = sigma x - q + the warps' partial sums, in the
    warps' order; 3: xt = C RHS in float64; 4: the rows of [A_s; A_d] xt and
    the row updates. It pins the kernel's algebra and its order of summation
    across warps where there is no card."""
    dt, hi = qb.dtype, torch.float64
    B, n = qb.shape
    m_s = A_sb.shape[0]
    C = C.to(hi)
    A = torch.cat([A_sb.expand(B, -1, -1), Ad], 1)                # [B, m, n]
    m = A.shape[1]
    rw = -(-m // generic_warps(n, m))                             # rows a warp
    lo = torch.cat([lbs, lbd], 1)
    up = torch.cat([ubs, ubd], 1)
    rho = torch.cat([rho_s.expand(B, -1), rho_d], 1)
    x, z, y = x0, torch.cat([zs0, zd0], 1), torch.cat([ys0, yd0], 1)
    for _ in range(iters):
        r = rho * z - y
        parts = [torch.einsum("bij,bi->bj", A[:, i:i + rw], r[:, i:i + rw])
                 for i in range(0, m, rw)]
        RHS = sigma * x - qb + torch.stack(parts).sum(0)
        xt = torch.einsum("bij,bj->bi", C, RHS.to(hi)).to(dt)
        zA = torch.einsum("bij,bj->bi", A, xt)
        x = alpha * xt + (1 - alpha) * x
        zr = alpha * zA + (1 - alpha) * z
        zn = torch.clamp(zr + y / rho, lo, up)
        y = y + rho * (zr - zn)
        z = zn
    return x, z[:, :m_s], z[:, m_s:], y[:, :m_s], y[:, m_s:]


GENERIC_CASES = FOLDED_CASES + [(3, RUN_SIM_CONN), (4, SWEEP_R2), (3, SWEEP_R10),
                                (2, TEAM24_FOV), (2, TEAM29_FOV)]


@pytest.mark.parametrize("B,shape", GENERIC_CASES)
def test_generic_loop_matches_twin(B, shape):
    """The generic kernel's three stages against the twin, at the bar of two
    float32 loops (they differ by the order of the column sums and, at the
    tiled shapes, by the float32 rounding of S and Ad S that the C form
    skips)."""
    out_g = _model_out(generic_loop, B, B, shape, "c")
    out_t = _twin_out(B, B, shape)
    for name, g, t in zip(("x", "zs", "zd", "ys", "yd"), out_g, out_t):
        assert g.shape == t.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape", GENERIC_CASES)
def test_generic_loop_matches_pallas_kernel(B, shape):
    """The generic kernel's algebra against the JAX package's kernel itself
    (interpret mode) on the same inputs, at the bar the twin is held to."""
    out_g = _model_out(generic_loop, B, B, shape, "c")
    out_p = _pallas_out(B, B, shape)
    for name, g, p in zip(("x", "zs", "zd", "ys", "yd"), out_g, out_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


def compiled_instances():
    """[(variant, (n, m_s, m_d))] of the ``TcShape<...>`` lines of
    csrc/structured_admm_tiled.cu and the ``FoldedShape<...>`` lines of
    csrc/structured_admm_folded.cu: the instances compiled per shape."""
    csrc = _build.SOURCES[0].parent
    return [(variant, tuple(map(int, m)))
            for variant, kind in (("tiled", "TcShape"), ("folded", "FoldedShape"))
            for m in re.findall(rf"= {kind}<(\d+), (\d+), (\d+),",
                                (csrc / f"structured_admm_{variant}.cu").read_text())]


@pytest.mark.parametrize("variant,shape", compiled_instances(),
                         ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
def test_every_compiled_instance_is_reachable_by_shape(variant, shape):
    """structured_admm_variant tries tiled, then folded: a tiled instance is
    reachable where its shape is one of ``TILED_SHAPES`` (the shapes its
    has-check names, which take WK), a folded instance where its shape is
    not (else tiled takes it first). An instance no shape reaches would run
    by name only."""
    assert (shape in fused_admm.TILED_SHAPES) == (variant == "tiled")


def test_variants_follow_the_kernel_enum():
    """VARIANTS is indexed by the code structured_admm_variant returns: the
    AdmmVariant enum of csrc/structured_admm.cuh, read from the source."""
    header = (_build.SOURCES[0].parent / "structured_admm.cuh").read_text()
    enum = re.search(r"enum AdmmVariant \{([^}]*)\}", header).group(1)
    codes = {name: int(v) for name, v in re.findall(r"k(\w+) = (-?\d+)", enum)}
    assert codes.pop("None") == -1
    assert {name.lower(): v for name, v in codes.items()} == {v: i for i, v in enumerate(VARIANTS)}


def test_wrapper_runs_twin_on_cpu_without_launching():
    arrays = [torch.from_numpy(a) for a in _inputs(4, seed=11)]
    before = structured_admm_iterations.launches
    out = structured_admm_iterations(*arrays, **KW)
    ref = structured_admm_iterations_ref(*arrays, **KW)
    assert structured_admm_iterations.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(structured_admm_iterations.launches_by_variant) == set(VARIANTS)


def test_wrapper_has_no_fallback_off_cpu():
    """A tensor on a device without the kernel raises, it is never moved."""
    arrays = [torch.from_numpy(a).to("meta") for a in _inputs(2, seed=12)]
    with pytest.raises(ValueError, match="no kernel"):
        structured_admm_iterations(*arrays, **KW)


def test_build_flags():
    """sm_90a (wgmma needs the 'a'), no fast math (IEEE division by the
    1e-12 rho of inactive rows), output under build/kernels/."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "ftz" not in flags
    assert _build.build_dir().parent == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "kernels")
    assert "-shared" not in _build.NVCC_FLAGS     # sources compile apart, one link at the end
    assert [p.name for p in _build.SOURCES] == [
        "structured_admm.cu", "structured_admm_cluster.cu", "structured_admm_folded.cu",
        "structured_admm_generic.cu", "structured_admm_tiled.cu"]
    assert [p.name for p in _build.HEADERS] == ["structured_admm.cuh"]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B,took", [
    (FOV, 1001, "folded"),           # the fov flagship: one lane a block, the lane's C
    (FOV, 3, "folded"),
    (CONN, 1001, "tiled"),           # a ragged last block
    (CONN, 3, "tiled"),              # fewer lanes than a block holds
    (CONN_LAMBDA2, 1001, "tiled"),
    (CONN_LAMBDA2, 3, "tiled"),
    (SWARM_CONN, 1001, "folded"),    # one lane a block, WK folded into the lane's C
    (SWARM_CONN, 3, "folded"),
    (SWARM_FOV, 64, "folded"),
    (SWARM_FOV, 3, "folded"),
    (RUN_SIM_CONN, 3, "generic"),    # no instantiation: [A_s; A_d] in registers, C in shared
    (SWEEP_R2, 30, "generic"),       # the sweep's teams of 2 and 10 at 15 R lanes
    (SWEEP_R10, 150, "generic"),
    (TEAM24_FOV, 16, "generic"),     # the 24-agent fov team: registers too, one block an SM
    (TEAM29_FOV, 16, "generic"),     # the largest fov team generic holds
    (TEAM40_FOV, 16, "cluster"),     # past generic's registers: a lane on 2 or 4 SMs, in registers
    (TEAM64_FOV, 8, "cluster"),
    (TEAM40_CONN, 16, "cluster"),
    (CONN32, 64, "cluster"),
    ((162, 2, 2), 3, "cluster"),     # n above every generic layout
    ((165, 4, 4), 3, "cluster"),
    (TEAM85_FOV, 3, "cluster"),      # the first fov team past FromMemory: rows in registers
    (TEAM96_FOV, 3, "cluster"),
    (TEAM128_FOV, 2, "cluster"),
    (fused_admm.fov_team_shape(160), 2, "cluster"),   # rows and C streamed
    (TEAM256_FOV, 2, "cluster"),
    (TEAM400_FOV, 2, "cluster"),
    (TEAM128_CONN, 9, "cluster"),
    (TEAM256_CONN, 3, "cluster"),
    (TEAM320_CONN, 3, "cluster"),    # rows and C streamed
])
def test_kernel_matches_twin_on_gpu(shape, B, took):
    """The kernel each shape takes against the twin on the card; same bar as
    the twin against the Pallas kernel. The shape alone picks the variant."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(B, seed=21, shape=shape)]
    before = dict(structured_admm_iterations.launches_by_variant)
    total = structured_admm_iterations.launches
    out_k = structured_admm_iterations(*arrays, **KW)
    out_t = structured_admm_iterations_ref(*arrays, **KW)
    torch.cuda.synchronize()
    assert structured_admm_iterations.launches == total + 1
    after = structured_admm_iterations.launches_by_variant
    assert {v: after[v] - before[v] for v in VARIANTS} == {v: int(v == took) for v in VARIANTS}
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B,layout", [(CONN32, 64, ONE_SM),
                                            (TEAM256_FOV, 2, "streamed cs=8 nw=8")])
def test_cluster_launches_count_their_layout_on_gpu(shape, B, layout):
    """Each launch of the cluster kernel counts once under the layout it ran
    in (``launches_by_layout``, read from the kernel's own ``layout_for``):
    the 32-robot connectivity lane with its rows in the registers of one block
    of 8 warps (no cluster, two blocks an SM), the 256-agent fov lane streamed
    through 8 blocks of 8 warps."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(B, seed=26, shape=shape)]
    before = dict(structured_admm_iterations.launches_by_layout)
    structured_admm_iterations(*arrays, **dict(KW, iters=10))
    torch.cuda.synchronize()
    after = structured_admm_iterations.launches_by_layout
    assert {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)} == \
        {layout: 1}
    assert fused_admm.cluster_layout(*shape) == layout


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B", [(CONN32, 64), (TEAM30_CONN, 64), (TEAM33_CONN, 64),
                                     (CONN32, 3)])
@pytest.mark.parametrize("iters", [40, 150])
def test_one_sm_layout_matches_twin_on_gpu(shape, B, iters):
    """The cluster kernel's register layout on one SM (one lane a block of 8
    warps, two blocks an SM, both exchanges in the block's shared memory)
    against the twin at conn32's lane and at the smallest and the largest
    connectivity team it takes, for 40 iterations and for the 150 of a
    step's longest phase; the bar of two float32 loops that sum in another
    order."""
    _need_gpu()
    assert fused_admm.cluster_layout(*shape) == ONE_SM
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(B, seed=27, shape=shape)]
    before = dict(structured_admm_iterations.launches_by_layout)
    out_k = structured_admm_iterations(*arrays, **dict(KW, iters=iters))
    out_t = structured_admm_iterations_ref(*arrays, **dict(KW, iters=iters))
    torch.cuda.synchronize()
    assert structured_admm_iterations.launches_by_layout[ONE_SM] == before.get(ONE_SM, 0) + 1
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [
    (TEAM30_CONN, ONE_SM), (CONN32, ONE_SM), (TEAM33_CONN, ONE_SM),
    (TEAM34_CONN, "registers cs=2 nw=16"),
    (TEAM40_FOV, "registers cs=2 nw=16"), (TEAM64_FOV, "registers cs=4 nw=16"),
    (TEAM96_FOV, "registers cs=8 nw=16"), (TEAM128_FOV, "registers cs=8 nw=16"),
    (TEAM256_FOV, "streamed cs=8 nw=8"), (TEAM400_FOV, "streamed cs=8 nw=4"),
    (TEAM128_CONN, "registers cs=2 nw=8"), (TEAM256_CONN, "registers cs=8 nw=16")])
def test_cluster_layouts_by_shape_on_gpu(shape, layout):
    """The layout the cluster kernel's ``layout_for`` gives each shape: one
    SM for the connectivity teams of 30-33 robots, and for every other shape
    of chip_smoke.py's cluster table the layout it had before the one-SM
    layout came (the 34-robot team, the first past it, too)."""
    _need_gpu()
    assert fused_admm.cluster_layout(*shape) == layout


@pytest.mark.cuda
@pytest.mark.parametrize("variant,shape,B", [("generic", FOV, 100), ("generic", SWARM_CONN, 64),
                                             ("cluster", FOV, 100), ("cluster", SWARM_CONN, 64),
                                             ("cluster", SWARM_FOV, 16),
                                             ("cluster", RUN_SIM_CONN, 3),
                                             ("cluster", TEAM64_FOV, 8)])
def test_generic_kernels_take_the_fov_shapes_on_gpu(variant, shape, B):
    """The kernels that take runtime shapes, launched by name against the
    plain C-form loop at shapes the wrapper gives to another kernel: generic
    at the fov flagship and the 32-agent connectivity shapes, cluster at
    those, at the 32-agent fov shapes and at run_sim's 3-robot team; and
    cluster at the 64-agent fov team, its own."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(B, seed=21, shape=shape, operand="c")]
    before = structured_admm_iterations.launches
    out_k = fused_admm.launch_variant(fused_admm._lib(), variant, arrays, **KW)
    out_t = folded_loop(*arrays, **KW)
    torch.cuda.synchronize()
    assert structured_admm_iterations.launches == before     # only the wrapper counts
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FOV, CONN, CONN_LAMBDA2, SWARM_CONN, SWEEP_R10, TEAM128_CONN,
                                   TEAM256_FOV, CONN32])
def test_nan_lane_leaves_its_block_untouched_on_gpu(shape):
    """The tiled kernel runs several lanes in one block, the folded and
    generic kernels several blocks on one SM, the cluster kernel a lane on
    several SMs beside other lanes, or (conn32's lane) two blocks of one lane
    each on one SM; a lane that goes NaN changes no bit of any other lane."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(13, seed=23, shape=shape)]
    clean = structured_admm_iterations(*arrays, **KW)
    arrays[3] = arrays[3].clone()
    arrays[3][5] = float("nan")
    dirty = structured_admm_iterations(*arrays, **KW)
    keep = torch.arange(13, device="cuda") != 5
    assert bool(torch.isnan(dirty[0][5]).all())
    for c, d in zip(clean, dirty):
        assert torch.equal(c[keep], d[keep])


@pytest.mark.cuda
def test_every_team_takes_a_redesigned_kernel_on_gpu():
    """Every fov team of 2 to 512 agents and every connectivity team of 2 to
    512 robots takes tiled, folded, generic or cluster: every team to 29
    agents or robots one of the first three, the larger ones cluster (but the
    32-agent fov team, folded's); folded the fov teams of 8 (the flagship) and
    32 agents; the tiled kernel exactly the shapes that take WK."""
    _need_gpu()
    lib = fused_admm._lib()
    fov = {A: fused_admm.fov_team_shape(A) for A in range(2, 513)}
    conn = {R: (35 + R, 125 + R, 2 * R - 2) for R in range(2, 513)}
    for teams in (fov, conn):
        codes = {size: lib.structured_admm_variant(*s) for size, s in teams.items()}
        assert min(codes.values()) >= 0
        took = {size: VARIANTS[c] for size, c in codes.items()}
        assert {size: v for size, v in took.items()
                if (v == "cluster") != (size > 29 and v != "folded")} == {}
        assert [size for size, v in took.items() if v == "folded"] == ([8, 32] if teams is fov else [])
        assert {size for size, v in took.items() if v == "tiled"} == \
            {size for size, s in teams.items() if fused_admm.takes_wk(*s)}


@pytest.mark.cuda
def test_fov_flagship_takes_the_kernel_of_its_route_on_gpu():
    """The fov flagship (43, 127, 84), the main path, takes the kernel of its
    operand's form: folded for the lane's C (``takes_wk`` false), tiled for
    WK."""
    _need_gpu()
    lib = fused_admm._lib()
    assert VARIANTS[lib.structured_admm_variant(*FOV)] == \
        ("tiled" if fused_admm.takes_wk(*FOV) else "folded")


@pytest.mark.cuda
@pytest.mark.parametrize("variant,shape,operand", [("tiled", FOV, "wk"), ("folded", CONN, "c"),
                                                   ("folded", CONN_LAMBDA2, "c")])
def test_launch_by_name_without_an_instance_raises_on_gpu(variant, shape, operand):
    """tiled and folded have instances at their own shapes only: launched by
    name at another kernel's shape (the fov flagship, folded's; the
    connectivity and λ₂/CLF shapes, tiled's) on the operand they take, the
    launch returns cudaErrorInvalidValue and ``launch_variant`` raises."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(3, seed=25, shape=shape,
                                                          operand=operand)]
    with pytest.raises(RuntimeError, match=rf"kernel \({variant}\) launch failed"):
        fused_admm.launch_variant(fused_admm._lib(), variant, arrays, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B", [((420, 10, 2), 3),             # C of 1.41 MB: rows streamed
                                     (fused_admm.fov_team_shape(512), 1)])  # rows and C streamed
def test_shapes_past_the_old_limit_launch_cluster_on_gpu(shape, B):
    """A lane whose float64 C exceeded what the first cluster layouts held
    beside their staging (n = 420) and a 512-agent fov lane (547, 631, 6132)
    launch the cluster kernel and agree with the twin."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(B, seed=24, shape=shape)]
    before = structured_admm_iterations.launches_by_variant["cluster"]
    out_k = structured_admm_iterations(*arrays, **dict(KW, iters=10))
    out_t = structured_admm_iterations_ref(*arrays, **dict(KW, iters=10))
    torch.cuda.synchronize()
    assert structured_admm_iterations.launches_by_variant["cluster"] == before + 1
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_kernel_refuses_float64_on_gpu():
    """The kernel takes float32 only; a float64 CUDA tensor raises and is
    not routed to the twin."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda().double() for a in _inputs(2, seed=22)]
    before = structured_admm_iterations.launches
    with pytest.raises(ValueError, match="float32"):
        structured_admm_iterations(*arrays, **KW)
    assert structured_admm_iterations.launches == before


@pytest.mark.cuda
def test_control_step_runs_kernel_on_gpu():
    """A connectivity control step on the card launches the kernel once per
    rho phase (2 IMPC iterations x 2 phases) and agrees with the same step
    through the plain loop to rtol = atol = 2e-4, the bar of the fused loop
    against the scan loop (tests/test_pallas_admm.py:53-55)."""
    _need_gpu()
    pos, vel, ref, blob, mask = cases.conn_inputs(np.random.default_rng(4), 64)
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    args = (State(T(pos), T(vel)), T(ref), T(blob), torch.as_tensor(mask, device="cuda"))
    ctrl = cases.torch_controller("connectivity", "cuda", torch.float32)
    outs = []
    for use_kernel in (True, False):
        before = structured_admm_iterations.launches
        outs.append(StructuredIMPC(ctrl, StructuredConfig(iters=60, use_kernel=use_kernel))
                    .optimize_batch(*args))
        torch.cuda.synchronize()
        assert structured_admm_iterations.launches - before == (4 if use_kernel else 0)
    res_k, res_t = outs
    assert bool(torch.isfinite(res_k.coeffs).all())
    torch.testing.assert_close(res_k.coeffs, res_t.coeffs, rtol=2e-4, atol=2e-4)
    assert torch.equal(res_k.success, res_t.success)
