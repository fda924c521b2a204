"""The tiled kernel's tensor-core loop (csrc/structured_admm_tiled.cu, the
``TcShape`` instances: the connectivity shapes (36, 126, 6) and (36, 126, 14))
where there is no card.

- ``split_tf32``: a numpy model of ``cvt.rna.tf32.f32`` (round to nearest,
  ties away from zero, to 10 mantissa bits) and of the 3xTF32 split v = big +
  small, checked for what the kernel relies on: both halves are TF32 values
  and |v - big - small| <= 2^-22 |v|.
- ``tc_loop``: the loop in the kernel's products and summation order, from
  the layout of the shape's ``TcShape`` line: A_s xt and A_s' r_s in 3xTF32
  (small x big, big x small, big x big, each tensor-core product of 8 terms
  summed exactly and rounded once into the float32 accumulator), A_s' r_s by
  row parts summed in part order, Ms_inv RHS and WK t in float64, S rounded to
  float32, t = A_d S and A_d xt as the register tiles' sums met by the
  transposing butterfly, A_d' r_d met across the row groups, y / rho as y
  times 1 / rho with one correction (``rcp_div``). It is held against the twin
  (``woodbury_iterations_ref``) and the JAX package's Pallas kernel in
  interpret mode at the bar of tests/test_pallas_admm.py:53-55 (rtol = atol =
  2e-4, two float32 loops that sum in another order).
- ``rcp_div``: the row update's y / rho as the kernel forms it, y (1 / rho)
  corrected once by the residual (``row_update_rcp``), against float32's
  IEEE division over wide ranges of y and rho, rho = 1e-12 (the inactive
  rows) and denormal y: the same bits wherever |y| >= 2^-102, one unit in the
  last place at most below (the residual is then a denormal), and NaN where
  y (1 / rho) overflows (division gives an infinity there).

On the card the kernel itself is held to the twin by
tests/test_torch_admm_kernel.py and chip_smoke.py; the case marked ``cuda``
here checks that the connectivity shapes still take it, also for a step's
longest phase:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tiled_tc.py
"""

import re

import numpy as np
import pytest
import torch

from mpc_cbf_torch import _build
from mpc_cbf_torch.ops.qp import fused_admm

CONN, CONN_LAMBDA2 = (36, 126, 6), (36, 126, 14)
KW = dict(iters=40, sigma=1e-6, alpha=1.6)


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: float32 to the nearest value with 10 mantissa bits,
    ties away from zero (the low 13 bits cleared); NaN and Inf pass."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    sign, mag = u & np.uint32(0x80000000), u & np.uint32(0x7FFFFFFF)
    rounded = sign | ((mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000))
    special = (u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    return np.where(special, u, rounded).view(np.float32)


def split_tf32(a: np.ndarray):
    """The 3xTF32 split of the kernel: big = tf32(a), small = tf32(a - big)."""
    a = np.asarray(a, np.float32)
    big = tf32_rna(a)
    return big, tf32_rna((a - big).astype(np.float32))


def test_split_tf32():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    a = np.concatenate([a, np.float32([0.0, -0.0, 1.0, -1.5, 3.0e38, 1e-40, -7e-42])])
    big, small = split_tf32(a)
    for half in (big, small):
        assert not (half.view(np.uint32) & np.uint32(0x1FFF)).any()   # TF32 values
    # the bound, where small is a normal number (|a| above 2^-100; below, the halves
    # keep fewer bits, but stay TF32 values)
    err = np.abs(a.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    normal = np.abs(a) >= 2.0 ** -100
    assert normal.sum() > 19000
    assert (err[normal] <= 2.0 ** -22 * np.abs(a[normal].astype(np.float64))).all()
    # ties away from zero, and a plain round to nearest otherwise
    tie = np.float32([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    np.testing.assert_array_equal(tf32_rna(tie), np.float32([1 + 2 ** -10, -(1 + 2 ** -10),
                                                            1 + 2 * 2 ** -10]))
    assert tf32_rna(np.float32([1 + 2 ** -12]))[0] == np.float32(1.0)
    assert np.isnan(tf32_rna(np.float32([np.nan]))[0])
    assert np.isinf(tf32_rna(np.float32([np.inf]))[0])


def fma32(a, b, c):
    """float32 fmaf(a, b, c), one rounding: the product is exact in float64,
    the sum is rounded to odd there (53 >= 24 + 2 bits, so the rounding to
    nearest float32 that follows is the correct one)."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)                 # s + err = p + c exactly
    u = np.ascontiguousarray(s).view(np.uint64)
    inexact = err != 0
    u = np.where(inexact & ((err < 0) != (s < 0)), u - np.uint64(1), u)   # toward zero
    return np.where(inexact, u | np.uint64(1), u).view(np.float64).astype(np.float32)


def rcp_div(y, rho):
    """y / rho as row_update_rcp forms it: q = y (1 / rho), then q + (y - q
    rho) / rho with both steps fused multiply-adds."""
    y, rho = np.asarray(y, np.float32), np.asarray(rho, np.float32)
    with np.errstate(all="ignore"):
        rinv = np.float32(1) / rho
        q = y * rinv
        return fma32(fma32(-q, rho, y), rinv, q)


def _log_uniform(rng, lo, hi, n, signed=True):
    v = (10.0 ** rng.uniform(lo, hi, n)).astype(np.float32)
    return v * rng.choice(np.float32([-1, 1]), n) if signed else v


RCP_DRAWS = {   # (y, rho) of 10^5 draws each
    "wide": lambda rng, n: (_log_uniform(rng, -45, 38, n), _log_uniform(rng, -12, 12, n, False)),
    "rho 1e-12": lambda rng, n: (_log_uniform(rng, -45, 38, n), np.full(n, 1e-12, np.float32)),
    "denormal y": lambda rng, n: (
        rng.integers(1, 2 ** 23, n).astype(np.uint32).view(np.float32)
        * rng.choice(np.float32([-1, 1]), n), _log_uniform(rng, -12, 6, n, False)),
    "one binade": lambda rng, n: ((1 + rng.random(n)).astype(np.float32),
                                  (1 + rng.random(n)).astype(np.float32)),
}


@pytest.mark.parametrize("draw", sorted(RCP_DRAWS))
def test_rcp_div_matches_ieee_division(draw):
    """The reciprocal and its one correction give float32's y / rho bit for
    bit wherever |y| >= 2^-102 and y (1 / rho) is finite, at most one unit in
    the last place off below 2^-102, and NaN where y (1 / rho) overflows; the
    counts are printed."""
    rng = np.random.default_rng(sorted(RCP_DRAWS).index(draw))
    y, rho = RCP_DRAWS[draw](rng, 100_000)
    with np.errstate(all="ignore"):
        ref = y / rho
        over = np.isinf(y * (np.float32(1) / rho))
    got = rcp_div(y, rho)
    assert np.isfinite(y).all() and np.isfinite(ref[~over]).all()
    assert np.isnan(got[over]).all() and np.isinf(ref[over]).all()
    same = got == ref
    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    tiny = np.abs(y) < 2.0 ** -102
    print(f"{draw}: {int((~same & ~over).sum())} of {int((~over).sum())} finite quotients "
          f"differ from y / rho in the last place ({int(tiny.sum())} draws with |y| < 2^-102); "
          f"{int(over.sum())} overflow")
    assert same[~tiny & ~over].all()
    assert (same | (ulps <= 1))[tiny & ~over].all()


def tc_layouts():
    """{(n, m_s, m_d): (L, RP, RG, CG)} of the ``TcShape<...>`` lines of
    csrc/structured_admm_tiled.cu."""
    src = (_build.SOURCES[0].parent / "structured_admm_tiled.cu").read_text()
    return {tuple(v[:3]): tuple(v[3:]) for v in (
        tuple(map(int, m.split(","))) for m in re.findall(r"= TcShape<([\d, ]+)>;", src))}


def test_tc_layouts_are_the_connectivity_instances():
    """The tensor-core loop holds exactly the shapes that take WK, each with at
    least 32 lanes a block in lane groups of 16 (an M tile of A_s xt), a warp
    for every (lane group, row part), a lane's threads within one warp as an
    RG x CG grid with an owner for each row of a row group."""
    layouts = tc_layouts()
    assert set(layouts) == set(fused_admm.TILED_SHAPES)
    for (n, m_s, m_d), (L, RP, RG, CG) in layouts.items():
        warps = L // 16 * RP
        tpl = 32 * warps // L
        assert L >= 32 and L % 16 == 0 and RP >= 4 and warps * 32 <= 1024
        assert tpl <= 32 and tpl & (tpl - 1) == 0 and RG * CG == tpl and CG & (CG - 1) == 0
        assert -(-m_d // RG) <= CG and 8 * RP * -(-m_s // (8 * RP)) >= m_s


def _fma(a, b, s):
    """float32 a b + s with one rounding."""
    return (a.double() * b.double() + s.double()).float()


def _fold(v, dim):
    """Pairwise sums of the halves of ``dim`` until one entry is left: the
    order of the transposing butterfly (its first step pairs the threads
    furthest apart)."""
    while v.shape[dim] > 1:
        h = v.shape[dim] // 2
        v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
    return v.squeeze(dim)


def _tf32(t):
    return torch.from_numpy(tf32_rna(t.numpy()))


def _split(t):
    big = _tf32(t)
    return big, _tf32(t - big)


def _mma(acc, a, b):
    """One tensor-core product of 8 terms into a float32 accumulator: the
    terms (exact products of TF32 values) summed exactly, rounded once."""
    return (acc.double() + a.double() @ b.double()).float()


def _product_3xtf32(a, b, small_a_first=True, k_tile=8):
    """a [..., M, K] b [K, N] in 3xTF32, k-tiles of 8 in order: a small x b big,
    a big x b small (the other way round with ``small_a_first`` false), big x
    big."""
    K = a.shape[-1]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    (ab, as_), (bb, bs) = _split(a), _split(b)
    for k in range(0, K, k_tile):
        sl = slice(k, k + k_tile)
        cross = [(as_[..., sl], bb[sl]), (ab[..., sl], bs[sl])]
        for x, y in cross if small_a_first else cross[::-1]:
            acc = _mma(acc, x, y)
        acc = _mma(acc, ab[..., sl], bb[sl])
    return acc


def tc_loop(Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
            x0, zs0, zd0, ys0, yd0, *, iters, sigma, alpha, layout=None):
    """The loop as the tiled kernel's tensor-core instances compute it (the
    module docstring), with the layout (L, RP, RG, CG) of the shape's
    ``TcShape`` line."""
    B, n = qb.shape
    m_s, m_d = A_sb.shape[0], Ad.shape[1]
    L, RP, RG, CG = layout or tc_layouts()[n, m_s, m_d]
    rows = 8 * -(-m_s // (8 * RP))                 # rows of a row part
    TR, TC = -(-m_d // RG), -(-n // CG)
    A_s = torch.zeros(RP * rows, n)
    A_s[:m_s] = A_sb

    # the lane's A_d as its threads' tiles [B, RG, TR, CG, TC], zero past the lane's rows
    Ag = torch.zeros(B, RG * TR, CG * TC)
    Ag[:, :m_d, :n] = Ad
    Ag = Ag.view(B, RG, TR, CG, TC)

    def dyn_rows(v):                               # A_d v: tiles' sums met across the CG threads
        vc = torch.nn.functional.pad(v, (0, CG * TC - n)).view(B, 1, 1, CG, TC)
        part = torch.zeros(B, RG, TR, CG)
        for c in range(TC):
            part = _fma(Ag[..., c], vc[..., c], part)
        part = torch.nn.functional.pad(part, (0, 0, 0, CG - TR))   # the butterfly's zero rows
        return _fold(part, 3).reshape(B, RG * CG)[:, [g * CG + i for g in range(RG)
                                                      for i in range(TR)]][:, :m_d]

    def dyn_cols(r):                               # A_d' r: column sums met across row groups
        rr = torch.nn.functional.pad(r, (0, RG * TR - m_d)).view(B, RG, TR, 1, 1)
        part = torch.zeros(B, RG, CG, TC)
        for i in range(TR):
            part = _fma(Ag[:, :, i], rr[:, :, i], part)
        o = 1                                      # the xor butterfly: row group bit 0 first
        while o < RG:
            part = part + part[:, [g ^ o for g in range(RG)]]
            o *= 2
        return part[:, 0].reshape(B, CG * TC)[:, :n]

    rho_pad = torch.ones(RP * rows)
    rho_pad[:m_s] = rho_s

    def update(zA, z, y, rho, lo, hi):             # row_update_rcp
        zr = alpha * zA + (1 - alpha) * z
        q = torch.from_numpy(rcp_div(y.numpy(), rho.expand_as(y).numpy()))
        zn = torch.minimum(torch.maximum(zr + q, lo), hi)
        yn = y + rho * (zr - zn)
        return zn, yn, rho * zn - yn

    pad_s = lambda a: torch.nn.functional.pad(a, (0, RP * rows - m_s))
    zs, ys, los, his = pad_s(zs0), pad_s(ys0), pad_s(lbs), pad_s(ubs)
    x, zd, yd = x0, zd0, yd0
    rs, rd = rho_pad * zs - ys, rho_d * zd - yd
    Ms64, WK64 = Ms_inv.double(), WK.double()
    for _ in range(iters):
        # RHS: (sigma x - q) + each row part's A_s' r_s in part order + A_d' r_d
        rhs = _fma(torch.tensor(sigma), x, -qb)
        for p in range(RP):
            sl = slice(p * rows, (p + 1) * rows)
            # the kernel's A operand is A_s' and its B r_s: A_s small x r_s big first
            rhs = rhs + _product_3xtf32(rs[:, None, sl], A_s[sl], False)[:, 0]
        rhs = rhs + dyn_cols(rd)
        S = (rhs.double() @ Ms64.T).float()
        t = dyn_rows(S)
        xt = (S.double() - torch.einsum("bjd,bd->bj", WK64, t.double())).float()
        x = alpha * xt + (1 - alpha) * x
        zs, ys, rs = update(_product_3xtf32(xt[:, None, :], A_s.T, True)[:, 0], zs, ys, rho_pad,
                            los, his)
        zd, yd, rd = update(dyn_rows(xt), zd, yd, rho_d, lbd, ubd)
    return x, zs[:, :m_s], zd, ys[:, :m_s], yd


def _inputs(B, seed, shape, operand=None):
    return fused_admm.random_phase_inputs(np.random.default_rng(seed), B, *shape, operand=operand)


@pytest.mark.parametrize("B,shape", [(4, CONN), (6, CONN_LAMBDA2)])
def test_tc_loop_matches_twin(B, shape):
    """The kernel's products and order against the Woodbury twin of the shape,
    at the bar of two float32 loops."""
    arrays = [torch.from_numpy(a) for a in _inputs(B, B, shape)]
    out_m = tc_loop(*arrays, **KW)
    out_t = fused_admm.woodbury_iterations_ref(*arrays, **KW)
    for name, m, t in zip(("x", "zs", "zd", "ys", "yd"), out_m, out_t):
        assert m.shape == t.shape and m.dtype == torch.float32
        torch.testing.assert_close(m, t, rtol=2e-4, atol=2e-4, msg=lambda s: f"{name}: {s}")


@pytest.mark.parametrize("B,shape", [(4, CONN), (6, CONN_LAMBDA2)])
def test_tc_loop_matches_pallas_kernel(B, shape):
    """The same against the JAX package's kernel itself (interpret mode) on the
    same inputs."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.pallas_admm import structured_admm_iterations as pallas

    out_m = tc_loop(*map(torch.from_numpy, _inputs(B, B, shape)), **KW)
    out_p = pallas(*map(jnp.asarray, _inputs(B, B, shape, operand="wk")), interpret=True,
                   block=128, **KW)
    for name, m, p in zip(("x", "zs", "zd", "ys", "yd"), out_m, out_p):
        np.testing.assert_allclose(m.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CONN, CONN_LAMBDA2])
@pytest.mark.parametrize("B,iters", [(1001, 150), (3, 150), (33, 40)])
def test_connectivity_shapes_take_tiled_on_gpu(shape, B, iters):
    """The connectivity shapes still take the tiled kernel through the wrapper,
    and it agrees with the Woodbury twin at a ragged batch, fewer lanes than a
    block and a step's longest phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    K = fused_admm.structured_admm_iterations
    assert fused_admm.VARIANTS[fused_admm._lib().structured_admm_variant(*shape)] == "tiled"
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(B, 7, shape)]
    before = K.launches_by_variant["tiled"]
    out_k = K(*arrays, **dict(KW, iters=iters))
    out_t = fused_admm.woodbury_iterations_ref(*arrays, **dict(KW, iters=iters))
    torch.cuda.synchronize()
    assert K.launches_by_variant["tiled"] == before + 1
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
