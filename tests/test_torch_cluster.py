"""The ``cluster`` kernel of mpc_cbf_torch (csrc/structured_admm_cluster.cu:
one lane a thread-block cluster) where there is no card, and the slice at
the team sizes that take it.

``register_loop`` is the loop as the kernel's register layout computes it,
in plain PyTorch: xt = C RHS in float64 with the lane's C, the operand the
caller factors; the rows of [A_s; A_d] split over the cs blocks of the
cluster as the kernel splits them, each block's rows in contiguous strips
over its nw warps (``register_groups``); the column sums of [A_s; A_d]'r met
as the kernel meets them (each warp's strip, then the block's even and odd
warps each in order and the two sums, then the blocks' pushed partials in
rank order); [A_s; A_d] xt and
the row updates in float32 (the kernel meets a row's lane partials by a
butterfly of shuffles: an order within one float32 sum). ``stream_loop``
is the streamed layout's (rows read from device memory once an iteration):
the same loop with each block's rows in chunks of 4, those of A_s first,
chunk i to warp i % nw, the column sums of the next iteration formed in the
same pass as the row updates (the first from the initial state), and the
row and column sums and RHS met in float64. Both
are held against the twin and against the JAX package's Pallas kernel in
interpret mode, at shapes with n above 160 (the kernel's, past every
one-block layout) and at a 400-agent fov team's, to rtol = atol = 2e-4, the
bar of tests/test_pallas_admm.py:53-55 between two float32 loops that sum
in another order. The twin's, the Pallas kernel's and each model's outputs
are computed once a (lanes, shape, iterations, layout) and shared by the
tests that compare them (``_model_out``, ``_pallas_out``; read only). On the
card tests/test_torch_admm_kernel.py holds the kernel itself to the twin.

The slice test runs StructuredIMPC.optimize_batch of both packages on the
CPU through their plain loops on a ring of 85 fov agents, the first team
that takes the cluster kernel on the card, at the bars of
tests/test_torch_slice.py.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from mpc_cbf_torch.ops.qp import fused_admm
from mpc_cbf_torch.ops.qp.fused_admm import random_phase_inputs, structured_admm_iterations_ref

from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

KW = dict(iters=40, sigma=1e-6, alpha=1.6)
SOURCE = (pathlib.Path(fused_admm.__file__).resolve().parents[2] / "csrc"
          / "structured_admm_cluster.cu")


def cdiv(a, b):
    return -(-a // b)


def part_start(count, cs, k):
    """First row of part k of ``count`` rows split over cs blocks (the
    kernel's ``part_start``)."""
    return k * count // cs


def register_groups(m, cs, nw):
    """The rows of each warp of each block of the register layout: warp w of
    block k holds the strip [part_start(rows, nw, w), part_start(rows, nw, w +
    1)) of the block's rows (the kernel's ``sb`` and ``cnt``)."""
    groups = []
    for k in range(cs):
        rb, rows = part_start(m, cs, k), part_start(m, cs, k + 1) - part_start(m, cs, k)
        groups.append([torch.arange(rb + part_start(rows, nw, w), rb + part_start(rows, nw, w + 1))
                       for w in range(nw)])
    return groups


def stream_chunks(m, m_s, cs, rows_a_chunk=4):
    """The chunks of each block of the streamed layout: block k's rows of
    A_s, then its rows of A_d, each in chunks of 4."""
    out = []
    for k in range(cs):
        rb, re = part_start(m, cs, k), part_start(m, cs, k + 1)
        mid = min(max(m_s, rb), re)
        out.append([torch.arange(c, min(c + rows_a_chunk, e))
                    for b, e in ((rb, mid), (mid, re)) for c in range(b, e, rows_a_chunk)])
    return out


def stream_groups(m, m_s, cs, nw):
    """The rows of each warp of each block of the streamed layout: chunk i of
    a block goes to warp i % nw."""
    return [[torch.cat(chunks[w::nw]) if chunks[w::nw] else torch.arange(0) for w in range(nw)]
            for chunks in stream_chunks(m, m_s, cs)]


def _cluster_model(groups, Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, C,
                   x0, zs0, zd0, ys0, yd0, *, iters, sigma, alpha, sums=None, halves=False):
    """The loop of a cluster layout whose warps hold the rows ``groups``
    [block][warp] (module docstring); C [B, n, n] float64. ``sums``: the dtype
    the row and column sums and RHS accumulate in (None: the state's).
    ``halves``: a block meets its even warps and its odd warps each in order,
    then the two sums (the register layout); else all its warps in order."""
    dt, hi = qb.dtype, torch.float64
    acc = sums or dt
    B, n = qb.shape
    m_s = A_sb.shape[0]
    A = torch.cat([A_sb.expand(B, -1, -1), Ad], 1)                # [B, m, n]
    lo, up = torch.cat([lbs, lbd], 1), torch.cat([ubs, ubd], 1)
    rho = torch.cat([rho_s.expand(B, -1), rho_d], 1)
    x, z, y = x0, torch.cat([zs0, zd0], 1), torch.cat([ys0, yd0], 1)
    Aa = A.to(acc)
    for _ in range(iters):
        r = rho * z - y
        s = torch.zeros(B, n, dtype=acc)
        for warps in groups:                                      # the blocks in rank order
            parts = [torch.einsum("bij,bi->bj", Aa[:, rows], r[:, rows].to(acc)) for rows in warps]
            if halves:
                block = sum(parts[0::2], torch.zeros(B, n, dtype=acc)) + \
                    sum(parts[1::2], torch.zeros(B, n, dtype=acc))
            else:                                                 # the block's warps in order
                block = sum(parts, torch.zeros(B, n, dtype=acc))
            s = s + block
        RHS = (sigma * x - qb).to(acc) + s
        xt = torch.einsum("bij,bj->bi", C.to(hi), RHS.to(hi)).to(dt)
        zA = torch.einsum("bij,bj->bi", Aa, xt.to(acc)).to(dt)
        x = alpha * xt + (1 - alpha) * x
        zr = alpha * zA + (1 - alpha) * z
        zn = torch.clamp(zr + y / rho, lo, up)
        y = y + rho * (zr - zn)
        z = zn
    return x, z[:, :m_s], z[:, m_s:], y[:, :m_s], y[:, m_s:]


def register_loop(*args, iters, sigma, alpha, cs, nw):
    """The loop as the ``cluster`` kernel computes it with its rows in
    registers, cs blocks of nw warps a lane (module docstring)."""
    m = args[1].shape[0] + args[6].shape[1]
    return _cluster_model(register_groups(m, cs, nw), *args, iters=iters, sigma=sigma, alpha=alpha,
                          halves=True)


def stream_loop(*args, iters, sigma, alpha, cs, nw):
    """The loop as the ``cluster`` kernel computes it with its rows streamed
    from device memory, cs blocks of nw warps a lane (module docstring); its
    row and column sums and RHS meet in float64 (the kernel's partial sums of
    a lane's columns and of a chunk's rows stay float32: a rounding apart)."""
    m_s, m = args[1].shape[0], args[1].shape[0] + args[6].shape[1]
    return _cluster_model(stream_groups(m, m_s, cs, nw), *args, iters=iters, sigma=sigma,
                          alpha=alpha, sums=torch.float64)


def source_layouts():
    """(kLayouts, RegShapes) as csrc/structured_admm_cluster.cu writes them:
    [(blocks, registers, warps)] in the order tried, and the register layout's
    instances [(warps, rows a strip, column slots, one SM)] in the order
    tried."""
    text = SOURCE.read_text()
    def statement(head):
        start = text.index(head)
        return text[start:text.index(";", start)]
    layouts = [(int(cs), reg == "true", int(nw)) for cs, reg, nw in re.findall(
        r"\{(\d+), (true|false), (\d+)\}", statement("constexpr ClusterChoice kLayouts"))]
    shapes = [(int(a), int(b), int(c), d == "true") for a, b, c, d in re.findall(
        r"RegShape<(\d+), (\d+), (\d+)(?:, (true|false))?>", statement("using RegShapes"))]
    return layouts, shapes


def min_blocks(nw, one_sm):
    """Blocks an SM the launch bounds of an instance ask for (the kernel's
    ``reg_min_blocks``): one where a lane spans a cluster, else 16 warps an SM."""
    return max(1, 16 // nw) if one_sm else 1


def layout_holds(n, m, cs, nw, shapes):
    """The first instance (warps, rows a strip, column slots, one SM) that
    holds the shape in the register layout of cs blocks of nw warps, where its
    shared memory fits (on one SM, cs = 1, for as many blocks as the launch
    bounds keep there), or None (the kernel's ``holds`` and ``reg_holds``)."""
    size = register_bytes(n, m, cs, nw)
    if size > 232448 or min_blocks(nw, cs == 1) * (size + 1024) > 233472:
        return None
    return next((s for s in shapes if s[0] == nw and s[3] == (cs == 1) and cdiv(n, 32) <= s[2]
                 and cdiv(cdiv(m, cs), nw) <= s[1]), None)


def register_bytes(n, m, cs, nw):
    """The shared memory of a block of the register layout (the kernel's
    ``RegLayout``)."""
    rows, crows, p = cdiv(m, cs), cdiv(n, cs), 8   # p: the kernel's kP threads a row of C
    round_up = lambda a, b: cdiv(a, b) * b
    nv, ldc = round_up(n, 4), round_up(n + p, 2 * p) - p
    rhs = round_up(8 * crows * ldc, 16)
    end = rhs + 4 * (4 * nv + cs * nv + nw * nv + nw * round_up(cdiv(rows, nw), 4)
                     + 5 * round_up(rows, 4))
    return round_up(end, 16)


def register_layout(n, m_s, m_d):
    """(blocks, warps, (warps, rows a strip, column slots, one SM)) of the
    register layout that runs the shape (the first of kLayouts that holds
    it, then the first instance that holds it), or None where the shape is
    streamed."""
    m = m_s + m_d
    layouts, shapes = source_layouts()
    for cs, registers, nw in layouts:
        if not registers:
            return None
        shape = layout_holds(n, m, cs, nw, shapes)
        if shape is not None:
            return cs, nw, shape
    return None


def kernel_warps(shape, cs):
    """The warps the kernel gives a block of cs blocks at this shape: those of
    the first register layout of that many blocks that holds it."""
    n, m = shape[0], shape[1] + shape[2]
    layouts, shapes = source_layouts()
    return next(nw for c, registers, nw in layouts if registers and c == cs
                and layout_holds(n, m, c, nw, shapes) is not None)


# connectivity teams of 30, 32 (conn32) and 33 robots, the teams whose lane
# fits one SM
CONN30, CONN32, CONN33 = (65, 155, 58), (67, 157, 62), (68, 158, 64)
# (lanes, shape, blocks a lane, iterations): a 128-robot connectivity team (on 4
# blocks of 16 warps, and on the 2 blocks of 8 warps the kernel gives it) and a
# synthetic shape with few rows at the cluster sizes the kernel gives them (at 8
# blocks some strips of 16 warps hold no row); a 128-agent fov team (163, 247,
# 1524) and a 140-agent one (175, 259, 1668: 8 blocks of 8 warps) on one lane for
# a short phase; the connectivity teams of 30, 32 and 33 robots on one SM (one
# block of 8 warps) and conn32 on the 2 blocks of 16 warps it took before. Each
# on the warps the kernel gives it at that many blocks
CASES = [(2, (163, 253, 254), 4, 40), (3, (170, 20, 12), 2, 40), (2, (170, 20, 12), 8, 40),
         (1, fused_admm.fov_team_shape(128), 8, 8), (2, (163, 253, 254), 2, 40),
         (1, fused_admm.fov_team_shape(140), 8, 8), (3, CONN30, 1, 40), (2, CONN32, 1, 40),
         (2, CONN33, 1, 40), (2, CONN32, 2, 40)]
# (lanes, shape, blocks, warps a block, iterations) of the streamed layout: a
# 256-robot connectivity team (its rows straddle A_s's last row inside a
# block), a 400-agent fov team (435, 519, 4788) on one lane for a short phase,
# synthetic shapes with fewer rows than warps in some blocks, and a 160-agent
# fov team (195, 279, 1908); the fov teams on the 4 warps the kernel gives them
STREAM_CASES = [(2, (291, 381, 510), 8, 8, 40), (1, fused_admm.fov_team_shape(400), 8, 4, 6),
                (2, (180, 30, 9), 8, 8, 40), (2, (200, 21, 40), 4, 4, 40),
                (2, fused_admm.fov_team_shape(160), 8, 4, 10)]


@functools.lru_cache(maxsize=None)
def _inputs(B, shape, operand=None):
    return random_phase_inputs(np.random.default_rng(B), B, *shape, operand=operand)


@functools.lru_cache(maxsize=None)
def _model_out(loop, B, shape, iters, **layout):
    """``loop`` (the twin or a layout model, with its ``layout``: cs, nw) on
    ``_inputs(B, shape)`` (seed B, the shape's operand) for ``iters``
    iterations, computed once for the tests that share it: inference
    tensors, which refuse an in-place write."""
    with torch.inference_mode():
        return loop(*[torch.from_numpy(a) for a in _inputs(B, shape)], **dict(KW, iters=iters),
                    **layout)


@functools.lru_cache(maxsize=None)
def _pallas_out(B, shape, iters):
    """The JAX package's Pallas kernel in interpret mode on WK of the same
    draw, as read-only numpy arrays (cached)."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.pallas_admm import structured_admm_iterations as pallas
    out = tuple(np.array(o) for o in pallas(*[jnp.asarray(a) for a in _inputs(B, shape, "wk")],
                                            interpret=True, block=128, **dict(KW, iters=iters)))
    for o in out:
        o.flags.writeable = False
    return out


@pytest.mark.parametrize("B,shape,cs,iters", CASES)
def test_cluster_loop_matches_twin(B, shape, cs, iters):
    """The cluster kernel's register layout against the twin, at the bar of
    two float32 loops (they differ by the order of the column and row sums)."""
    out_c = _model_out(register_loop, B, shape, iters, cs=cs, nw=kernel_warps(shape, cs))
    out_t = _model_out(structured_admm_iterations_ref, B, shape, iters)
    for name, c, t in zip(("x", "zs", "zd", "ys", "yd"), out_c, out_t):
        assert c.shape == t.shape and c.dtype == torch.float32
        torch.testing.assert_close(c, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape,cs,iters", CASES)
def test_cluster_loop_matches_pallas_kernel(B, shape, cs, iters):
    """The cluster kernel's register layout against the JAX package's kernel
    itself (interpret mode, with the Woodbury WK of the same draw) on the same
    inputs, at the bar the twin is held to."""
    out_c = _model_out(register_loop, B, shape, iters, cs=cs, nw=kernel_warps(shape, cs))
    out_p = _pallas_out(B, shape, iters)
    for name, c, p in zip(("x", "zs", "zd", "ys", "yd"), out_c, out_p):
        np.testing.assert_allclose(c.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("B,shape,cs,nw,iters", STREAM_CASES)
def test_stream_loop_matches_twin(B, shape, cs, nw, iters):
    """The streamed layout's one-pass loop against the twin, at the bar of two
    float32 loops."""
    out_s = _model_out(stream_loop, B, shape, iters, cs=cs, nw=nw)
    out_t = _model_out(structured_admm_iterations_ref, B, shape, iters)
    for name, s, t in zip(("x", "zs", "zd", "ys", "yd"), out_s, out_t):
        assert s.shape == t.shape and s.dtype == torch.float32
        torch.testing.assert_close(s, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape,cs,nw,iters", STREAM_CASES[:1] + STREAM_CASES[2:])
def test_stream_loop_matches_pallas_kernel(B, shape, cs, nw, iters):
    """The streamed layout's loop against the JAX package's kernel (interpret
    mode, WK of the same draw), at the bar the twin is held to. (The
    400-agent lane is held to the twin only: its Woodbury WK is an inverse
    of [4788, 4788].)"""
    out_s = _model_out(stream_loop, B, shape, iters, cs=cs, nw=nw)
    out_p = _pallas_out(B, shape, iters)
    for name, s, p in zip(("x", "zs", "zd", "ys", "yd"), out_s, out_p):
        np.testing.assert_allclose(s.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("m,cs", [(1771, 8), (507, 4), (32, 2), (3435, 4), (163, 8)])
def test_the_blocks_split_the_rows(m, cs):
    """The blocks' parts cover the rows once, in order, and differ by at most
    one row."""
    starts = [part_start(m, cs, k) for k in range(cs + 1)]
    sizes = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == m
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("m,cs,nw", [(1771, 8, 16), (2005, 8, 16), (891, 8, 16), (627, 2, 16),
                                    (939, 4, 16), (32, 8, 16), (1771, 8, 8)])
def test_the_register_strips_take_every_row_once(m, cs, nw):
    """The register layout's strips cover the rows once, in order, each within
    the block's rows, none longer than the longest a block's warps get."""
    groups = register_groups(m, cs, nw)
    assert torch.equal(torch.cat([w for warps in groups for w in warps]), torch.arange(m))
    for k, warps in enumerate(groups):
        rows = torch.cat(warps)
        assert rows.numel() == 0 or (rows.min() >= part_start(m, cs, k)
                                     and rows.max() < part_start(m, cs, k + 1))
        assert max(len(w) for w in warps) <= cdiv(cdiv(m, cs), nw)


TEAMS = ([("fov", A, fused_admm.fov_team_shape(A)) for A in range(30, 147) if A != 32]
         + [("connectivity", R, (35 + R, 125 + R, 2 * R - 2)) for R in range(30, 258)])


def test_the_register_layout_holds_every_on_chip_team():
    """Every fov team of 30-146 agents (but 32, the folded kernel's) and every
    connectivity team of 30-257 robots, the teams whose rows sat on chip
    before, takes the register layout: the fewest blocks (1, 2, 4, 8) whose
    strips fit an instance, whose strips take every row once, whose rows fit
    the registers (RW x TC under the registers a thread may have: 255 at 8
    warps an SM, 128 at 16; a block's rows under an SM's 65 536) and whose
    shared memory fits a block (on one SM, as many blocks as its launch bounds
    keep there). ptxas's report of no spill is held on the card
    (chip_smoke.py)."""
    layouts, shapes = source_layouts()
    for family, size, (n, m_s, m_d) in TEAMS:
        got = register_layout(n, m_s, m_d)
        assert got is not None, f"{family} {size} {(n, m_s, m_d)} is streamed"
        cs, nw, (NW, RW, TC, one_sm) = got
        m = m_s + m_d
        assert NW == nw and one_sm == (cs == 1) and cdiv(n, 32) <= TC
        assert cdiv(cdiv(m, cs), nw) <= RW
        warps_an_sm = nw * min_blocks(nw, one_sm)
        assert RW * TC < min(255, 65536 // (32 * warps_an_sm))
        assert cdiv(m, cs) * 32 * TC <= 65536 and register_bytes(n, m, cs, nw) <= 232448
        fewer = [c for c, registers, w in layouts if registers and c < cs
                 and layout_holds(n, m, c, w, shapes) is not None]
        assert not fewer, f"{family} {size}: {fewer} blocks would hold it"
        rows = torch.cat([w for warps in register_groups(m, cs, nw) for w in warps])
        assert torch.equal(rows, torch.arange(m))


def test_the_lanes_that_fit_one_sm_take_it():
    """The register layout on one SM (one lane a block of 8 warps, two blocks
    an SM, no cluster) takes exactly the connectivity teams of 30-33 robots
    among the teams of 2-512 agents or robots that cluster runs (conn32's
    among them; the fov teams from 30 agents have 497 rows or more, past an
    8-warp strip of 28), with its two blocks' shared memory within an SM."""
    teams = ([("fov", A, fused_admm.fov_team_shape(A)) for A in range(30, 513) if A != 32]
             + [("connectivity", R, (35 + R, 125 + R, 2 * R - 2)) for R in range(30, 513)])
    one_sm = [(family, size) for family, size, s in teams
              if (register_layout(*s) or (0,))[0] == 1]
    assert one_sm == [("connectivity", R) for R in range(30, 34)]
    assert register_layout(*CONN32) == (1, 8, (8, 28, 3, True))
    assert register_layout(35 + 34, 125 + 34, 66) == (2, 16, (16, 20, 3, False))
    assert 2 * (register_bytes(67, 219, 1, 8) + 1024) <= 233472


@pytest.mark.parametrize("m,m_s,cs,nw", [(891, 381, 8, 8), (5307, 519, 8, 8), (39, 30, 8, 8)])
def test_the_streamed_warps_take_every_row_once(m, m_s, cs, nw):
    """The streamed layout's chunks cover the rows once, none straddles A_s's
    last row, and the warps of a block take them all."""
    chunks = [c for block in stream_chunks(m, m_s, cs) for c in block]
    assert torch.equal(torch.cat(chunks), torch.arange(m))
    assert all(len(c) <= 4 and ((c < m_s).all() or (c >= m_s).all()) for c in chunks)
    rows = torch.cat([w for warps in stream_groups(m, m_s, cs, nw) for w in warps])
    assert torch.equal(rows.sort().values, torch.arange(m))


RING = 85          # the first fov team past generic's largest layout


def _ring_inputs(A, lanes):
    """benchmarks/swarm.py's fov ring of A agents (:76-104; neighbours masked
    to the 5.5 m sensing range), numpy seed 0, for the first ``lanes`` agents:
    every lane has the whole team's A - 1 neighbours, so a lane's QP has the
    team's shape (35 + A, 119 + A, 12 (A - 1)) whatever the number of lanes."""
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(A) / A
    R = max(4.0, A * 1.2 / (2 * np.pi) * 2)
    base = np.stack([R * np.cos(ang), R * np.sin(ang), np.zeros(A)], -1)
    pos = base + rng.normal(0, 0.05, (A, 3))
    others = np.stack([np.delete(np.arange(A), i) for i in range(A)])
    cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (A, A - 1, 3))
    blob = np.concatenate([pos[others, :2], cov], -1)
    mask = np.linalg.norm(pos[:, None, :2] - blob[..., :2], axis=-1) < 5.5
    ref = np.tile(np.roll(base, -1, axis=0), (1, 16))
    return [a[:lanes] for a in (pos, np.zeros_like(pos), ref, blob, mask)]


def test_optimize_batch_matches_jax_on_a_ring_of_85_fov_agents():
    """The port's StructuredIMPC against the JAX package's on the CPU, both
    through their plain loops, on two agents of an 85-agent fov ring: (120,
    204, 1008), the first fov team whose lane takes the cluster kernel on the
    card. Float64 with the JAX operator's constants carried over and bars as
    in tests/test_torch_slice.py (coefficients to rtol = atol = 2e-4, pri_res
    to rtol 5e-2 / atol 5e-3, usable flags equal). Shortened to keep the test
    within seconds: StructuredConfig(iters=60) (the swarm's 600 + tail 200
    would run the same code for longer) and two lanes (a lane's QP is the
    team's whatever the lanes; the full ring took 80 s)."""
    import jax
    from mpc_cbf_tpu.types import State as JState
    from mpc_cbf_tpu.controllers import StructuredIMPC as JStructuredIMPC
    from mpc_cbf_tpu.ops.qp.structured import StructuredConfig as JStructuredConfig
    from mpc_cbf_torch.controllers import StructuredIMPC
    from mpc_cbf_torch.ops.qp.structured import StructuredConfig
    from mpc_cbf_torch.utils import convert
    import torch_parity_cases as cases
    from test_torch_slice import _assert_results_match, _jax_constants

    pos, vel, ref, blob, mask = _ring_inputs(RING, 2)
    floats = [np.asarray(a, np.float64) for a in (pos, vel, ref, blob)]
    jctrl = _ring_controller(cases, "jax")
    simpc_j = JStructuredIMPC(jctrl, JStructuredConfig(iters=60, use_pallas=False))
    res_j = jax.jit(lambda p, v, r, b, m: simpc_j.optimize_batch(JState(pos=p, vel=v), r, b, m))(
        *floats, mask)

    ctrl = _ring_controller(cases, "torch")
    assert (ctrl.n, ctrl.m_dynamic) == fused_admm.fov_team_shape(RING)[::2]
    simpc = StructuredIMPC(ctrl, StructuredConfig(iters=60))
    convert.set_structured_constants(simpc.op_qp, **_jax_constants(simpc_j.op_qp))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    res_t = simpc.optimize_batch(
        convert.state_from_numpy(floats[0], floats[1], device="cpu", dtype=torch.float64),
        t(floats[2]), t(floats[3]), torch.as_tensor(mask))
    assert res_t.coeffs.shape == (2, 36)
    _assert_results_match(res_t, res_j)


def _ring_controller(cases, package):
    """The fov controller of benchmarks/swarm.py (:44-55) for a ring of RING
    agents, in either package (float64)."""
    if package == "jax":
        import jax.numpy as jnp
        from mpc_cbf_tpu.ops.cbf import FovCBF
        from mpc_cbf_tpu.controllers import (BezierParams, MPCParams, BezierMPCOperator,
                                             IMPCParams, FovIMPCCBF)
        mpc = MPCParams()
        op = BezierMPCOperator(BezierParams(), mpc, dim=3)
        cbf = FovCBF(cases.FOV_BETA, 0.3, 6.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
    else:
        from mpc_cbf_torch.ops.cbf import FovCBF
        from mpc_cbf_torch.controllers import (BezierParams, MPCParams, BezierMPCOperator,
                                               IMPCParams, FovIMPCCBF)
        mpc = MPCParams()
        op = BezierMPCOperator(BezierParams(), mpc, dim=3, device="cpu", dtype=torch.float64)
        cbf = FovCBF(cases.FOV_BETA, 0.3, 6.0, mpc.v_min, mpc.v_max)
    return FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), RING - 1, box_half_extents=cases.BOX)
