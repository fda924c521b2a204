"""The ``cluster`` kernel of mpc_cbf_torch (csrc/structured_admm_cluster.cu:
one lane a thread-block cluster) where there is no card, and the slice at
the team sizes that take it.

``cluster_loop`` is the loop as the kernel computes it, in plain PyTorch:
the lane's float64 C = Ms_inv - (WK A_d) Ms_inv, WK A_d summed 64 rows of A_d
at a time as the prologue stages them where it has the room; the rows of [A_s; A_d] split over the
cs blocks of the cluster as the kernel splits them, each block's rows in
chunks of 32 over its warps; the column sums of [A_s; A_d]'r met as the
kernel meets them (each warp's chunks, then the block's warps in order, then
the blocks in rank order); xt = C RHS in float64; [A_s; A_d] xt and the row
updates in float32. It is held against the twin and against the JAX
package's Pallas kernel in interpret mode at shapes with n above 160 (the
kernel's, past every one-block layout) to rtol = atol = 2e-4, the bar of
tests/test_pallas_admm.py:53-55 between two float32 loops that sum in
another order. On the card tests/test_torch_admm_kernel.py holds the kernel
itself to the twin.

The slice test runs StructuredIMPC.optimize_batch of both packages on the
CPU through their plain loops on a ring of 85 fov agents, the first team
that takes the cluster kernel on the card, at the bars of
tests/test_torch_slice.py.
"""

import functools

import numpy as np
import pytest
import torch

from mpc_cbf_torch.ops.qp import fused_admm
from mpc_cbf_torch.ops.qp.fused_admm import random_phase_inputs, structured_admm_iterations_ref

from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

KW = dict(iters=40, sigma=1e-6, alpha=1.6)
KC = 64                                   # rows of A_d the prologue stages at a time


def part_start(count, cs, k):
    """First row of part k of ``count`` rows split over cs blocks (the
    kernel's ``part_start``)."""
    return k * count // cs


def block_warps(m, cs):
    """Warps a block of the cluster kernel: one a chunk of 32 of the most rows
    a block holds, 4 to 16."""
    rows = -(-m // cs)
    return min(16, max(4, -(-rows // 32)))


def cluster_loop(Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
                 x0, zs0, zd0, ys0, yd0, *, iters, sigma, alpha, cs):
    """The loop as the ``cluster`` kernel computes it with cs blocks a lane
    (module docstring)."""
    dt, hi = qb.dtype, torch.float64
    B, n = qb.shape
    m_s, m_d = A_sb.shape[0], Ad.shape[1]
    m = m_s + m_d
    Mi = Ms_inv.to(hi)
    H = torch.zeros(B, n, n, dtype=hi)
    for k0 in range(0, m_d, KC):
        H = H + WK[:, :, k0:k0 + KC].to(hi) @ Ad[:, k0:k0 + KC].to(hi)
    C = Mi - H @ Mi                                               # [B, n, n]
    A = torch.cat([A_sb.expand(B, -1, -1), Ad], 1)                # [B, m, n]
    nw = block_warps(m, cs)
    # the rows of each warp of each block: chunk ch of block k's rows goes to warp ch % nw
    groups = []
    for k in range(cs):
        rb, re = part_start(m, cs, k), part_start(m, cs, k + 1)
        chunks = [torch.arange(c, min(c + 32, re)) for c in range(rb, re, 32)]
        groups.append([torch.cat(chunks[w::nw]) if chunks[w::nw] else torch.arange(0)
                       for w in range(nw)])
    lo, up = torch.cat([lbs, lbd], 1), torch.cat([ubs, ubd], 1)
    rho = torch.cat([rho_s.expand(B, -1), rho_d], 1)
    x, z, y = x0, torch.cat([zs0, zd0], 1), torch.cat([ys0, yd0], 1)
    for _ in range(iters):
        r = rho * z - y
        s = torch.zeros(B, n, dtype=dt)
        for warps in groups:                                      # the blocks in rank order
            block = torch.zeros(B, n, dtype=dt)
            for rows in warps:                                    # the block's warps in order
                block = block + torch.einsum("bij,bi->bj", A[:, rows], r[:, rows])
            s = s + block
        RHS = sigma * x - qb + s
        xt = torch.einsum("bij,bj->bi", C, RHS.to(hi)).to(dt)
        zA = torch.einsum("bij,bj->bi", A, xt)
        x = alpha * xt + (1 - alpha) * x
        zr = alpha * zA + (1 - alpha) * z
        zn = torch.clamp(zr + y / rho, lo, up)
        y = y + rho * (zr - zn)
        z = zn
    return x, z[:, :m_s], z[:, m_s:], y[:, :m_s], y[:, m_s:]


# (lanes, shape, blocks a lane, iterations): a 128-robot connectivity team and a
# synthetic shape with few rows at the cluster sizes the kernel gives them; a
# 128-agent fov team (163, 247, 1524) on one lane for a short phase
CASES = [(2, (163, 253, 254), 4, 40), (3, (170, 20, 12), 2, 40), (2, (170, 20, 12), 8, 40),
         (1, fused_admm.fov_team_shape(128), 8, 8)]


@functools.lru_cache(maxsize=None)
def _inputs(B, shape):
    return random_phase_inputs(np.random.default_rng(B), B, *shape)


@pytest.mark.parametrize("B,shape,cs,iters", CASES)
def test_cluster_loop_matches_twin(B, shape, cs, iters):
    """The cluster kernel's loop against the twin, at the bar of two float32
    loops (they differ by the float32 rounding of S and Ad S that the folded
    form skips, and by the order of the column sums)."""
    arrays = [torch.from_numpy(a) for a in _inputs(B, shape)]
    kw = dict(KW, iters=iters)
    out_c = cluster_loop(*arrays, **kw, cs=cs)
    out_t = structured_admm_iterations_ref(*arrays, **kw)
    for name, c, t in zip(("x", "zs", "zd", "ys", "yd"), out_c, out_t):
        assert c.shape == t.shape and c.dtype == torch.float32
        torch.testing.assert_close(c, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape,cs,iters", CASES)
def test_cluster_loop_matches_pallas_kernel(B, shape, cs, iters):
    """The cluster kernel's loop against the JAX package's kernel itself
    (interpret mode) on the same inputs, at the bar the twin is held to."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.pallas_admm import structured_admm_iterations as pallas
    arrays = _inputs(B, shape)
    kw = dict(KW, iters=iters)
    out_c = cluster_loop(*[torch.from_numpy(a) for a in arrays], **kw, cs=cs)
    out_p = pallas(*[jnp.asarray(a) for a in arrays], interpret=True, block=128, **kw)
    for name, c, p in zip(("x", "zs", "zd", "ys", "yd"), out_c, out_p):
        np.testing.assert_allclose(c.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("m,cs", [(1771, 8), (507, 4), (32, 2), (3435, 4), (163, 8)])
def test_the_blocks_split_the_rows(m, cs):
    """The blocks' parts cover the rows once, in order, and differ by at most
    one row."""
    starts = [part_start(m, cs, k) for k in range(cs + 1)]
    sizes = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == m
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1


class _Lib:
    """A kernel library whose kernels hold n <= n_max."""

    def __init__(self, n_max):
        self.n_max = n_max

    def structured_admm_variant(self, n, m_s, m_d):
        return 3 if n <= self.n_max else -1


@pytest.mark.parametrize("n_max,team", [(416, 381), (120, 85), (37, 2)])
def test_largest_fov_team_is_where_the_kernels_stop(n_max, team):
    """largest_fov_team walks the fov family (35 + A, 119 + A, 12 (A - 1))
    to the last team the library's kernels hold (the raise names it)."""
    assert fused_admm.largest_fov_team(_Lib(n_max)) == team
    assert fused_admm.fov_team_shape(team)[0] <= n_max < fused_admm.fov_team_shape(team + 1)[0]


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
