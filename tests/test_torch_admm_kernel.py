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
another order. The folded form of the loop (the algebra of the ``folded``
kernel) and the generic kernel's three stages (``generic_loop``) are held to
the twin and to the Pallas kernel at the same bar (the ``cluster`` kernel's
loop: tests/test_torch_cluster.py). On the card every kernel variant (tiled,
folded, generic, cluster) is held to it too.

The cases marked ``cuda`` import no JAX, so that they also run where the
GPU is and JAX is not (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_admm_kernel.py
"""

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
# fov teams of 40 and 64 agents (35 + N, 119 + N, 12 (N - 1)) and a 40-robot
# connectivity team (35 + R, 125 + R, 2 R - 2): the generic kernel reads their
# rows from device memory
TEAM40_FOV, TEAM64_FOV, TEAM40_CONN = (75, 159, 468), (99, 183, 756), (75, 165, 78)
# lanes larger than one SM (the cluster kernel): fov teams of 85, 96, 128 and
# 256 agents, connectivity teams of 128 and 256 robots
TEAM85_FOV, TEAM96_FOV = fused_admm.fov_team_shape(85), fused_admm.fov_team_shape(96)
TEAM128_FOV, TEAM256_FOV = fused_admm.fov_team_shape(128), fused_admm.fov_team_shape(256)
TEAM128_CONN, TEAM256_CONN = (163, 253, 254), (291, 381, 510)
KW = dict(iters=40, sigma=1e-6, alpha=1.6)


def _inputs(B, seed, shape=FOV):
    return random_phase_inputs(np.random.default_rng(seed), B, *shape)


@pytest.mark.parametrize("B,shape", [(5, FOV), (3, FOV), (4, CONN), (3, SWARM_CONN),
                                     (6, CONN_LAMBDA2), (2, SWARM_FOV), (3, RUN_SIM_CONN),
                                     (4, SWEEP_R2), (3, SWEEP_R10), (2, TEAM24_FOV)])
def test_twin_matches_pallas_kernel(B, shape):
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.pallas_admm import structured_admm_iterations as pallas

    arrays = _inputs(B, seed=B, shape=shape)
    out_t = structured_admm_iterations_ref(*map(torch.from_numpy, arrays), **KW)
    out_j = pallas(*map(jnp.asarray, arrays), **KW, block=128, interpret=True)
    for name, t, j in zip(("x", "zs", "zd", "ys", "yd"), out_t, out_j):
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def folded_loop(Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
                x0, zs0, zd0, ys0, yd0, *, iters, sigma, alpha):
    """The loop as the ``folded`` kernel computes it, in plain PyTorch: the
    twin's update order with the Woodbury solve S - WK (Ad S), S = Ms_inv
    RHS, as one product xt = C RHS with the lane's float64
    C = (I - WK Ad) Ms_inv [B, n, n], built once a phase. The same algebra,
    without the float32 rounding of S and Ad S. It pins the algebra of the
    kernel where there is no card."""
    dt, hi = qb.dtype, torch.float64
    Ms_inv_hi = Ms_inv.to(hi)
    C = Ms_inv_hi - (WK.to(hi) @ Ad.to(hi)) @ Ms_inv_hi          # [B, n, n]
    x, zs, zd, ys, yd = x0, zs0, zd0, ys0, yd0
    for _ in range(iters):
        rs = rho_s * zs - ys
        rd = rho_d * zd - yd
        RHS = sigma * x - qb + rs @ A_sb + torch.einsum("bdj,bd->bj", Ad, rd)
        xt = torch.einsum("bij,bj->bi", C, RHS.to(hi)).to(dt)
        zAs = xt @ A_sb.T
        zAd = torch.einsum("bdj,bj->bd", Ad, xt)
        x_new = alpha * xt + (1 - alpha) * x
        zs_h = alpha * zAs + (1 - alpha) * zs + ys / rho_s
        zd_h = alpha * zAd + (1 - alpha) * zd + yd / rho_d
        zs_new = torch.clamp(zs_h, lbs, ubs)
        zd_new = torch.clamp(zd_h, lbd, ubd)
        ys = ys + rho_s * (alpha * zAs + (1 - alpha) * zs - zs_new)
        yd = yd + rho_d * (alpha * zAd + (1 - alpha) * zd - zd_new)
        x, zs, zd = x_new, zs_new, zd_new
    return x, zs, zd, ys, yd


FOLDED_CASES = [(5, FOV), (4, CONN), (3, SWARM_CONN), (6, CONN_LAMBDA2), (2, SWARM_FOV)]


@pytest.mark.parametrize("B,shape", FOLDED_CASES)
def test_folded_loop_matches_twin(B, shape):
    """xt = C RHS with the lane's float64 C = (I - WK Ad) Ms_inv is the
    twin's S - WK (Ad S): the algebra of the folded kernel, held to the bar of
    two float32 loops (it differs from the twin by the float32 rounding of S
    and Ad S that it skips)."""
    arrays = [torch.from_numpy(a) for a in _inputs(B, seed=B, shape=shape)]
    out_f = folded_loop(*arrays, **KW)
    out_t = structured_admm_iterations_ref(*arrays, **KW)
    for name, f, t in zip(("x", "zs", "zd", "ys", "yd"), out_f, out_t):
        assert f.shape == t.shape and f.dtype == torch.float32
        torch.testing.assert_close(f, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape", FOLDED_CASES)
def test_folded_loop_matches_pallas_kernel(B, shape):
    """The folded algebra against the JAX package's kernel itself (interpret
    mode) on the same inputs, at the bar the twin is held to."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.pallas_admm import structured_admm_iterations as pallas
    arrays = _inputs(B, seed=B, shape=shape)
    out_f = folded_loop(*[torch.from_numpy(a) for a in arrays], **KW)
    out_p = pallas(*[jnp.asarray(a) for a in arrays], interpret=True, block=128, **KW)
    for name, f, p in zip(("x", "zs", "zd", "ys", "yd"), out_f, out_p):
        np.testing.assert_allclose(f.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


def generic_warps(n, m, rows_a_warp=32, threads_a_row=4):
    """Warps of a block of the generic kernel (csrc/structured_admm_generic.cu,
    ``generic_warps``): enough for the rows, 32 a warp, and for four threads
    on each row of C, at most 8 at the RegN64 line (n <= 64, m <= 256) and
    16 at RegN64Tall and FromMemory."""
    max_warps = 8 if n <= 64 and m <= 256 else 16
    return min(max_warps, max(-(-m // rows_a_warp), -(-threads_a_row * n // 32)))


def generic_loop(Ms_inv, A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d, WK,
                 x0, zs0, zd0, ys0, yd0, *, iters, sigma, alpha):
    """The loop as the ``generic`` kernel computes it, in plain PyTorch: the
    lane's float64 C = Ms_inv - WK (Ad Ms_inv) built once a phase, 32 rows of
    Ad at a time as the kernel's prologue sums it, then the
    kernel's stages an iteration. 1: the rows of [A_s; A_d] split into the
    kernel's warps, each warp's column sums of r over its rows; 2: RHS =
    sigma x - q + the warps' partial sums, in the warps' order; 3: xt = C RHS
    in float64; 4: the rows of [A_s; A_d] xt and the row updates. It pins the
    kernel's algebra and its order of summation across warps where there is
    no card."""
    dt, hi = qb.dtype, torch.float64
    B, n = qb.shape
    m_s = A_sb.shape[0]
    Ms_inv_hi = Ms_inv.to(hi)
    C = Ms_inv_hi.expand(B, -1, -1)                               # [B, n, n]
    for k0 in range(0, Ad.shape[1], 32):
        C = C - WK[:, :, k0:k0 + 32].to(hi) @ (Ad[:, k0:k0 + 32].to(hi) @ Ms_inv_hi)
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
                                (2, TEAM24_FOV), (2, TEAM40_CONN)]


@pytest.mark.parametrize("B,shape", GENERIC_CASES)
def test_generic_loop_matches_twin(B, shape):
    """The generic kernel's three stages against the twin, at the bar of two
    float32 loops (they differ by the float32 rounding of S and Ad S that the
    folded form skips, and by the order of the column sums)."""
    arrays = [torch.from_numpy(a) for a in _inputs(B, seed=B, shape=shape)]
    out_g = generic_loop(*arrays, **KW)
    out_t = structured_admm_iterations_ref(*arrays, **KW)
    for name, g, t in zip(("x", "zs", "zd", "ys", "yd"), out_g, out_t):
        assert g.shape == t.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, t, rtol=2e-4, atol=2e-4, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,shape", GENERIC_CASES)
def test_generic_loop_matches_pallas_kernel(B, shape):
    """The generic kernel's algebra against the JAX package's kernel itself
    (interpret mode) on the same inputs, at the bar the twin is held to."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.pallas_admm import structured_admm_iterations as pallas
    arrays = _inputs(B, seed=B, shape=shape)
    out_g = generic_loop(*[torch.from_numpy(a) for a in arrays], **KW)
    out_p = pallas(*[jnp.asarray(a) for a in arrays], interpret=True, block=128, **KW)
    for name, g, p in zip(("x", "zs", "zd", "ys", "yd"), out_g, out_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4, err_msg=name)


def test_variants_follow_the_kernel_enum():
    """VARIANTS is indexed by the code structured_admm_variant returns: the
    AdmmVariant enum of csrc/structured_admm.cuh, read from the source."""
    import re
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
    (FOV, 1001, "tiled"),            # a ragged last block
    (FOV, 3, "tiled"),               # fewer lanes than a block holds
    (CONN, 1001, "tiled"),
    (CONN, 3, "tiled"),
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
    (TEAM40_FOV, 16, "generic"),     # rows from device memory (FromMemory)
    (TEAM64_FOV, 8, "generic"),
    (TEAM40_CONN, 16, "generic"),
    ((162, 2, 2), 3, "cluster"),     # n above every generic layout: a lane on several SMs
    ((165, 4, 4), 3, "cluster"),
    (TEAM85_FOV, 3, "cluster"),      # the first fov team past FromMemory: rows on chip
    (TEAM96_FOV, 3, "cluster"),
    (TEAM128_FOV, 2, "cluster"),
    (TEAM256_FOV, 2, "cluster"),     # rows read from device memory
    (TEAM128_CONN, 9, "cluster"),
    (TEAM256_CONN, 3, "cluster"),
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
@pytest.mark.parametrize("variant,shape,B", [("generic", FOV, 100), ("generic", SWARM_CONN, 64),
                                             ("generic", SWARM_FOV, 16),   # A_d from memory
                                             ("cluster", FOV, 100), ("cluster", SWARM_CONN, 64),
                                             ("cluster", SWARM_FOV, 16),
                                             ("cluster", RUN_SIM_CONN, 3),
                                             ("cluster", TEAM64_FOV, 8)])
def test_generic_kernels_take_the_fov_shapes_on_gpu(variant, shape, B):
    """The kernels that take runtime shapes, launched by name against the
    twin at shapes the wrapper gives to another kernel: generic at the fov
    shapes and the 32-agent shapes (the 32-agent fov lane exceeds the
    registers and reads A_d from device memory), cluster at those and at
    run_sim's 3-robot team and the 64-agent fov team (generic's FromMemory
    runs it through the wrapper)."""
    _need_gpu()
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(B, seed=21, shape=shape)]
    before = structured_admm_iterations.launches
    out_k = fused_admm.launch_variant(fused_admm._lib(), variant, arrays, **KW)
    out_t = structured_admm_iterations_ref(*arrays, **KW)
    torch.cuda.synchronize()
    assert structured_admm_iterations.launches == before     # only the wrapper counts
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FOV, CONN, CONN_LAMBDA2, SWARM_CONN, SWEEP_R10, TEAM128_CONN])
def test_nan_lane_leaves_its_block_untouched_on_gpu(shape):
    """The tiled kernel runs several lanes in one block, the folded and
    generic kernels several blocks on one SM, the cluster kernel a lane on
    several SMs beside other lanes; a lane that goes NaN changes no bit of
    any other lane."""
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
    """Every fov team of 2 to 256 agents and every connectivity team of 2 to
    256 robots takes tiled, folded, generic or cluster: every team to 84
    agents and 89 robots one of the first three, the larger ones cluster."""
    _need_gpu()
    lib = fused_admm._lib()
    fov = {A: fused_admm.fov_team_shape(A) for A in range(2, 257)}
    conn = {R: (35 + R, 125 + R, 2 * R - 2) for R in range(2, 257)}
    for teams, last_in_a_block in ((fov, 84), (conn, 89)):
        codes = {size: lib.structured_admm_variant(*s) for size, s in teams.items()}
        assert min(codes.values()) >= 0
        took = {size: VARIANTS[c] for size, c in codes.items()}
        assert {size: v for size, v in took.items()
                if (v == "cluster") != (size > last_in_a_block)} == {}


@pytest.mark.cuda
def test_shape_beyond_every_kernel_raises_on_gpu():
    """A lane whose float64 matrix (n = 420: 1.41 MB) exceeds the shared
    memory of a cluster of 8 blocks has no kernel: the wrapper raises before
    launching, names the largest fov team a kernel holds (the next team
    raises, that one does not), and the twin does not stand in."""
    _need_gpu()
    lib = fused_admm._lib()
    A = fused_admm.largest_fov_team(lib)
    assert lib.structured_admm_variant(*fused_admm.fov_team_shape(A)) == VARIANTS.index("cluster")
    assert lib.structured_admm_variant(*fused_admm.fov_team_shape(A + 1)) == -1
    arrays = [torch.from_numpy(a).cuda() for a in _inputs(1, seed=24, shape=(420, 10, 2))]
    before = structured_admm_iterations.launches
    with pytest.raises(ValueError, match=f"no kernel holds the shape.*largest fov team a kernel "
                                         f"holds is {A} agents"):
        structured_admm_iterations(*arrays, **KW)
    assert structured_admm_iterations.launches == before


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
    for use_kernel in (None, False):
        before = structured_admm_iterations.launches
        outs.append(StructuredIMPC(ctrl, StructuredConfig(iters=60, use_kernel=use_kernel))
                    .optimize_batch(*args))
        torch.cuda.synchronize()
        assert structured_admm_iterations.launches - before == (4 if use_kernel is None else 0)
    res_k, res_t = outs
    assert bool(torch.isfinite(res_k.coeffs).all())
    torch.testing.assert_close(res_k.coeffs, res_t.coeffs, rtol=2e-4, atol=2e-4)
    assert torch.equal(res_k.success, res_t.success)
