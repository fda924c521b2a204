"""The float64 active-set polish of mpc_cbf_torch (ops/qp/polish.py, the
solves of ops/qp/linsolve.py, StructuredQPOperator.solve_polished) and the
exact oracle (ops/qp/oracle.py) against the JAX package on the CPU.

The polish is held to JAX on the SAME entry point (the JAX package's ADMM
or IPM iterate, as numpy), so both run the same float64 active-set
iteration: certified flags equal, z within 1e-8 on certified lanes, the
violation and stationarity within 1e-9. Across the two f32 production
paths the ADMM entries differ by the twin's rounding and only the
certified optimum is unique: there z agrees within 1e-6 on lanes certified
in both, and every certified lane is within 1e-3 of the exact oracle in
the flown controls (the bar of tests/test_polish.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.ops.qp import linsolve as jlin
from mpc_cbf_tpu.ops.qp.ipm import IPMConfig as JIPMConfig
from mpc_cbf_tpu.ops.qp.oracle import _load as jax_oracle_lib, solve_oracle_batch as jax_oracle
from mpc_cbf_tpu.ops.qp.polish import (
    PolishConfig as JPolishConfig, polish_dense as jpolish_dense,
    polish_structured as jpolish_structured)
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig as JStructuredConfig
from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC as JStructuredIMPC, _rank_weights
from mpc_cbf_tpu.types import QPBatch as JQPBatch

from mpc_cbf_torch.controllers import StructuredIMPC
from mpc_cbf_torch.ops.qp import linsolve, oracle
from mpc_cbf_torch.ops.qp.polish import (
    PolishConfig, _top, make_guards, polish_dense, polish_structured)
from mpc_cbf_torch.ops.qp.structured import StructuredConfig
from mpc_cbf_torch.types import BIG, QPBatch, State

from test_oracle_deviation import _flagship_qps, _fov_flagship_qps

import torch_parity_cases as cases

T = lambda a: torch.from_numpy(np.array(a))   # a writable copy of a (read-only) JAX buffer
F32 = torch.float32


# ---- linsolve -------------------------------------------------------------

def _kkt_like(rng, B, n, span):
    """Symmetric quasi-definite batch with a wide diagonal span, Jacobi
    scaled as the polish scales its KKT (tests/test_linsolve.py)."""
    Q = rng.normal(size=(B, n, n))
    A = (Q + np.swapaxes(Q, 1, 2)) / 2
    d = 10.0 ** rng.uniform(-span / 2, span / 2, size=(B, n))
    A = A + np.apply_along_axis(np.diag, 1, d * np.sign(rng.normal(size=(B, n))))
    s = 1.0 / np.sqrt(np.maximum(np.abs(A).max(axis=2), 1e-12))
    return s[:, :, None] * A * s[:, None, :]


@pytest.mark.parametrize("seed,B,n,span", [(0, 16, 37, 8.0), (7, 16, 37, 6.0), (2, 2, 9, 2.0)])
def test_plu_matches_jax_lapack(seed, B, n, span):
    rng = np.random.default_rng(seed)
    A = _kkt_like(rng, B, n, span)
    b = rng.normal(size=(B, n))
    x = linsolve.plu_solve(linsolve.plu_factor(T(A)), T(b)).numpy()
    x_ref = np.asarray(jlin.plu_solve(jlin.plu_factor(jnp.asarray(A)), jnp.asarray(b)))
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-10)
    assert np.abs(np.einsum("bij,bj->bi", A, x) - b).max() < 1e-9


def test_plu_singular_pivot_stays_finite():
    A = torch.eye(5, dtype=torch.float64)[None].clone()
    A[0, 2, 2] = 0.0
    x = linsolve.plu_solve(linsolve.plu_factor(A), torch.ones(1, 5, dtype=torch.float64))
    assert bool(torch.isfinite(x).all())


def test_spd_solve_matches_jax_and_poisons_a_non_spd_lane():
    rng = np.random.default_rng(3)
    G = rng.normal(size=(8, 20, 6))
    M = np.einsum("bij,bkj->bik", G, G) + 1e-3 * np.eye(20)
    b = rng.normal(size=(8, 20))
    for jitter in (0.0, 1e-12):
        x = linsolve.spd_solve(T(M), T(b), jitter=jitter).numpy()
        x_ref = np.asarray(jlin.spd_solve(jnp.asarray(M), jnp.asarray(b), jitter=jitter))
        np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-10)
    bad = M.copy()
    bad[3] = -np.eye(20)                     # not positive definite
    x = linsolve.spd_solve(T(bad), T(b))
    assert bool(torch.isnan(x[3]).all())
    assert bool(torch.isfinite(x[torch.arange(8) != 3]).all())
    assert np.isnan(np.asarray(jlin.spd_solve(jnp.asarray(bad), jnp.asarray(b)))[3]).all()


# ---- polish against JAX on one entry point ----------------------------------

def _structured_pieces(mode, B, seed, entry="admm"):
    """(JAX operator, dense QPBatch, numpy q, lb_s, ub_s, A_d, lb_d, ub_d,
    entry z) of the IMPC-iteration-0 QPs; the entry from the JAX package's
    float64 structured ADMM (200 iterations) or its float64 IPM rounded to
    float32."""
    make = _fov_flagship_qps if mode == "fov" else _flagship_qps
    ctrl, op, qp, (pos, vel, refs, blobs, mask) = make(B, seed=seed)
    H = ctrl.impc.cbf_horizon
    x_now = jnp.concatenate([pos, vel], -1)
    lb_s, ub_s = jax.vmap(ctrl.shared_bounds)(JState(pos=pos, vel=vel))
    active0 = jnp.arange(H) == 0
    A_d, lb_d, ub_d = jax.vmap(lambda p, v, nb, mk, pr: ctrl.dynamic_rows(
        JState(pos=p, vel=v), nb, mk, pr, active0))(
        pos, vel, blobs, mask, jnp.broadcast_to(x_now[:, None, :], (B, H, 6)))
    q = jax.vmap(op.linear_cost)(x_now, refs)
    if ctrl.S:
        def slack_w(cur_pos, blob, mk):
            d = jax.vmap(lambda nb: ctrl._neighbor_distance(cur_pos, nb))(blob)
            return _rank_weights(jnp.where(mk, d, jnp.inf), ctrl.impc.slack_cost,
                                 ctrl.impc.slack_decay_rate)
        q = jnp.concatenate([q, jax.vmap(slack_w)(pos, blobs, mask)], -1)
    args = (q, lb_s, ub_s, A_d, lb_d, ub_d)
    op_qp = JStructuredIMPC(ctrl, JStructuredConfig(iters=200)).op_qp
    if entry == "admm":
        z0 = np.asarray(op_qp.solve(*args).z)
    else:
        z0 = np.asarray(JStructuredIMPC(ctrl, JIPMConfig()).op_qp.solve(*args).z)
        z0 = z0.astype(np.float32).astype(np.float64)
    return op_qp, qp, [np.asarray(a) for a in args] + [z0]


def _assert_same(mine, theirs, want_ok=None):
    ok, jok = mine.ok.numpy(), np.asarray(theirs.ok)
    np.testing.assert_array_equal(ok, jok)
    if want_ok is not None:
        assert ok.sum() >= want_ok, ok
    np.testing.assert_allclose(mine.z.numpy()[ok], np.asarray(theirs.z)[ok], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(mine.z.numpy()[~ok], np.asarray(theirs.z)[~ok])
    np.testing.assert_allclose(mine.viol.numpy(), np.asarray(theirs.viol), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(mine.stat.numpy(), np.asarray(theirs.stat), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mode,seed,entry,want_ok", [
    ("connectivity", 3, "admm", 8), ("connectivity", 5, "admm", 8), ("fov", 3, "ipm", 4)])
def test_polish_structured_matches_jax(mode, seed, entry, want_ok):
    """Connectivity from the ADMM's iterate (every lane certifies); fov, with
    the guard rows and groups of its 7 slack columns, from the f64 IPM's
    iterate rounded to f32 (5 of 8 certify; from the ADMM's iterate none
    does, the JAX package's known limitation, tests/test_polish.py:27-76)."""
    o, _, (q, lb_s, ub_s, A_d, lb_d, ub_d, z0) = _structured_pieces(mode, 8, seed, entry)
    if mode == "fov":
        assert len(o._guard_rows) == 7 and len(o._guard_groups) == 7
    mine = polish_structured(o._P0, o._A_s0, T(q), T(lb_s), T(ub_s), T(A_d), T(lb_d),
                             T(ub_d), T(z0), max_eq=o._n_eq, guard_rows=o._guard_rows,
                             guard_groups=o._guard_groups)
    theirs = jpolish_structured(o._P0, o._A_s0, q, lb_s, ub_s, A_d, lb_d, ub_d, z0,
                                max_eq=o._n_eq, guard_rows=o._guard_rows,
                                guard_groups=o._guard_groups)
    assert mine.z.dtype == torch.float64
    _assert_same(mine, theirs, want_ok)


@pytest.mark.parametrize("mode,seed,entry", [("connectivity", 3, "admm"), ("fov", 3, "ipm")])
def test_polish_dense_matches_jax(mode, seed, entry):
    o, qp, (*_, z0) = _structured_pieces(mode, 8, seed, entry)
    qpt = QPBatch(*(T(np.asarray(getattr(qp, k))) for k in ("P", "q", "A", "lb", "ub")))
    _assert_same(polish_dense(qpt, T(z0), max_eq=o._n_eq), jpolish_dense(qp, z0, max_eq=o._n_eq))
    # max_eq counted on the device, as the JAX package counts it on the host
    _assert_same(polish_dense(qpt, T(z0)), jpolish_dense(qp, z0))


def test_polish_fallback_on_uncertifiable_lane():
    """Infeasible rows (x0 >= 1 and x0 <= -1): ok is False and the entry
    point comes back unchanged (tests/test_polish.py:133-148)."""
    n = 4
    A = np.zeros((1, 2, n))
    A[:, :, 0] = 1.0
    lb, ub = np.array([[1.0, -1e20]]), np.array([[1e20, -1.0]])
    x0 = np.array([[0.3, 0.0, 0.0, 0.0]])
    cfg = dict(mass_rounds=2, rounds=3)
    res = polish_dense(QPBatch(torch.eye(n, dtype=torch.float64), torch.zeros(1, n, dtype=torch.float64),
                               T(A), T(lb), T(ub)), T(x0), PolishConfig(**cfg))
    jres = jpolish_dense(JQPBatch(P=jnp.eye(n), q=jnp.zeros((1, n)), A=jnp.asarray(A),
                                  lb=jnp.asarray(lb), ub=jnp.asarray(ub)),
                         jnp.asarray(x0), JPolishConfig(**cfg))
    assert not bool(res.ok[0]) and not bool(jres.ok[0])
    np.testing.assert_array_equal(res.z.numpy(), x0)
    np.testing.assert_allclose(res.viol.numpy(), np.asarray(jres.viol), rtol=1e-6)


def test_polish_structured_matches_dense_in_the_port():
    """polish_structured on the shared/dynamic split against polish_dense on
    the equivalent dense stack, both in the port (tests/test_polish.py:151-175)."""
    o, qp, (q, lb_s, ub_s, A_d, lb_d, ub_d, z0) = _structured_pieces("connectivity", 8, 5)
    res_s = polish_structured(o._P0, o._A_s0, T(q), T(lb_s), T(ub_s), T(A_d), T(lb_d),
                              T(ub_d), T(z0), max_eq=o._n_eq)
    qpt = QPBatch(*(T(np.asarray(getattr(qp, k))) for k in ("P", "q", "A", "lb", "ub")))
    res_d = polish_dense(qpt, T(z0), max_eq=o._n_eq)
    assert bool(res_s.ok.all()) and bool(res_d.ok.all())
    np.testing.assert_allclose(res_s.z.numpy(), res_d.z.numpy(), rtol=0, atol=1e-7)


def test_top_breaks_ties_as_jax_top_k():
    rng = np.random.default_rng(23)
    key = rng.choice(np.array([1e12, 1e6, 0.0, -1.0, np.inf, -np.inf, -1e18]), size=(64, 40))
    key[:, ::7] += rng.normal(size=key[:, ::7].shape)
    for k in (1, 7, 20, 40):
        np.testing.assert_array_equal(_top(T(key), k).numpy(),
                                      np.asarray(jax.lax.top_k(jnp.asarray(key), k)[1]))


def test_polish_ties_across_the_pinned_cap_match_jax():
    """Three rows active at the entry with equal keys; the pinned set is
    capped at n = 2, so which two stay pinned decides the round's point:
    the lower indices (x <= 1 and its multiple 2x <= 2) leave y free, and
    after one round y overshoots to 2 and the lane does not certify, as in
    the JAX package; any other tie order pins y <= 1 and certifies."""
    A = np.array([[[1.0, 0.0], [2.0, 0.0], [0.0, 1.0]]] * 2)
    lb, ub = np.full((2, 3), -BIG), np.array([[1.0, 2.0, 1.0]] * 2)
    x0 = np.ones((2, 2))
    cfg = dict(mass_rounds=1, rounds=0, pool_extra=3)
    qp = (np.eye(2), -2 * np.ones((2, 2)), A, lb, ub)
    res = polish_dense(QPBatch(*map(T, qp)), T(x0), PolishConfig(**cfg), max_eq=0)
    jres = jpolish_dense(JQPBatch(*map(jnp.asarray, qp)), jnp.asarray(x0), JPolishConfig(**cfg),
                         max_eq=0)
    assert not bool(jres.ok.any())
    _assert_same(res, jres)
    assert float(res.viol[0]) == pytest.approx(1.0)


def test_guard_groups_must_be_disjoint():
    with pytest.raises(ValueError):
        make_guards((5,), ((5, 7), (7, 9)), 12, "cpu")
    with pytest.raises(ValueError):
        make_guards((), ((0, 3),), 12, "cpu")
    g = make_guards((5, 6), ((5, 8), (6, 9)), 12, "cpu")
    assert g.rows == (5, 6) and g.row_mask.nonzero().flatten().tolist() == [5, 6]
    assert g.group_mask.nonzero().tolist() == [[0, 5], [0, 8], [1, 6], [1, 9]]


# ---- the f32 production path ------------------------------------------------

def test_polish_structured_production_path():
    """StructuredIMPC(StructuredConfig(iters=200, polish=True)) in float32 on
    the connectivity QPs of tests/test_polish.py:103-130: every lane
    certified and within 1e-3 of the port's oracle in the flown controls, and
    within 1e-6 of the JAX package's polished z where both certify."""
    B = 8
    jctrl, op, qp, (pos, vel, refs, blobs, mask) = _flagship_qps(B, seed=3)
    x_ref, status = oracle.solve_oracle_batch(*(np.asarray(getattr(qp, k))
                                                for k in ("P", "q", "A", "lb", "ub")))
    assert (status == 0).all()

    f32 = jnp.float32
    jop = JStructuredIMPC(jctrl, JStructuredConfig(iters=200, polish=True)).op_qp
    st32 = JState(pos=pos.astype(f32), vel=vel.astype(f32))
    x_now = jnp.concatenate([st32.pos, st32.vel], -1)
    jargs = (jax.vmap(op.linear_cost)(x_now, refs.astype(f32)),
             *jax.vmap(jctrl.shared_bounds)(st32),
             *jax.vmap(lambda p, v, nb, mk, pr: jctrl.dynamic_rows(
                 JState(pos=p, vel=v), nb, mk, pr, jnp.arange(2) == 0))(
                 st32.pos, st32.vel, blobs.astype(f32), mask,
                 jnp.broadcast_to(x_now[:, None, :], (B, 2, 6))))
    jsol = jop.solve_polished(*jargs)

    ctrl = cases.torch_controller("connectivity", "cpu", F32)
    simpc = StructuredIMPC(ctrl, StructuredConfig(iters=200, polish=True))
    t32 = lambda a: torch.as_tensor(np.array(a), dtype=F32)
    cur = State(t32(pos), t32(vel))
    H = ctrl.impc.cbf_horizon
    A_d, lb_d, ub_d = ctrl.dynamic_rows(cur, t32(blobs), torch.as_tensor(np.array(mask)),
                                        cur.stacked[:, None, :].expand(B, H, 6),
                                        torch.arange(H) == 0)
    q = ctrl.cost_vector(cur, t32(refs), t32(blobs), torch.as_tensor(np.array(mask)))
    sol = simpc.op_qp.solve_polished(q, *ctrl.shared_bounds(cur), A_d, lb_d, ub_d)

    assert sol.z.dtype == F32
    assert bool(sol.certified.all()) and bool(sol.converged.all())
    U = np.asarray(ctrl.op.U_basis)
    dev = np.abs(sol.z[:, :36].double().numpy() @ U.T - x_ref[:, :36] @ U.T).max()
    assert dev < 1e-3, f"structured polished f32 deviation: {dev}"
    both = sol.certified.numpy() & np.asarray(jsol.certified)
    assert both.sum() >= 7
    np.testing.assert_allclose(sol.z.numpy()[both], np.asarray(jsol.z)[both], rtol=0, atol=1e-6)
    # certified lanes report their exact violation as pri_res
    assert float(sol.pri_res.max()) < 1e-6


def test_fov_polish_control_step():
    """bench.py's fov +polish recipe at 8 lanes (tests/test_bench_smoke.py:56-63)
    through StructuredIMPC.optimize_batch: usable >= 0.75 and every certified
    lane usable. The polish certifies only lanes whose ADMM entry found the
    right active set; on these 8 lanes the JAX package (bench.build("fov", 8,
    "polish")) and the port both give usable 6 of 8 and certify none."""
    pos, vel, ref, blob, mask = cases.fov_inputs(np.random.default_rng(0), 8)
    t32 = lambda a: torch.as_tensor(a, dtype=F32)
    simpc = StructuredIMPC(cases.torch_controller("fov", "cpu", F32),
                           StructuredConfig(iters=200, iters_tail=64, polish=True))
    res = simpc.optimize_batch(State(t32(pos), t32(vel)), t32(ref), t32(blob), torch.as_tensor(mask))
    assert tuple(res.coeffs.shape) == (8, 36) and bool(torch.isfinite(res.coeffs).all())
    assert float(res.success.float().mean()) >= 0.75
    assert not bool((res.certified & ~res.success).any())


# ---- the oracle -------------------------------------------------------------

def _native_state():
    return {p.name: (p.stat().st_mtime_ns, p.read_bytes())
            for p in sorted(oracle.SOURCE.parent.iterdir())}


def test_oracle_matches_jax_and_leaves_native_untouched(tmp_path, monkeypatch):
    jax_oracle_lib()           # the JAX wrapper may rebuild native/ on its first call
    before = _native_state()
    assert oracle.BUILD_ROOT.relative_to(oracle.SOURCE.parents[1]).parts == ("build", "oracle")
    monkeypatch.setattr(oracle, "BUILD_ROOT", tmp_path / "oracle")
    lib = oracle.build()       # a fresh compile, into the build root only
    assert lib.is_file() and lib.parent.parent == tmp_path / "oracle"
    x, st, info = oracle.solve_oracle(2 * np.eye(2), np.zeros(2), np.array([[1.0, 1.0]]),
                                      [1.0], [1e20])
    assert st == 0
    np.testing.assert_allclose(x, [0.5, 0.5], atol=1e-9)
    _, _, qp, _ = _flagship_qps(8, seed=3)
    arrays = [np.asarray(getattr(qp, k)) for k in ("P", "q", "A", "lb", "ub")]
    x, status = oracle.solve_oracle_batch(*arrays)
    assert _native_state() == before, "the port's oracle wrote into native/"
    jx, jstatus = jax_oracle(*arrays)
    np.testing.assert_array_equal(status, jstatus)
    assert (status == 0).all()
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12)
