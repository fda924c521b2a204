"""The f32 Mehrotra IPM's chunk solves as CUDA graphs (ops/qp/ipm.py).

On the card ``StructuredIPM.solve`` captures the first chunk of each shape
and replays that graph for every chunk of the shape; on the CPU it solves
each chunk eagerly. The graph runs the eager ``_solve``'s kernels in the
same order on inputs of the same alignment, so the cases marked ``cuda``
hold the replay to the eager solve bit for bit, at the fov fleet's lane and
chunk counts (fov QPs from ``torch_parity_cases.fov_inputs``) and at the
connectivity batch of 32768 lanes (``conn_inputs``).

The file imports no JAX, so the ``cuda`` cases also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ipm_graph.py
"""

import functools

import numpy as np
import pytest
import torch

from mpc_cbf_torch.ops.qp import ipm
from mpc_cbf_torch.types import BIG, State

import torch_parity_cases as cases

F32 = torch.float32
CHUNK = ipm.IPM_F32_ENTRY.chunk            # 2048 lanes, the fleet's chunk
FLEET = 8192                               # the fov fleet's lanes: 4 chunks


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")


@functools.lru_cache(maxsize=None)
def _controller(mode, device):
    return cases.torch_controller(mode, torch.device(device), F32)


def _qp(B, seed, device, mode="fov"):
    """(static parts, (q, lb_s, ub_s, A_d, lb_d, ub_d)) of B lanes, f32."""
    ctrl = _controller(mode, device)
    make = cases.fov_inputs if mode == "fov" else cases.conn_inputs
    pos, vel, ref, blob, mask = make(np.random.default_rng(seed), B)
    T = lambda a: torch.as_tensor(a, dtype=F32, device=device)
    cur = State(T(pos), T(vel))
    mask = torch.as_tensor(mask, device=device)
    H = ctrl.impc.cbf_horizon
    q = ctrl.cost_vector(cur, T(ref), T(blob), mask)
    lb_s, ub_s = ctrl.shared_bounds(cur)
    pred = cur.stacked[:, None, :].expand(B, H, 6)
    A_d, lb_d, ub_d = ctrl.dynamic_rows(cur, T(blob), mask, pred,
                                        torch.ones(H, dtype=torch.bool, device=device))
    return ctrl.static_parts() + (ctrl.m_dynamic,), (q, lb_s, ub_s, A_d, lb_d, ub_d)


def _eager(op, args, state0=None):
    """The chunk loop of ``solve`` on the eager ``_solve``: what the solve
    gave before the graphs."""
    args = tuple(a.to(op.dtype) for a in args)
    state0 = None if state0 is None else tuple(a.to(op.dtype) for a in state0)
    B = args[0].shape[0]
    chunk = op.cfg.chunk if 0 < op.cfg.chunk < B else B
    parts = [_fields(op._solve(*(a[s:s + chunk] for a in args),
                               None if state0 is None else tuple(a[s:s + chunk] for a in state0)))
             for s in range(0, B, chunk)]
    whole = tuple(torch.cat(f) for f in zip(*parts))
    return ipm.IPMSolution(*whole[:5], state=whole[5:])


_fields = ipm._fields


def _assert_equal(a, b):
    for x, y in zip(_fields(a), _fields(b), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def _counts_since(before):
    return {k: v - before[k] for k, v in ipm.StructuredIPM.graph_counts.items()}


def test_cpu_solves_every_chunk_eagerly():
    """On the CPU no graph is made: every chunk is an eager solve, counted
    as such, and the result is the eager chunk loop's (16 lanes = 5+5+5+1)."""
    static, args = _qp(16, seed=3, device="cpu")
    op = ipm.StructuredIPM(*static, ipm.IPMConfig(chunk=5, dtype="f32", iters=8),
                           device="cpu")
    before = dict(ipm.StructuredIPM.graph_counts)
    sol = op.solve(*args)
    assert _counts_since(before) == {"capture": 0, "replay": 0, "eager": 4}
    assert op._graphs is None
    _assert_equal(sol, _eager(op, args))


@pytest.mark.cuda
@pytest.mark.parametrize("B,shapes", [(FLEET, 1), (5000, 2)])
def test_replay_equals_the_eager_solve(B, shapes):
    """8192 lanes (four chunks of one shape) and 5000 (2048 + 2048 + 904):
    one capture per chunk shape, every chunk a replay, bit for bit the eager
    solve; a second call captures nothing."""
    _need_gpu()
    static, args = _qp(B, seed=11, device="cuda")
    op = ipm.StructuredIPM(*static, ipm.IPM_F32_ENTRY, device="cuda")
    chunks = -(-B // CHUNK)
    for call in range(2):
        before = dict(ipm.StructuredIPM.graph_counts)
        sol = op.solve(*args)
        assert _counts_since(before) == {"capture": shapes if call == 0 else 0,
                                         "replay": chunks, "eager": 0}
        _assert_equal(sol, _eager(op, args))
    assert len(op._graphs) == shapes
    assert bool(sol.converged.any())


@pytest.mark.cuda
def test_connectivity_replay_equals_the_eager_solve():
    """Connectivity (nz = 6, m_d = 6) at 32768 lanes: sixteen replays of one
    graph, bit for bit the eager solve."""
    _need_gpu()
    B = 32768
    static, args = _qp(B, seed=17, device="cuda", mode="connectivity")
    op = ipm.StructuredIPM(*static, ipm.IPM_F32_ENTRY, device="cuda")
    before = dict(ipm.StructuredIPM.graph_counts)
    sol = op.solve(*args)
    assert _counts_since(before) == {"capture": 1, "replay": B // CHUNK, "eager": 0}
    _assert_equal(sol, _eager(op, args))
    assert float(sol.converged.float().mean()) > 0.9


@pytest.mark.cuda
def test_hybrid_with_state0_equals_the_eager_solve():
    """HybridIPM: the f32 entry's graph and the f64 tail's, keyed apart (the
    tail's inputs carry state0), each bit for bit its eager chunk loop."""
    _need_gpu()
    static, args = _qp(5000, seed=12, device="cuda")
    hyb = ipm.HybridIPM(*static, ipm.HYBRID_PROD, device="cuda")
    before = dict(ipm.StructuredIPM.graph_counts)
    sol = hyb.solve(*args)
    assert _counts_since(before) == {"capture": 4, "replay": 6, "eager": 0}
    ent = _eager(hyb.entry, args)
    _assert_equal(sol, _eager(hyb.tail, args, state0=ent.state))
    assert sol.z.dtype == torch.float64
    assert all(len(k) == 10 for k in hyb.tail._graphs)       # six inputs + state0's four


@pytest.mark.cuda
def test_returned_tensors_outlive_the_next_replay():
    """A one-chunk solve returns copies of the graph's outputs: the next
    call with other inputs leaves the first call's tensors as they were."""
    _need_gpu()
    static, first = _qp(CHUNK, seed=13, device="cuda")
    _, second = _qp(CHUNK, seed=14, device="cuda")
    op = ipm.StructuredIPM(*static, ipm.IPM_F32_ENTRY, device="cuda")
    sol1 = op.solve(*first)
    kept = tuple(t.clone() for t in _fields(sol1))
    sol2 = op.solve(*second)
    torch.cuda.synchronize()
    for t, k in zip(_fields(sol1), kept):
        torch.testing.assert_close(t, k, rtol=0, atol=0)
    assert not torch.equal(sol1.z, sol2.z)
    _assert_equal(sol2, _eager(op, second))


@pytest.mark.cuda
def test_nan_lane_is_contained_in_the_replay():
    """A NaN in one lane's cost leaves every other lane of the replay bitwise
    as it was, and that lane reports converged = False."""
    _need_gpu()
    static, args = _qp(FLEET, seed=15, device="cuda")
    op = ipm.StructuredIPM(*static, ipm.IPM_F32_ENTRY, device="cuda")
    clean = op.solve(*args)
    bad = CHUNK + 3                       # a lane of the second chunk
    q = args[0].clone()
    q[bad, 5] = float("nan")
    sol = op.solve(q, *args[1:])
    assert not bool(sol.converged[bad])
    keep = torch.arange(FLEET, device="cuda") != bad
    for a, b in zip(_fields(sol), _fields(clean)):
        torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0)
    _assert_equal(sol, _eager(op, (q,) + args[1:]))


@pytest.mark.cuda
def test_factorization_failure_is_contained_in_the_replay(monkeypatch):
    """A lane whose bounded rows have their lower bound 0.1 above the upper
    one: from the second iteration its KKT matrix is finite and not positive
    definite (the factorization's info flags it in the eager solve; on the
    CPU the least eigenvalue is about -170). The replay leaves the lane
    unconverged, every other lane bitwise as in the clean solve, and the
    whole result is the eager solve's."""
    _need_gpu()
    static, args = _qp(FLEET, seed=16, device="cuda")
    op = ipm.StructuredIPM(*static, ipm.IPM_F32_ENTRY, device="cuda")
    clean = op.solve(*args)
    bad = 2 * CHUNK + 5                   # a lane of the third chunk
    lb_d = args[4].clone()
    rows = args[5][bad] < BIG / 2
    lb_d[bad, rows] = args[5][bad, rows] + 0.1
    broken = args[:4] + (lb_d, args[5])
    sol = op.solve(*broken)
    assert not bool(sol.converged[bad])
    keep = torch.arange(FLEET, device="cuda") != bad
    for a, b in zip(_fields(sol), _fields(clean)):
        torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0)
    oks, factor = [], ipm.chol_factor

    def spy(H):
        L, ok = factor(H)
        oks.append(ok)
        return L, ok
    monkeypatch.setattr(ipm, "chol_factor", spy)
    _assert_equal(sol, _eager(op, broken))
    assert not all(bool(ok[bad - 2 * CHUNK]) for ok in oks[2 * op.cfg.iters:3 * op.cfg.iters])
