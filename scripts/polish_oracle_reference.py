"""The JAX package's f32 ADMM + f64 polish against the exact oracle, on the
IMPC-iteration-0 QPs of bench.py's recipes (numpy seed 0), on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 scripts/polish_oracle_reference.py

For connectivity at 256 lanes and fov at 8192 lanes it prints the certified
count and every certified lane whose flown controls (op.U_basis @ z) sit
more than 1e-3 from the oracle's, with that deviation. ``chip_smoke.py``'s
oracle phase holds the port on the card against this record
(``JAX_CPU_ORACLE_OVER``): the 1e-3 bar of tests/test_polish.py is the
reference's empirical claim, and a few certified lanes of these recipes miss
it in the JAX package too (a flat direction of P: the polish's 1e-6
relative certificate leaves ~1e-4 in z there).
"""

import sys

import conftest  # noqa: F401  (the tests' JAX setup: CPU, float64 enabled)
import numpy as np
import jax
import jax.numpy as jnp

import torch_parity_cases as cases
from mpc_cbf_tpu.types import State
from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig
from mpc_cbf_tpu.ops.qp.oracle import solve_oracle_batch
from mpc_cbf_tpu.controllers.mpc_cbf import _rank_weights


def record(mode: str, batch: int) -> None:
    make = cases.fov_inputs if mode == "fov" else cases.conn_inputs
    pos, vel, ref, blob, mask = make(np.random.default_rng(0), batch)
    f32 = jnp.float32
    ctrl = cases.jax_controller(mode)
    op = ctrl.op
    o = StructuredIMPC(ctrl, StructuredConfig(iters=200, iters_tail=64, polish=True)).op_qp
    st = State(jnp.asarray(pos, f32), jnp.asarray(vel, f32))
    blob, mask = jnp.asarray(blob, f32), jnp.asarray(mask)
    x_now = jnp.concatenate([st.pos, st.vel], -1)
    H = ctrl.impc.cbf_horizon
    q = jax.vmap(op.linear_cost)(x_now, jnp.asarray(ref, f32))
    if ctrl.S:
        def slack_w(cur_pos, nbrs, mk):
            d = jax.vmap(lambda nb: ctrl._neighbor_distance(cur_pos, nb))(nbrs)
            return _rank_weights(jnp.where(mk, d, jnp.inf), ctrl.impc.slack_cost,
                                 ctrl.impc.slack_decay_rate)
        q = jnp.concatenate([q, jax.vmap(slack_w)(st.pos, blob, mask)], -1)
    A_d, lb_d, ub_d = jax.vmap(lambda p, v, nb, mk, pr: ctrl.dynamic_rows(
        State(pos=p, vel=v), nb, mk, pr, jnp.arange(H) == 0))(
        st.pos, st.vel, blob, mask, jnp.broadcast_to(x_now[:, None, :], (batch, H, 6)))
    args = (q, *jax.vmap(ctrl.shared_bounds)(st), A_d, lb_d, ub_d)
    sol = o.solve_polished(*args)
    cert = np.asarray(sol.certified)
    idx = np.nonzero(cert)[0]
    q, lb_s, ub_s, A_d, lb_d, ub_d = (np.asarray(a, np.float64)[cert] for a in args)
    n = len(idx)
    x_ref, status = solve_oracle_batch(
        np.broadcast_to(o._P0, (n,) + o._P0.shape), q,
        np.concatenate([np.broadcast_to(o._A_s0, (n,) + o._A_s0.shape), A_d], 1),
        np.concatenate([lb_s, lb_d], 1), np.concatenate([ub_s, ub_d], 1))
    U = np.asarray(op.U_basis)
    n_dec = op.n_dec
    dev = np.abs((np.asarray(sol.z, np.float64)[cert][:, :n_dec] - x_ref[:, :n_dec]) @ U.T).max(-1)
    over = {int(i): float(d) for i, d in zip(idx, dev) if d > 1e-3}
    print(f"{mode}, {batch} lanes: certified {n}, oracle status 0 on {int((status == 0).sum())}, "
          f"max deviation {dev.max():.4e}, median {np.median(dev):.4e}; lanes over 1e-3: {over}")


if __name__ == "__main__":
    record("connectivity", 256)
    record("fov", int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
