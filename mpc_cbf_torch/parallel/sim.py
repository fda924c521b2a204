"""Batched multi-agent closed loop (counterpart of
``mpc_cbf_tpu/parallel/sim.py:38-320``, the structured path of
``MultiAgentSim``).

Batch-first: states and goals carry an optional leading scenario axis,
[S, A, ...]. Every replan step flattens the S·A agents into the lanes of
one ``StructuredIMPC.optimize_batch`` call; the JAX package gets the same
batch by vmapping or sharding ``rollout`` over scenarios. A plain
[A, ...] input is the case S = 1 and comes back without the axis. The
outer loop is a Python loop of ``num_steps`` steps with no host
synchronisation.

Semantics (as the JAX package): all agents replan from the same snapshot;
an agent whose solve yields no flyable curve keeps flying its last one
(reference ``MPCCBFFormationControl_example.cpp:150-221``).

Not ported yet: the dense per-agent path (``structured=False``, which
needs the dense ADMM), ``sharded_rollout`` and the mesh, ``CBFOnlySim``
and ``BezierMPCSim``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_cbf_torch.types import State
from mpc_cbf_torch.controllers.mpc_cbf import _IMPCCBFBase, FovIMPCCBF, StructuredIMPC
from mpc_cbf_torch.ops.controls import add_random_noise
from mpc_cbf_torch.ops.geometry import convert_to_closest_yaw
from mpc_cbf_torch.ops.qp.structured import StructuredConfig, StructuredQPOperator

Tensor = torch.Tensor


class SimResult(NamedTuple):
    states: State            # final [.., A, dim] states
    traj_pos: Tensor         # [.., T, A, dim] positions after every replan step
    traj_vel: Tensor         # [.., T, A, dim]
    success: Tensor          # [.., T, A] per-step solver success
    coeffs: Tensor           # final curve coefficients [.., A, n_dec]
    # [.., T, A] bool: the step's flown curve carries the <1e-3 accuracy
    # certificate (certifying solvers only; see IMPCResult.certified)
    certified: Optional[Tensor] = None


def _others(num_agents: int) -> np.ndarray:
    """[A, A-1] indices of every agent but i, in order."""
    return np.array([[j for j in range(num_agents) if j != i] for i in range(num_agents)],
                    dtype=np.int64).reshape(num_agents, num_agents - 1)


def _neighbor_blob_connectivity(states: State, others: Tensor) -> Tensor:
    """All other agents' full states: [.., A, A-1, 6]."""
    return states.stacked[..., others, :]


def _neighbor_blob_fov(states: State, others: Tensor, cov_diag: float) -> Tensor:
    """Other agents' [x, y, cov_xx, cov_xy, cov_yy] with a fixed diagonal
    covariance (the simulation examples feed fixed estimates,
    BezierIMPCCBFPFXYYaw_example.cpp:196-203): [.., A, A-1, 5]."""
    xy = states.pos[..., others, :2]
    cov = torch.stack([torch.full_like(xy[..., 0], cov_diag), torch.zeros_like(xy[..., 0]),
                       torch.full_like(xy[..., 0], cov_diag)], dim=-1)
    return torch.cat([xy, cov], dim=-1)


@dataclasses.dataclass(frozen=True)
class MultiAgentSim:
    """Closed-loop sim of one IMPC-CBF controller over A agents.

    controller: a FovIMPCCBF or ConnectivityIMPCCBF built for
    max_neighbors == num_agents - 1.
    """

    controller: _IMPCCBFBase
    num_agents: int
    noise_pos_std: float = 0.0
    noise_vel_std: float = 0.0
    fov_cov_diag: float = 0.01
    #: route the agent batch through StructuredIMPC; the dense per-agent
    #: path (False) is not ported yet and raises NotImplementedError
    structured: bool = False
    #: solver configuration of the structured path: a StructuredConfig (f32
    #: ADMM), an IPMConfig (IPM_F32_ENTRY is the fov production profile) or
    #: a HybridIPMConfig (certified). None = StructuredConfig(iters=150),
    #: the JAX package's default ADMM budget.
    solver_cfg: object = None
    #: FoV mode: mask neighbors beyond this sensing radius out of the
    #: constraint set (None = the controller's Rs; <= 0 disables). Range
    #: only, as in the JAX package, which explains the choice.
    sensing_radius: Optional[float] = None

    def _structured_impc(self) -> StructuredIMPC:
        if not self.structured:
            raise NotImplementedError(
                "MultiAgentSim(structured=False), the dense per-agent path, is not "
                "ported to mpc_cbf_torch yet; use structured=True")
        if not hasattr(self, "_simpc_cache"):
            cfg = self.solver_cfg if self.solver_cfg is not None \
                else StructuredConfig(iters=150)
            object.__setattr__(self, "_simpc_cache", StructuredIMPC(self.controller, cfg))
        return self._simpc_cache

    def _const(self, name: str, like: Tensor) -> Tensor:
        """A numpy constant of this sim as a tensor on like's device (and in
        like's dtype, for floats), made once: a copy from the host each
        step would wait for the device."""
        cache = self.__dict__.setdefault("_const_cache", {})
        key = (name, like.device, like.dtype)
        if key not in cache:
            make = {"others": lambda: _others(self.num_agents),
                    "shift_T": lambda: self._shift_matrix().T,
                    "E0": lambda: self._age_eval_mats()[0],
                    "E1": lambda: self._age_eval_mats()[1]}[name]
            a = make()
            cache[key] = torch.as_tensor(a, device=like.device,
                                         dtype=like.dtype if a.dtype.kind == "f" else None)
        return cache[key]

    def _blobs(self, states: State) -> Tensor:
        others = self._const("others", states.pos)
        if isinstance(self.controller, FovIMPCCBF):
            return _neighbor_blob_fov(states, others, self.fov_cov_diag)
        return _neighbor_blob_connectivity(states, others)

    def _neighbor_mask(self, states: State, blobs: Tensor) -> Tensor:
        """[.., A, A-1] sensing mask (see sensing_radius)."""
        full = torch.ones(blobs.shape[:-1], dtype=torch.bool, device=blobs.device)
        if not isinstance(self.controller, FovIMPCCBF):
            return full
        rs = self.sensing_radius
        if rs is None:
            rs = float(self.controller.cbf.Rs)
        if rs <= 0:
            return full
        d = torch.linalg.vector_norm(states.pos[..., :, None, :2] - blobs[..., :2], dim=-1)
        return d <= rs

    def control_step(self, states: State, goals: Tensor,
                     warm: Optional[Tensor] = None, warm_duals=None,
                     return_duals: bool = False):
        """One replanning step for all agents from a common snapshot.

        states: State with [.., A, dim] leaves; goals [.., A, dim]; warm
        [.., A, n]; warm_duals (ys [.., A, m_s], yd [.., A, m_d]) or None.
        Returns (coeffs [.., A, n_dec], success [.., A], flyable [.., A]);
        with return_duals, 5 values: those three, then the duals (ys, yd)
        for the next step (None on the IPM family) and certified [.., A].
        """
        simpc = self._structured_impc()
        op = self.controller.op
        lead = states.pos.shape[:-1]                # (.., A)
        lanes = int(np.prod(lead))

        # goal yaw -> the 2π-equivalent closest to the current yaw, before
        # the reference is tiled (BezierIMPCCBFPFXYYaw_example.cpp:219-223)
        goals = torch.cat([goals[..., :-1],
                           convert_to_closest_yaw(states.pos[..., -1], goals[..., -1])[..., None]],
                          dim=-1)
        blobs = self._blobs(states)
        mask = self._neighbor_mask(states, blobs)

        flat = lambda x: x.reshape(lanes, *x.shape[len(lead):])
        ref = flat(goals).repeat(1, op.mpc.k_hor)
        res = simpc.optimize_batch(
            State(pos=flat(states.pos), vel=flat(states.vel)), ref, flat(blobs), flat(mask),
            warm=None if warm is None else flat(warm),
            warm_duals=None if warm_duals is None else tuple(flat(d) for d in warm_duals))
        unflat = lambda x: x.reshape(*lead, *x.shape[1:])
        out = (unflat(res.coeffs), unflat(res.success), unflat(res.flyable))
        if not return_duals:
            return out
        duals = (unflat(res.ys), unflat(res.yd)) if res.ys is not None else None
        return out + (duals, unflat(res.certified))

    def _shift_matrix(self) -> np.ndarray:
        """[n_dec, n_dec] linear map c -> coefficients of the least-squares
        fit (on the original piece grid) of the same curve advanced by h:
        curve'(t) ~ curve(min(t + h, T)). It h-shifts the primal warm start
        across replan steps."""
        op = self.controller.op
        T, h = float(op.pw.max_parameter), float(op.mpc.h)
        ts = np.linspace(0.0, T, 8 * op.bezier.num_pieces + 1)
        E = np.asarray(op.pw.eval_matrix(list(ts), 0))        # [M*dim, n]
        Esh = np.asarray(op.pw.eval_matrix([min(t + h, T) for t in ts], 0))
        S, *_ = np.linalg.lstsq(E, Esh, rcond=None)
        return S

    def _age_eval_mats(self):
        """Eval operators for flying a curve its a-th period: row a maps
        control points -> state at t = min((a+1) h, max_parameter)
        (the reference clamps eval_t at the curve end,
        MPCCBFFormationControl_example.cpp:191-196)."""
        op = self.controller.op
        h = op.mpc.h
        n_ages = max(int(np.ceil(op.pw.max_parameter / h + 1e-9)), 1)
        ts = [min((a + 1) * h, op.pw.max_parameter) for a in range(n_ages)]
        E0 = np.stack([op.pw.eval_matrix([t], 0) for t in ts])  # [n_ages, dim, n]
        E1 = np.stack([op.pw.eval_matrix([t], 1) for t in ts])
        return E0, E1, n_ages

    def fly(self, coeffs: Tensor, prev: State, fresh: Tensor,
            generator: Optional[torch.Generator] = None,
            age: Optional[Tensor] = None, has_curve: Optional[Tensor] = None):
        """Advance each agent h seconds. A fresh curve resets the eval
        clock; on a failed solve the agent keeps flying its last successful
        curve (eval time advancing, clamped at the curve end); only an
        agent that never had a curve holds with zero velocity.

        coeffs [.., A, n_dec]; fresh [.., A] bool; generator draws the
        state noise (needed only when a noise std is > 0); age [.., A]
        int64, periods already flown on the current curve; has_curve
        [.., A] bool. Returns (State, new_age, new_has_curve).
        """
        lead = fresh.shape
        if age is None:
            age = torch.zeros(lead, dtype=torch.int64, device=fresh.device)
        if has_curve is None:
            has_curve = torch.zeros(lead, dtype=torch.bool, device=fresh.device)
        E0, E1 = self._const("E0", coeffs), self._const("E1", coeffs)
        n_ages = E0.shape[0]

        idx = torch.where(fresh, torch.zeros_like(age), torch.clamp_max(age, n_ages - 1))
        has_curve_new = has_curve | fresh
        pos = torch.einsum("...dn,...n->...d", E0[idx], coeffs)
        vel = torch.einsum("...dn,...n->...d", E1[idx], coeffs)
        pos = torch.where(has_curve_new[..., None], pos, prev.pos)
        vel = torch.where(has_curve_new[..., None], vel, torch.zeros_like(vel))
        st = State(pos=pos, vel=vel)
        if self.noise_pos_std > 0 or self.noise_vel_std > 0:
            if generator is None:
                raise ValueError("state noise is on: fly needs a torch.Generator")
            st = add_random_noise(generator, st, self.noise_pos_std, self.noise_vel_std)
        return st, idx + 1, has_curve_new

    def rollout(self, init: State, goals: Tensor, num_steps: int,
                generator: Optional[torch.Generator] = None) -> SimResult:
        """Run the closed loop for num_steps replanning periods.

        init: State with [.., A, dim] leaves (an optional leading scenario
        axis S); goals [.., A, dim]. generator: draws the state noise; None
        is a generator on init's device seeded with 0 (the JAX package's
        PRNGKey(0) default)."""
        simpc = self._structured_impc()
        op = self.controller.op
        dev = init.pos.device
        lead = init.pos.shape[:-1]
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        shift_T = self._const("shift_T", init.pos)
        # dual warm-start carry on the ADMM path (row identities are stable
        # across steps); the IPM family carries none
        duals = None
        if isinstance(simpc.op_qp, StructuredQPOperator):
            duals = (init.pos.new_zeros((*lead, simpc.op_qp.m_s)),
                     init.pos.new_zeros((*lead, simpc.op_qp.m_d)))

        states = init
        warm = init.pos.new_zeros((*lead, self.controller.n))
        cur_coeffs = init.pos.new_zeros((*lead, op.n_dec))
        age = torch.zeros(lead, dtype=torch.int64, device=dev)
        has_curve = torch.zeros(lead, dtype=torch.bool, device=dev)
        tp, tv, succ, cert = [], [], [], []
        for _ in range(num_steps):
            new_coeffs, success, fresh, new_duals, certified = self.control_step(
                states, goals, warm, warm_duals=duals, return_duals=True)
            if new_duals is not None:
                duals = new_duals
            # agents with no flyable result keep their previous curve
            cur_coeffs = torch.where(fresh[..., None], new_coeffs, cur_coeffs)
            states, age, has_curve = self.fly(cur_coeffs, states, fresh, generator,
                                              age, has_curve)
            # h-shifted primal warm start: the next step replans from ~one
            # period into the current curve
            warm = torch.cat([cur_coeffs @ shift_T,
                              warm.new_zeros((*lead, self.controller.n - op.n_dec))], dim=-1)
            tp.append(states.pos)
            tv.append(states.vel)
            succ.append(success)
            cert.append(certified)
        t_axis = len(lead) - 1                          # [.., T, A, ...]
        return SimResult(states=states, traj_pos=torch.stack(tp, dim=t_axis),
                         traj_vel=torch.stack(tv, dim=t_axis),
                         success=torch.stack(succ, dim=t_axis), coeffs=cur_coeffs,
                         certified=torch.stack(cert, dim=t_axis))
