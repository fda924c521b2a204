"""Batched multi-agent closed loops (counterpart of
``mpc_cbf_tpu/parallel/sim.py``): ``MultiAgentSim`` (an IMPC-CBF
controller, structured or dense), ``CBFOnlySim`` (a single-step CBF-QP
controller, optionally fed by a particle-filter bank) and ``BezierMPCSim``
(the CBF-free MPC).

Batch-first: states and goals carry an optional leading scenario axis,
[S, A, ...]. Every step flattens the S·A agents into the lanes of one
solver call; the JAX package gets the same batch by vmapping or sharding
``rollout`` over scenarios. A plain [A, ...] input is the case S = 1 and
comes back without the axis. The outer loop is a Python loop of
``num_steps`` steps with no host synchronisation.

Semantics (as the JAX package): all agents replan from the same snapshot;
an agent whose solve yields no flyable curve keeps flying its last one
(reference ``MPCCBFFormationControl_example.cpp:150-221``).

``sharded_rollout`` splits the scenario axis over the rows of a device
mesh (``parallel/mesh.py``); on one device it is ``rollout`` itself, which
``apps/sweep.py`` calls.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_cbf_torch.types import State
from mpc_cbf_torch.controllers.bezier_mpc import BezierMPC
from mpc_cbf_torch.controllers.cbf_qp import FovCBFController
from mpc_cbf_torch.controllers.mpc_cbf import _IMPCCBFBase, FovIMPCCBF, StructuredIMPC
from mpc_cbf_torch.estimation.particle_filter import (
    PFParams, PFState, pf_init, process_fov_update)
from mpc_cbf_torch.models.double_integrator import DoubleIntegrator
from mpc_cbf_torch.ops.controls import add_random_noise, critically_damped_spring_control
from mpc_cbf_torch.ops.geometry import convert_to_closest_yaw
from mpc_cbf_torch.ops.qp.structured import StructuredConfig, StructuredQPOperator
from mpc_cbf_torch.parallel.distributed import _world, all_gather_cat
from mpc_cbf_torch.parallel.mesh import Mesh, scenario_sharding
from mpc_cbf_torch.utils import profiling
from mpc_cbf_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

Tensor = torch.Tensor


class SimResult(NamedTuple):
    states: State            # final [.., A, dim] states
    traj_pos: Tensor         # [.., T, A, dim] positions after every replan step
    traj_vel: Tensor         # [.., T, A, dim]
    success: Tensor          # [.., T, A] per-step solver success
    coeffs: Tensor           # final curve coefficients [.., A, n_dec]
    # [.., T, A] bool: the step's flown curve carries the <1e-3 accuracy
    # certificate (certifying solvers only: all False on raw paths and the
    # dense path; see IMPCResult.certified)
    certified: Optional[Tensor] = None


def _others(num_agents: int) -> np.ndarray:
    """[A, A-1] indices of every agent but i, in order."""
    return np.array([[j for j in range(num_agents) if j != i] for i in range(num_agents)],
                    dtype=np.int64).reshape(num_agents, num_agents - 1)


@functools.lru_cache(maxsize=None)
def _others_on(num_agents: int, device: torch.device) -> Tensor:
    return torch.as_tensor(_others(num_agents), device=device)


def _others_of(like: Tensor, num_agents: int) -> Tensor:
    """_others as a tensor on like's device, copied there once (a copy from
    the host each step would wait for the device)."""
    return _others_on(num_agents, like.device)


def _closest_yaw_goals(states: State, goals: Tensor) -> Tensor:
    """goals with the yaw replaced by its 2π-equivalent closest to the
    current yaw, so no reference demands a long-way-around spin
    (BezierIMPCCBFPFXYYaw_example.cpp:219-223, convertToClosestYaw)."""
    yaw = convert_to_closest_yaw(states.pos[..., -1], goals[..., -1])
    return torch.cat([goals[..., :-1], yaw[..., None]], dim=-1)


def _flat(x: Tensor, lead) -> Tensor:
    """[*lead, ...] -> [lanes, ...]."""
    return x.reshape(int(np.prod(lead)), *x.shape[len(lead):])


def _default_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """The generator given, else one on ``device`` seeded with 0 (the JAX
    package's PRNGKey(0) default)."""
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


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
    #: route the agent batch through StructuredIMPC (the structure-exploiting
    #: solvers; the ADMM's loop is the CUDA kernel) instead of the dense
    #: ADMM on every lane's own QP (``controller.optimize``)
    structured: bool = False
    #: solver configuration of the structured path: a StructuredConfig (f32
    #: ADMM), an IPMConfig (IPM_F32_ENTRY is the fov production profile) or
    #: a HybridIPMConfig (certified). None =
    #: StructuredConfig(iters=controller.solver.iters).
    solver_cfg: object = None
    #: FoV mode: mask neighbors beyond this sensing radius out of the
    #: constraint set (None = the controller's Rs; <= 0 disables). Range
    #: only, as in the JAX package, which explains the choice.
    sensing_radius: Optional[float] = None

    def _structured_impc(self) -> StructuredIMPC:
        if not hasattr(self, "_simpc_cache"):
            cfg = self.solver_cfg if self.solver_cfg is not None \
                else StructuredConfig(iters=self.controller.solver.iters)
            object.__setattr__(self, "_simpc_cache", StructuredIMPC(self.controller, cfg))
        return self._simpc_cache

    def _const(self, name: str, like: Tensor) -> Tensor:
        """A numpy matrix of this sim as a tensor on like's device in like's
        dtype, made once: a copy from the host each step would wait for the
        device."""
        cache = self.__dict__.setdefault("_const_cache", {})
        key = (name, like.device, like.dtype)
        if key not in cache:
            make = {"shift_T": lambda: self._shift_matrix().T,
                    "E0": lambda: self._age_eval_mats()[0],
                    "E1": lambda: self._age_eval_mats()[1]}[name]
            cache[key] = torch.as_tensor(make(), device=like.device, dtype=like.dtype)
        return cache[key]

    def _blobs(self, states: State) -> Tensor:
        others = _others_of(states.pos, self.num_agents)
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
        for the next step (None on the IPM family and the dense path) and
        certified [.., A] (all False on the dense path).
        """
        with profiling.step():
            op = self.controller.op
            lead = states.pos.shape[:-1]                # (.., A)

            # goal yaw -> the 2π-equivalent closest to the current yaw, before
            # the reference is tiled
            goals = _closest_yaw_goals(states, goals)
            blobs = self._blobs(states)
            mask = self._neighbor_mask(states, blobs)

            flat = lambda x: _flat(x, lead)
            ref = flat(goals).repeat(1, op.mpc.k_hor)
            cur = State(pos=flat(states.pos), vel=flat(states.vel))
            warm = None if warm is None else flat(warm)
            if self.structured:
                duals0 = None if warm_duals is None else tuple(flat(d) for d in warm_duals)
                res = self._structured_impc().optimize_batch(
                    cur, ref, flat(blobs), flat(mask), warm=warm, warm_duals=duals0)
            else:
                res = self.controller.optimize(cur, ref, flat(blobs), flat(mask), warm=warm)
            unflat = lambda x: x.reshape(*lead, *x.shape[1:])
            out = (unflat(res.coeffs), unflat(res.success), unflat(res.flyable))
            if not return_duals:
                return out
            duals = (unflat(res.ys), unflat(res.yd)) if res.ys is not None else None
            cert = unflat(res.certified) if res.certified is not None \
                else torch.zeros_like(out[1])
            return out + (duals, cert)

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
        with profiling.span("fly"):
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
        op = self.controller.op
        dev = init.pos.device
        lead = init.pos.shape[:-1]
        generator = _default_generator(generator, dev)
        shift_T = self._const("shift_T", init.pos)
        # dual warm-start carry on the structured ADMM path (row identities
        # are stable across steps); the IPM family and the dense path carry
        # none
        duals = None
        if self.structured and isinstance(self._structured_impc().op_qp, StructuredQPOperator):
            op_qp = self._structured_impc().op_qp
            duals = (init.pos.new_zeros((*lead, op_qp.m_s)),
                     init.pos.new_zeros((*lead, op_qp.m_d)))

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


def sharded_rollout(sim: MultiAgentSim, mesh: Mesh, init: State, goals: Tensor,
                    num_steps: int, generator: Optional[torch.Generator] = None) -> SimResult:
    """Scenario-sharded rollout: the leading axis S of init/goals is split
    into equal contiguous slices over the mesh's scenario rows; each slice
    runs ``sim.rollout`` on its row's device, and the results come back
    concatenated in scenario order on the first device of this process (the
    replacement for ScaleScript.sh's process loop).

    init: State with [S, A, dim] leaves; goals [S, A, dim]. With one row in
    one process it is exactly ``sim.rollout(init, goals, num_steps,
    generator)`` on that device. Otherwise row k draws its noise from a
    generator seeded with generator.initial_seed() + k (0 + k for None), so
    noisy results depend on the row count; the default, noise-free sims do
    not. Across processes (``parallel/distributed.py``) every process runs
    the rows it owns, one contiguous block each in rank order as
    ``global_mesh`` lays them, and the results are all-gathered so every
    process returns the whole batch.
    """
    # one (device, process, (slice,)) a row: the agent axis replicates
    rows = scenario_sharding(mesh).shards(goals.shape)[::mesh.shape["agent"]]
    world, rank = _world()
    if len(rows) == 1 and world == 1:
        dev = rows[0][0]
        return sim.rollout(State(init.pos.to(dev), init.vel.to(dev)), goals.to(dev), num_steps,
                           generator)
    procs = [proc for _, proc, _ in rows]
    if world > 1 and (procs != sorted(procs) or set(procs) != set(range(world))
                      or len({procs.count(r) for r in range(world)}) != 1):
        raise ValueError(f"mesh rows owned by processes {procs}: across {world} processes "
                         "each needs an equal block of rows in rank order (global_mesh)")
    seed0 = 0 if generator is None else generator.initial_seed()
    parts = []
    for k, (dev, proc, (sl,)) in enumerate(rows):
        if proc == rank:
            parts.append(sim.rollout(State(init.pos[sl].to(dev), init.vel[sl].to(dev)),
                                     goals[sl].to(dev), num_steps,
                                     torch.Generator(device=dev).manual_seed(seed0 + k)))
    out = parts[0].traj_pos.device
    leaves = [tree_flatten(p)[0] for p in parts]
    merged = tree_unflatten(parts[0], [torch.cat([x.to(out) for x in xs])
                                       for xs in zip(*leaves)])
    return tree_map(all_gather_cat, merged) if world > 1 else merged


# ---------------------------------------------------------------------------
# CBF-only closed loop (reference cbf/examples)
# ---------------------------------------------------------------------------


class CBFSimResult(NamedTuple):
    states: State      # final [.., A, dim]
    traj_pos: Tensor   # [.., T, A, dim]
    traj_vel: Tensor
    u: Tensor          # [.., T, A, 3] applied controls
    success: Tensor    # [.., T, A]
    est_mean: Tensor   # [.., T, A, N, 2] neighbor estimates (PF mode) or true xy
    est_cov: Tensor    # [.., T, A, N, 2, 2]


@dataclasses.dataclass(frozen=True)
class CBFOnlySim:
    """Closed loop of a single-step CBF-QP controller over A agents.

    Reference parity: the sim mains
    ``cbf/examples/connectivity/CBFFormationControl_example.cpp:18-160``
    (nominal control -> ConnectivityControl QP -> applyInput) and
    ``cbf/examples/fov/CBFControl_example.cpp:145-230`` (per-neighbor
    particle filter with FOV negative-information update feeding
    FovControl). All robots of all scenarios are the lanes of one QP solve
    per step.

    controller: FovCBFController (per-neighbor xy+cov estimates) or
    ConnectivityCBFController (full team states). With ``use_pf`` (FoV
    only), per-(agent, neighbor) particle filters produce the estimates
    (PFApplications::processFovUpdate semantics); otherwise true neighbor
    positions with a fixed diagonal covariance are fed in, matching the
    fixed-estimate examples.
    """

    controller: object
    num_agents: int
    dt: float = 0.1                    # sim step (examples run at ts=0.1)
    spring_constant: float = 2.0       # nominal u = spring(goal) (Controls.h:17-27)
    fov_cov_diag: float = 0.04
    use_pf: bool = False
    pf_params: Optional[PFParams] = None
    pf_process_std: float = 0.1
    pf_meas_std: float = 0.05

    def __post_init__(self):
        object.__setattr__(self, "_model", DoubleIntegrator(dim=3, ts=self.dt))

    @property
    def _is_fov(self) -> bool:
        return isinstance(self.controller, FovCBFController)

    def _nominal(self, states: State, goals: Tensor) -> Tensor:
        # never command a long-way-around yaw spin (convertToClosestYaw)
        return critically_damped_spring_control(states, _closest_yaw_goals(states, goals),
                                                self.spring_constant)

    def _true_estimates(self, states: State):
        """(xy [.., A, N, 2], cov [.., A, N, 2, 2]): the other agents' true
        positions with the fixed diagonal covariance."""
        xy = states.pos[..., _others_of(states.pos, self.num_agents), :2]
        cov = self.fov_cov_diag * torch.eye(2, dtype=xy.dtype, device=xy.device)
        return xy, cov.expand(*xy.shape[:-1], 2, 2)

    def control_step(self, states: State, goals: Tensor,
                     est_xy: Optional[Tensor] = None,
                     est_cov: Optional[Tensor] = None):
        """One CBF-QP step for all agents. est_xy [.., A, N, 2], est_cov
        [.., A, N, 2, 2] (FoV mode; defaults to true positions + fixed
        covariance). Returns (u [.., A, 3], converged [.., A])."""
        ctrl = self.controller
        lead = states.pos.shape[:-1]
        u_des = self._nominal(states, goals)
        allx = states.stacked

        if not self._is_fov:
            # the team eigendecomposition runs once per team inside
            res = ctrl.control_all(allx, u_des)
            return res.u, res.converged
        true_xy, true_cov = self._true_estimates(states)
        est_xy = true_xy if est_xy is None else est_xy
        est_cov = true_cov if est_cov is None else est_cov
        mask = torch.ones(est_xy.shape[:-1], dtype=torch.bool, device=est_xy.device)
        res = ctrl.control(_flat(allx, lead), _flat(u_des, lead), _flat(est_xy, lead),
                           _flat(est_cov, lead), _flat(mask, lead))
        return res.u.reshape(*lead, 3), res.converged.reshape(lead)

    def fly(self, states: State, u: Tensor, success: Tensor,
            generator: Optional[torch.Generator] = None,
            noise_pos_std: float = 0.0, noise_vel_std: float = 0.0) -> State:
        """Apply u through the double integrator; failed agents brake to
        zero velocity and hold (CBFFormationControl_example failure path)."""
        u = torch.where(success[..., None], u, torch.zeros_like(u))
        nxt = self._model.step(states, u)
        nxt = State(pos=nxt.pos,
                    vel=torch.where(success[..., None], nxt.vel, torch.zeros_like(nxt.vel)))
        if noise_pos_std > 0 or noise_vel_std > 0:
            nxt = add_random_noise(generator, nxt, noise_pos_std, noise_vel_std)
        return nxt

    # -- PF estimator tick --------------------------------------------------
    def _pf_consts(self, like: Tensor):
        p = self.pf_params if self.pf_params is not None else PFParams(dt=self.dt)
        eye = torch.eye(2, dtype=like.dtype, device=like.device)
        return p, self.pf_process_std * eye, self.pf_meas_std**2 * eye

    def pf_init_all(self, generator: torch.Generator, states: State) -> PFState:
        """Per-(agent, neighbor) PF bank [.., A, N, P, 2] seeded at the true
        neighbor xy (filter_node.cpp:29-124 seeds at first estimate)."""
        p, _, _ = self._pf_consts(states.pos)
        xy, _ = self._true_estimates(states)
        init_cov = 0.25 * torch.eye(2, dtype=xy.dtype, device=xy.device)
        return pf_init(generator, xy, init_cov, p)

    def pf_step_all(self, generator: torch.Generator, pf_bank: PFState, states: State):
        """One estimator tick for the whole bank; returns
        (new_bank, est_xy [.., A, N, 2], est_cov [.., A, N, 2, 2])."""
        p, proc, meas = self._pf_consts(states.pos)
        cbf = self.controller.cbf
        xy, _ = self._true_estimates(states)
        ego = states.pos[..., :, None, :].expand(*xy.shape[:-1], states.pos.shape[-1])
        return process_fov_update(generator, pf_bank, ego, xy, proc, meas, cbf.fov, cbf.Rs, p)

    def rollout(self, init: State, goals: Tensor, num_steps: int,
                generator: Optional[torch.Generator] = None) -> CBFSimResult:
        """Run the closed loop for num_steps steps of dt. init: State with
        [.., A, dim] leaves; goals [.., A, dim]; generator draws the particle
        filters' noise (None: seeded with 0 on init's device)."""
        if self.use_pf and not self._is_fov:
            raise ValueError("use_pf requires a FovCBFController")
        generator = _default_generator(generator, init.pos.device)
        A = self.num_agents
        states = init
        pf = self.pf_init_all(generator, init) if self.use_pf else None
        tp, tv, tu, succ, exy, ecov = [], [], [], [], [], []
        for _ in range(num_steps):
            if self.use_pf:
                pf, est_xy, est_cov = self.pf_step_all(generator, pf, states)
                u, conv = self.control_step(states, goals, est_xy, est_cov)
            else:
                u, conv = self.control_step(states, goals)
                if self._is_fov:
                    est_xy, est_cov = self._true_estimates(states)
                else:
                    est_xy = states.pos.new_zeros((*states.pos.shape[:-1], A - 1, 2))
                    est_cov = states.pos.new_zeros((*states.pos.shape[:-1], A - 1, 2, 2))
            states = self.fly(states, u, conv)
            for rec, val in zip((tp, tv, tu, succ, exy, ecov),
                                (states.pos, states.vel, u, conv, est_xy, est_cov)):
                rec.append(val)
        t_axis = init.pos.dim() - 2                      # [.., T, A, ...]
        stack = lambda rec: torch.stack(rec, dim=t_axis)
        return CBFSimResult(states=states, traj_pos=stack(tp), traj_vel=stack(tv), u=stack(tu),
                            success=stack(succ), est_mean=stack(exy), est_cov=stack(ecov))


# ---------------------------------------------------------------------------
# Bezier MPC (no CBF) closed loop (reference mpc/examples/BezierMPCXYYaw)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BezierMPCSim:
    """Closed loop of the CBF-free Bezier MPC with Voronoi separation
    (``mpc/examples/BezierMPCXYYaw_example.cpp``; controller
    ``mpc/src/controller/BezierMPC.cpp:36-98``). Same skeleton as
    MultiAgentSim."""

    controller: BezierMPC         # built with max_neighbors=A-1
    num_agents: int
    noise_pos_std: float = 0.0
    noise_vel_std: float = 0.0

    def control_step(self, states: State, goals: Tensor,
                     warm: Optional[Tensor] = None):
        """states [.., A, dim], goals [.., A, dim], warm [.., A, n_dec].
        Returns (coeffs [.., A, n_dec], converged [.., A])."""
        ctrl, A = self.controller, self.num_agents
        op = ctrl.op
        lead = states.pos.shape[:-1]
        others = states.pos[..., _others_of(states.pos, A), :]        # [.., A, A-1, dim]
        mask = torch.ones(others.shape[:-1], dtype=torch.bool, device=others.device)
        ref = _flat(goals, lead).repeat(1, op.mpc.k_hor)
        cur = State(pos=_flat(states.pos, lead), vel=_flat(states.vel, lead))
        coeffs, sol = ctrl.plan(cur, ref, _flat(others, lead), _flat(mask, lead),
                                warm=None if warm is None else (_flat(warm, lead), None))
        return coeffs.reshape(*lead, op.n_dec), sol.converged.reshape(lead)

    def fly(self, coeffs: Tensor, prev: State, success: Tensor,
            generator: Optional[torch.Generator] = None) -> State:
        op = self.controller.op
        t_end = float(op.ts_samples[-1] + op.mpc.Ts)
        pos = op.eval_solution(coeffs, [t_end], 0)[..., 0, :]
        vel = op.eval_solution(coeffs, [t_end], 1)[..., 0, :]
        pos = torch.where(success[..., None], pos, prev.pos)
        vel = torch.where(success[..., None], vel, torch.zeros_like(vel))
        st = State(pos=pos, vel=vel)
        if self.noise_pos_std > 0 or self.noise_vel_std > 0:
            st = add_random_noise(generator, st, self.noise_pos_std, self.noise_vel_std)
        return st

    def rollout(self, init: State, goals: Tensor, num_steps: int,
                generator: Optional[torch.Generator] = None) -> SimResult:
        generator = _default_generator(generator, init.pos.device)
        states = init
        coeffs = init.pos.new_zeros((*init.pos.shape[:-1], self.controller.op.n_dec))
        tp, tv, succ = [], [], []
        for _ in range(num_steps):
            coeffs, success = self.control_step(states, goals, coeffs)
            states = self.fly(coeffs, states, success, generator)
            tp.append(states.pos)
            tv.append(states.vel)
            succ.append(success)
        t_axis = init.pos.dim() - 2                      # [.., T, A, ...]
        return SimResult(states=states, traj_pos=torch.stack(tp, dim=t_axis),
                         traj_vel=torch.stack(tv, dim=t_axis),
                         success=torch.stack(succ, dim=t_axis), coeffs=coeffs)
