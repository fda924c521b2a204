"""Deployment nodes: controller, estimator, goal/ids, SITL plant
(counterpart of ``mpc_cbf_tpu/deploy/nodes.py``).

Reference parity (``workspace/src``):
- ControlNode   -> ``fovmpc_controller/src/control_node.cpp:74-580``
  (mavros flight state machine TAKEOFF -> MISSION -> LAND with the
  reference phase durations :34-36; optimizer timer @ h, tracking timer
  @ Ts, takeoff module @ Ts :195-197; odom + per-target
  PoseWithCovariance estimate + goal subscriptions :180-187; setpoint +
  planned-path publications :190-193)
- FilterNode    -> ``fovmpc_estimator/src/filter_node.cpp:29-124``
  (per-target particle filter with the FOV negative-information update,
  publishing target_k/estimate)
- GoalNode      -> ``fovmpc_controller/src/goal_node.cpp`` (latched goal)
- IdsNode       -> ``fovmpc_controller/src/ids_node.cpp`` (robot/target id
  assignment)
- SITLPlant     -> stands in for PX4 SITL + mavros (``shfiles/launch_sim.sh``):
  a double-integrator tracked by a critically-damped spring onto the
  published position setpoints.

Messages are plain host dicts of numpy arrays (topic schemas documented per
publisher), as in the JAX package. The controller's replan is one batched
``optimize`` call on its device with a batch of one lane, read back to the
host once; each filter node draws from a ``torch.Generator`` of its own,
seeded with its ``seed``, on its device (the JAX node splits a key per
tick).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from mpc_cbf_torch.types import State
from mpc_cbf_torch.deploy.runtime import Bus, Node, Scheduler

TAKEOFF_TIME = 15.0   # control_node.cpp:34
MISSION_TIME = 40.0   # control_node.cpp:35
LAND_TIME = 5.0       # control_node.cpp:36


def _resolve_device(device) -> torch.device:
    """torch.device(device) with its index ('cuda' -> 'cuda:0'); a CUDA
    device without a card raises (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: torch.cuda.is_available() is false "
                           "(pass device='cpu' to run on the CPU)")
    return torch.empty(0, device=device).device


@dataclasses.dataclass
class GoalNode(Node):
    """Publishes a (latched) goal pose for one robot
    (goal_node.cpp: reads goals from config, publishes ~goal)."""

    robot_id: int = 0
    goal: np.ndarray = None

    def start(self):
        self.pub(f"robot_{self.robot_id}/goal",
                 {"pos": np.asarray(self.goal, float)}, latch=True)


@dataclasses.dataclass
class IdsNode(Node):
    """Assigns each robot the ids of its targets (ids_node.cpp: every
    other robot is a target)."""

    num_robots: int = 2

    def start(self):
        for i in range(self.num_robots):
            targets = [j for j in range(self.num_robots) if j != i]
            self.pub(f"robot_{i}/target_ids", {"ids": targets}, latch=True)


@dataclasses.dataclass
class SITLPlant(Node):
    """Double-integrator plant tracking position setpoints — the PX4
    SITL + mavros stand-in. Subscribes robot_i/setpoint, integrates at
    the control period, publishes robot_i/odom. Host numpy."""

    robot_id: int = 0
    dt: float = 0.01
    spring_k: float = 25.0
    init_pos: np.ndarray = None

    def start(self):
        self._pos = np.asarray(self.init_pos, float)
        self._vel = np.zeros(3)
        self._setpoint = self._pos.copy()
        self.sub(f"robot_{self.robot_id}/setpoint", self._on_setpoint)
        self.timer(self.dt, self._tick)
        self._publish()

    def _on_setpoint(self, msg):
        self._setpoint = np.asarray(msg["pos"], float)
        self._sp_vel = np.asarray(msg.get("vel", np.zeros(3)), float)
        self._sp_acc = np.asarray(msg.get("acc", np.zeros(3)), float)

    def _tick(self):
        # PX4-style cascaded tracking of a full PositionTarget: position
        # spring + velocity damping + acceleration feedforward
        # (control_node.cpp:461-470 publishes pos+vel+acc)
        sp_vel = getattr(self, "_sp_vel", np.zeros(3))
        sp_acc = getattr(self, "_sp_acc", np.zeros(3))
        u = sp_acc + self.spring_k * (self._setpoint - self._pos) \
            + 2.0 * np.sqrt(self.spring_k) * (sp_vel - self._vel)
        self._vel = self._vel + u * self.dt
        self._pos = self._pos + self._vel * self.dt + 0.5 * u * self.dt**2
        self._publish()

    def _publish(self):
        self.pub(f"robot_{self.robot_id}/odom",
                 {"pos": self._pos.copy(), "vel": self._vel.copy(),
                  "t": self.sched.now})


@dataclasses.dataclass
class FilterNode(Node):
    """Per-(robot, target) particle-filter estimator
    (filter_node.cpp:29-124): predict, FOV negative-information
    down-weighting, measurement update when visible, resample; publishes
    robot_i/target_k/estimate with mean + covariance. The filters live on
    ``device`` in float32 and draw from one generator seeded with ``seed``."""

    robot_id: int = 0
    target_ids: List[int] = dataclasses.field(default_factory=list)
    rate: float = 5.0            # filter node spins slower than control
    fov_beta: float = 2.0944
    fov_rs: float = 10.0
    num_particles: int = 256
    seed: int = 0
    device: object = "cuda"

    def start(self):
        from mpc_cbf_torch.estimation.particle_filter import PFParams

        self._device = _resolve_device(self.device)
        self._params = PFParams(num_particles=self.num_particles, dt=1.0 / self.rate)
        self._generator = torch.Generator(device=self._device).manual_seed(self.seed)
        f32 = dict(dtype=torch.float32, device=self._device)
        self._proc = 0.1 * torch.eye(2, **f32)
        self._meas = 0.05**2 * torch.eye(2, **f32)
        self._init_cov = 0.25 * torch.eye(2, **f32)
        self._ego = None
        self._truth: Dict[int, np.ndarray] = {}
        self._pf: Dict[int, object] = {}
        self.sub(f"robot_{self.robot_id}/odom", self._on_odom)
        for k in self.target_ids:
            self.sub(f"robot_{k}/odom", lambda m, k=k: self._on_target(k, m))
        self.timer(1.0 / self.rate, self._tick)

    def _on_odom(self, msg):
        self._ego = np.concatenate([msg["pos"], msg["vel"]])

    def _on_target(self, k, msg):
        self._truth[k] = np.asarray(msg["pos"], float)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self._device)

    def _tick(self):
        from mpc_cbf_torch.estimation.particle_filter import pf_init, process_fov_update

        if self._ego is None:
            return
        for k in self.target_ids:
            if k not in self._truth:
                continue
            if k not in self._pf:
                self._pf[k] = pf_init(self._generator, self._tensor(self._truth[k][:2]),
                                      self._init_cov, self._params)
            st, mean, cov = process_fov_update(
                self._generator, self._pf[k], self._tensor(self._ego[:3]),
                self._tensor(self._truth[k][:2]), self._proc, self._meas,
                self.fov_beta, self.fov_rs, self._params)
            self._pf[k] = st
            host = torch.cat([mean, cov.reshape(-1)]).cpu().numpy()   # one read a target
            self.pub(f"robot_{self.robot_id}/target_{k}/estimate",
                     {"mean": host[:2], "cov": host[2:].reshape(2, 2), "t": self.sched.now})


@dataclasses.dataclass
class ControlNode(Node):
    """The flight controller node (control_node.cpp:74-580).

    Flight phases: TAKEOFF (spring up to altitude / here: hold start and
    arm, control_node.cpp takeoff_callback) -> MISSION (optimize @ h,
    track the planned curve @ Ts) -> LAND (hold + disarm after
    mission_time). The optimizer runs the IMPC-CBF controller (the dense
    ADMM of ``optimize``) on the controller's device and dtype with the
    per-target estimates from the filter node; ``replan_s`` keeps the
    wall seconds of every replan (the optimize call and its host read).
    """

    robot_id: int = 0
    controller: object = None          # FovIMPCCBF (or Connectivity variant)
    target_ids: List[int] = dataclasses.field(default_factory=list)
    takeoff_time: float = TAKEOFF_TIME
    mission_time: float = MISSION_TIME

    def start(self):
        op = self.controller.op
        self.h = op.mpc.h
        self.Ts = op.mpc.Ts
        self.phase = "TAKEOFF"
        self._odom = None
        self._goal = None
        self._est: Dict[int, dict] = {}
        self._curve = None
        self._curve_t = 0.0
        self._t0 = self.sched.now
        self.path_log: List[np.ndarray] = []
        self.replan_s: List[float] = []

        self.sub(f"robot_{self.robot_id}/odom", self._on_odom)
        self.sub(f"robot_{self.robot_id}/goal", self._on_goal)
        self.sub(f"robot_{self.robot_id}/target_ids", self._on_ids)
        for k in list(self.target_ids):
            self._sub_target(k)

        # the three reference timers (control_node.cpp:195-197)
        self.timer(self.h, self._optimization_callback)
        self.timer(self.Ts, self._timer_callback)
        self.timer(self.Ts, self._takeoff_callback)

        # precomputed Ts-grid curve sampling operators (static shapes)
        ts = np.arange(self.Ts, op.pw.max_parameter + self.Ts / 2, self.Ts)
        ts = np.minimum(ts, op.pw.max_parameter)
        self._ts_grid = ts
        self._E = [np.stack([op.pw.eval_matrix([t], d) for t in ts])
                   for d in (0, 1, 2)]  # each [n_ts, dim, n_dec]

    # -- subscriptions -------------------------------------------------------
    def _sub_target(self, k: int):
        self.sub(f"robot_{self.robot_id}/target_{k}/estimate",
                 lambda m, k=k: self._est.__setitem__(k, m))

    def _on_ids(self, msg):
        for k in msg["ids"]:
            if k not in self.target_ids:
                self.target_ids.append(k)
                self._sub_target(k)

    def _on_odom(self, msg):
        self._odom = msg

    def _on_goal(self, msg):
        self._goal = np.asarray(msg["pos"], float)

    # -- phase machine -------------------------------------------------------
    def _takeoff_callback(self):
        t = self.sched.now - self._t0
        if self.phase == "TAKEOFF" and t >= self.takeoff_time:
            self.phase = "MISSION"
        elif self.phase == "MISSION" and t >= self.takeoff_time + self.mission_time:
            self.phase = "LAND"

    # -- optimizer @ h -------------------------------------------------------
    def _optimize_impl(self, pos, vel, goal, nbr_blob, nbr_mask):
        """One lane through the batched controller: inputs without a batch
        axis, outputs (coeffs [n_dec], success, flyable) without one."""
        op = self.controller.op
        ref = goal.repeat(op.mpc.k_hor)
        res = self.controller.optimize(State(pos=pos[None], vel=vel[None]), ref[None],
                                       nbr_blob[None], nbr_mask[None])
        return res.coeffs[0], res.success[0], res.flyable[0]

    def _optimization_callback(self):
        if self.phase != "MISSION" or self._odom is None or self._goal is None:
            return
        t0 = time.perf_counter()
        op = self.controller.op
        N = self.controller.N
        blob = np.zeros((N, 5))
        mask = np.zeros(N, bool)
        for slot, k in enumerate(self.target_ids[:N]):
            if k in self._est:
                est = self._est[k]
                blob[slot, :2] = est["mean"][:2]
                blob[slot, 2] = est["cov"][0, 0]
                blob[slot, 3] = est["cov"][0, 1]
                blob[slot, 4] = est["cov"][1, 1]
                mask[slot] = True
        coeffs, _, flyable = self._optimize_impl(
            op.tensor(self._odom["pos"]), op.tensor(self._odom["vel"]),
            op.tensor(self._goal), op.tensor(blob),
            torch.as_tensor(mask, device=op.device))
        # one host read a replan: the flag and the curve together
        host = torch.cat([flyable.to(coeffs.dtype)[None], coeffs]).cpu().numpy()
        if host[0]:
            self._curve = host[1:]
            self._curve_t = 0.0
        # else: keep tracking the previous curve (reference behavior)
        self.replan_s.append(time.perf_counter() - t0)

    # -- tracker @ Ts --------------------------------------------------------
    def _timer_callback(self):
        if self._odom is None:
            return
        if self.phase == "TAKEOFF":
            sp = np.asarray(self._odom["pos"], float) if not self.path_log \
                else self.path_log[0]
            if not self.path_log:
                self.path_log.append(sp.copy())
            self.pub(f"robot_{self.robot_id}/setpoint", {"pos": sp})
            return
        if self.phase == "LAND" or self._curve is None:
            self.pub(f"robot_{self.robot_id}/setpoint",
                     {"pos": np.asarray(self._odom["pos"], float)})
            return
        op = self.controller.op
        idx = min(int(round(self._curve_t / self.Ts)), len(self._ts_grid) - 1)
        self._curve_t = min(self._curve_t + self.Ts, op.pw.max_parameter)
        z = self._curve[: op.n_dec]
        # full PositionTarget: position + velocity + acceleration
        # feedforward along the planned curve (control_node.cpp:461-470)
        sp = self._E[0][idx] @ z
        sv = self._E[1][idx] @ z
        sa = self._E[2][idx] @ z
        self.path_log.append(sp.copy())
        self.pub(f"robot_{self.robot_id}/setpoint",
                 {"pos": sp, "vel": sv, "acc": sa})


def launch_formation(num_robots: int, starts: np.ndarray, goals: np.ndarray,
                     controller_factory, takeoff_time: float = 1.0,
                     mission_time: float = MISSION_TIME,
                     filter_rate: float = 5.0, device="cuda"):
    """Wire the full node graph for a team (the launch-file equivalent,
    ``workspace/src/fovmpc_controller/launch/*.launch`` +
    ``shfiles/launch_sim.sh``). The filters run on ``device`` (default the
    card; a CUDA device without one raises), and ``controller_factory(i)``
    must build robot i's controller on the same device. Returns (bus,
    sched, nodes_dict)."""
    device = _resolve_device(device)
    bus, sched = Bus(), Scheduler()
    nodes = {"plants": [], "filters": [], "controllers": [], "goals": []}

    ids = IdsNode("ids", bus, sched, num_robots=num_robots)
    ids.start()
    for i in range(num_robots):
        g = GoalNode(f"goal_{i}", bus, sched, robot_id=i, goal=goals[i])
        g.start()
        nodes["goals"].append(g)

        ctrl = controller_factory(i)
        if ctrl.op.device != device:
            raise ValueError(f"robot {i}: controller on {ctrl.op.device}, the graph on {device}")
        targets = [j for j in range(num_robots) if j != i]
        c = ControlNode(f"control_{i}", bus, sched, robot_id=i,
                        controller=ctrl, target_ids=list(targets),
                        takeoff_time=takeoff_time, mission_time=mission_time)
        f = FilterNode(f"filter_{i}", bus, sched, robot_id=i,
                       target_ids=list(targets), rate=filter_rate, seed=i, device=device)
        p = SITLPlant(f"plant_{i}", bus, sched, robot_id=i,
                      dt=ctrl.op.mpc.Ts, init_pos=starts[i])
        # start order: plant publishes odom before controller/filter tick
        p.start(); f.start(); c.start()
        nodes["plants"].append(p)
        nodes["filters"].append(f)
        nodes["controllers"].append(c)
    return bus, sched, nodes
