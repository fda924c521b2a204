"""Decide ``correct``: hold what the window's calls produced, for the
scenarios the recorder sampled, against the plain reference.

Three layers (the configuration file gives each number its limit):

- ``qp_dev``, the assembly: the QP the program formed for a lane (cost,
  shared bounds, per-robot rows and bounds) against the reference's, worked
  out from the same states; each entry's gap over its own scale.
- ``solve_viol``, the solver: on every lane-iteration the program calls
  usable (converged, or within ``usable_pri_eps`` of feasible), the largest
  violation of the reference's constraints by the program's answer, each
  row's over its largest coefficient. Where the configuration's solver is
  the fixed-count ADMM, whose answer the algorithm defines, ``admm_dev`` and
  ``admm_dual_dev``: the answer and the duals it returns against the
  configuration's ADMM in float64 (``reference/admm.py``) from the same QP
  and warm start, each gap over the lane's largest entry; the warm start
  itself is held to the rollout's rule (a wrong one counts 1). Where the
  solver claims the optimum on its converged lanes, ``solve_dev_med`` and
  ``solve_dev_max``: the median and the largest gap between the program's
  curve and the reference's optimum there.
- ``fly_dev``, the closed loop: the curve each robot flies (the last usable
  iterate, else the previous curve) and the state ``fly`` produced, against
  the reference's flight of that curve plus the state noise drawn again from
  the episode's seed.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.admm import Admm, shift_matrix
from portbench.reference.assembly import BIG, Reference
from portbench.reference import qp as refqp

F64 = torch.float64
CHUNK = 1024


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero,
    as the tensor cores take their inputs), back in float64."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).to(F64)


def _rel(a, b, scale):
    return (a - b).abs() / scale


def _bounds_dev(p, r):
    """Gap of bounds: absent on both sides, or close over max(|r|, 1)."""
    absent = r.abs() >= BIG / 2
    return torch.where(absent, (p.abs() < BIG / 2).to(F64),
                       _rel(p, r, r.abs().clamp_min(1.0)))


def qp_dev(ref: Reference, prog, lane) -> torch.Tensor:
    """[B]: the largest gap between the program's QP ``prog`` (q, lb_s,
    ub_s, A_d, lb_d, ub_d) and the reference's ``lane``."""
    q, lb_s, ub_s, A_d, lb_d, ub_d = (t.to(F64) for t in prog)
    nd = ref.n_dec
    d_q = _rel(q[:, :nd], lane.q[:, :nd], lane.q[:, :nd].abs().amax(1, keepdim=True)
               .clamp_min(1.0)).amax(1)
    dev = torch.maximum(d_q, torch.maximum(_bounds_dev(lb_s, lane.lb_s).amax(1),
                                           _bounds_dev(ub_s, lane.ub_s).amax(1)))
    if ref.S:
        # each slack price is slack_cost * decay**k for a rank k its distance allows
        ks = torch.arange(ref.N, device=q.device)
        price = ref.slack_cost * ref.decay ** ks.to(F64)
        allowed = (ks >= lane.rank_lo[..., None]) & (ks <= lane.rank_hi[..., None])
        gap = _rel(q[:, nd:, None], price, price)
        dev = torch.maximum(dev, torch.where(allowed, gap, torch.full_like(gap, math.inf))
                            .amin(-1).amax(1))
    scale = lane.A_d.abs().amax(-1).clamp_min(1e-12)
    d_rows = torch.maximum((A_d - lane.A_d).abs().amax(-1) / scale,
                           torch.maximum(_bounds_dev(lb_d, lane.lb_d),
                                         torch.where(lane.ub_d >= BIG / 2,
                                                     (ub_d < BIG / 2).to(F64),
                                                     _rel(ub_d, lane.ub_d, lane.ub_scale))))
    d_rows = torch.where(lane.ambiguous, torch.zeros_like(d_rows), d_rows)
    return torch.maximum(dev, d_rows.amax(1))


def admm_dev(got, want) -> torch.Tensor:
    """[B]: the largest gap of a lane's entries over the lane's largest
    entry of ``want`` (at least 1); a non-finite entry counts infinite."""
    gap = (got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1.0)
    return gap.nan_to_num(nan=math.inf)


class Result:
    def __init__(self):
        self.numbers: Dict[str, float] = {}
        self.notes: List[str] = []
        self.samples: Dict[str, List[torch.Tensor]] = {}

    def worst(self, name: str, value) -> None:
        v = float(value)
        self.numbers[name] = max(self.numbers.get(name, 0.0), v if v == v else math.inf)

    def sample(self, name: str, values: torch.Tensor) -> None:
        self.samples.setdefault(name, []).append(values.detach().to(F64).flatten())

    def median(self, name: str, into: str) -> None:
        vals = torch.cat(self.samples.get(name, [torch.zeros(0, dtype=F64)]))
        self.numbers[into] = float(vals.nan_to_num(nan=math.inf).median()) if vals.numel() else 0.0


def judge(cfg: dict, recorder, device, tf32_reference: bool = False) -> Result:
    """tf32_reference: the control that puts the reference, with its products
    in TF32, in the program's place for the solver's answer (the
    configuration's ADMM with its row products in TF32, else the optimum
    rounded to TF32) and for the flight (the curve and its evaluation
    rounded to TF32); the assembly stays the program's."""
    ref = Reference(cfg, device)
    R, N, nd = ref.R, ref.N, ref.n_dec
    eps = float(cfg["usable_pri_eps"])
    claims_optimum = bool(cfg["solver"].get("claims_optimum", False))
    admm = Admm(ref, cfg["solver"], device) if cfg["solver"]["kind"] == "admm" else None
    others = torch.tensor([[j for j in range(R) if j != i] for i in range(R)], device=device)
    out = Result()
    for name in ("qp_dev", "solve_viol", "fly_dev") + (("admm_dev", "admm_dual_dev") if admm else ()) + \
            (("solve_dev_max", "solve_dev_med") if claims_optimum else ()):
        out.numbers[name] = 0.0
    counts = {"lane_iterations": 0, "usable": 0, "optimum_checked": 0, "flights": 0}

    # the QPs, lane by lane, in chunks of whole steps
    steps = recorder.steps
    batch: List[dict] = []

    def flush():
        if not batch:
            return
        x = torch.cat([torch.cat([s["pos"], s["vel"]], -1) for s in batch]).to(F64)  # [b, R, 6]
        goal = torch.cat([s["goals"] for s in batch]).to(F64)
        b = x.shape[0]
        xl = x.reshape(b * R, 6)
        nb = x[:, others].reshape(b * R, N, 6)
        gl = goal.reshape(b * R, 3)
        prev_z = None
        for it in range(ref.impc_iter):
            solves = [s["solves"][it] for s in batch]
            prog = [torch.cat([sv["qp"][j] for sv in solves]) for j in range(6)]
            z = torch.cat([sv["z"] for sv in solves])
            conv = torch.cat([sv["converged"] for sv in solves])
            pri = torch.cat([sv["pri_res"] for sv in solves])
            pred = xl[:, None].expand(-1, ref.H, 6) if it == 0 else \
                ref.predicted(prev_z[:, :nd].to(torch.float32).to(F64))
            lane = ref.lane_qp(xl, gl, nb, pred, it)
            out.worst("qp_dev", qp_dev(ref, prog, lane).max())
            finite = torch.isfinite(z).all(1)
            usable = conv | ((pri <= eps) & finite)
            counts["lane_iterations"] += z.shape[0]
            counts["usable"] += int(usable.sum())
            ne = ref.n_eq
            A = torch.cat([ref.tA_s.expand(z.shape[0], -1, -1), lane.A_d], 1)
            lb = torch.cat([lane.lb_s, lane.lb_d], 1)
            ub = torch.cat([lane.ub_s, lane.ub_d], 1)
            answer = z.to(F64)
            if admm is not None:
                # the configuration's ADMM from the program's QP and warm start
                warm = [None if solves[0]["warm"][j] is None else
                        torch.cat([sv["warm"][j] for sv in solves]).to(F64) for j in range(3)]
                args = [t.to(F64) for t in prog] + warm
                mine = admm.solve(*args)
                if tf32_reference:
                    low = admm.solve(*args, low=tf32)
                    answer = low.z
                    usable = (low.rel_pri < float(cfg["solver"]["eps_pri"])) & \
                        torch.isfinite(answer).all(1)
                out.worst("admm_dev", admm_dev(answer, mine.z).max())
                if not tf32_reference:
                    # the duals the next solve starts from
                    duals = [torch.cat([sv["duals"][j] for sv in solves]).to(F64) for j in (0, 1)]
                    out.worst("admm_dual_dev", torch.maximum(admm_dev(duals[0], mine.ys),
                                                             admm_dev(duals[1], mine.yd)).max())
            elif tf32_reference:
                opt = refqp.solve(ref.tP, lane.q, ref.tA_s[:ne], lane.lb_s[:, :ne],
                                  A[:, ne:], lb[:, ne:], ub[:, ne:])
                answer, usable = tf32(opt.z), opt.ok
            viol = refqp.violation(A, lb, ub, answer, A.abs().amax(-1).clamp_min(1e-12))
            out.worst("solve_viol", torch.where(usable, viol, torch.zeros_like(viol)).max())
            if claims_optimum and bool(conv.any()):
                idx = conv.nonzero()[:, 0]
                opt = refqp.solve(ref.tP, lane.q[idx], ref.tA_s[:ne], lane.lb_s[idx, :ne],
                                  A[idx, ne:], lb[idx, ne:], ub[idx, ne:])
                mine = tf32(opt.z) if tf32_reference else z[idx].to(F64)
                gap = (mine[:, :nd] - opt.z[:, :nd]).abs().amax(1)
                counts["optimum_checked"] += int(opt.ok.sum())
                out.worst("solve_dev_max", torch.where(opt.ok, gap, torch.zeros_like(gap)).max())
                out.sample("solve_dev", gap[opt.ok])
            prev_z = z
        batch.clear()

    for s in steps:
        batch.append(s)
        if len(batch) * s["pos"].shape[0] * R >= CHUNK:
            flush()
    flush()

    # the closed loop: the curve flown and the state it gives; for the ADMM
    # also the warm start each solve entered with
    shift = shift_matrix(ref) if admm is not None else None
    base = cfg["base"]["physical_limits"]
    pos_std, vel_std = float(base.get("pos_std", 0.0)), float(base.get("vel_std", 0.0))
    for e, ep in enumerate(recorder.episodes):
        last = recorder.episodes[e + 1]["first_step"] if e + 1 < len(recorder.episodes) \
            else len(steps)
        gen = torch.Generator(device=device).manual_seed(ep["seed"])
        shape = (ep["S"], R, 3)
        flown, before = None, None
        for s in steps[ep["first_step"]:last]:
            if admm is not None:
                out.worst("admm_dev", _warm_dev(s, before, shift, nd))
            before = s
            noise = None
            if pos_std > 0 or vel_std > 0:
                n_pos = pos_std * torch.randn(shape, generator=gen, dtype=torch.float32,
                                              device=device)
                n_vel = vel_std * torch.randn(shape, generator=gen, dtype=torch.float32,
                                              device=device)
                noise = (n_pos.index_select(0, ep["scenarios"]).to(F64),
                         n_vel.index_select(0, ep["scenarios"]).to(F64))
            out.worst("fly_dev", _flight_dev(ref, s, flown, noise, eps, nd, tf32_reference))
            flown = s["fly"]["coeffs"]
            counts["flights"] += s["fly"]["coeffs"].shape[0] * R
    if claims_optimum:
        out.median("solve_dev", "solve_dev_med")
    out.notes.append(", ".join(f"{k} {v}" for k, v in counts.items()))
    return out


def _warm_dev(s: dict, before, shift, nd: int) -> float:
    """The warm start of each of a step's solves against the rollout's rule:
    the first IMPC iteration enters with the previous step's flown curve
    shifted by one period (slacks 0) and its last duals, an episode's first
    step with zeros; a later iteration with the iteration before's answer
    and duals. The shift is judged by its gap (float32 rounding); a carried
    tensor that differs at all counts 1."""
    worst = 0.0
    for it, sv in enumerate(s["solves"]):
        x0, ys0, yd0 = sv["warm"]
        if it:
            src = s["solves"][it - 1]
            same = [(x0, src["z"]), (ys0, src["duals"][0]), (yd0, src["duals"][1])]
        elif before is None:
            same = [(t, torch.zeros_like(t)) for t in (x0, ys0, yd0)]
        else:
            coeffs = before["fly"]["coeffs"].reshape(x0.shape[0], nd).to(F64)
            want = torch.cat([coeffs @ shift.T, x0.new_zeros((x0.shape[0], x0.shape[1] - nd),
                                                              dtype=F64)], 1)
            worst = max(worst, float(admm_dev(x0.to(F64), want).max()))
            same = [(ys0, before["solves"][-1]["duals"][0]),
                    (yd0, before["solves"][-1]["duals"][1])]
        if not all(a is not None and b is not None and torch.equal(a, b) for a, b in same):
            worst = max(worst, 1.0)
    return worst


def _flight_dev(ref: Reference, s: dict, flown_before, noise, eps: float, nd: int,
                tf32_reference: bool = False):
    """The largest gap of one step's flight: a wrong choice of curve or a
    wrong age counts 1. tf32_reference: judge the reference's own flight with
    the curve and its evaluation rounded to TF32 in place of the program's."""
    R = ref.R
    f = s["fly"]
    its = s["solves"]
    zs = [sv["z"][:, :nd] for sv in its]
    usable = [sv["converged"] | ((sv["pri_res"] <= eps) & torch.isfinite(sv["z"]).all(1))
              for sv in its]
    best = torch.zeros_like(zs[0])
    any_ok = torch.zeros_like(usable[0])
    for z, u in zip(zs, usable):
        best = torch.where(u[:, None], z, best)
        any_ok = any_ok | u
    last_finite = torch.isfinite(zs[-1]).all(1)
    choice = torch.where(any_ok[:, None], best, torch.where(last_finite[:, None], zs[-1], best))
    flyable = any_ok | last_finite
    coeffs, success, fresh = (t.reshape(-1, *t.shape[2:]) for t in s["out"])
    wrong = not (torch.equal(coeffs.nan_to_num(), choice.nan_to_num())
                 and torch.equal(success, any_ok) and torch.equal(fresh, flyable))
    before = torch.zeros_like(coeffs) if flown_before is None \
        else flown_before.reshape(-1, coeffs.shape[-1])
    want = torch.where(flyable[:, None], coeffs, before)
    flat = lambda t: t.reshape(-1, *t.shape[2:])
    wrong = wrong or not torch.equal(flat(f["coeffs"]), want) or \
        not torch.equal(flat(f["fresh"]), flyable)
    pos, vel, age, had = ref.fly(flat(f["coeffs"]).to(F64), flat(f["prev_pos"]).to(F64),
                                 flat(f["fresh"]), flat(f["age"]), flat(f["has_curve"]))
    got_pos, got_vel = flat(f["pos"]).to(F64), flat(f["vel"]).to(F64)
    if tf32_reference:
        E0, E1 = ref.tE0, ref.tE1
        ref.tE0, ref.tE1 = tf32(E0), tf32(E1)
        got_pos, got_vel, _, _ = ref.fly(tf32(flat(f["coeffs"])), flat(f["prev_pos"]).to(F64),
                                         flat(f["fresh"]), flat(f["age"]), flat(f["has_curve"]))
        ref.tE0, ref.tE1 = E0, E1
    if noise is not None:
        pos, vel = pos + noise[0].reshape(-1, 3), vel + noise[1].reshape(-1, 3)
        if tf32_reference:
            got_pos, got_vel = got_pos + noise[0].reshape(-1, 3), got_vel + noise[1].reshape(-1, 3)
    dev = torch.maximum(_rel(got_pos, pos, pos.abs().clamp_min(1.0)).amax(),
                        _rel(got_vel, vel, vel.abs().clamp_min(1.0)).amax())
    # an age counts by the time the next flight evaluates the curve at
    t_next = lambda a: torch.clamp_max((a.to(F64) + 1) * ref.h, ref.curve.duration)
    wrong = wrong or not torch.allclose(t_next(flat(f["new_age"])), t_next(age), atol=1e-9) \
        or not torch.equal(flat(f["new_has"]), had)
    return max(float(dev) if dev == dev else math.inf, 1.0 if wrong else 0.0)
