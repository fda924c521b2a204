"""Drive the program: build its closed loop as its command line does, make
each episode's instance from the seed, and run the window.

Fleet traffic calls ``MultiAgentSim.rollout`` over whole episodes of many
scenarios at once.
"""

from __future__ import annotations

import copy
import time
from typing import List

import numpy as np
import torch


def build(cfg: dict, device):
    """The program's closed loop for this configuration, built by
    ``apps/run_sim.build_sim`` as ``run_sim`` and ``sweep`` build it."""
    from mpc_cbf_torch.apps.run_sim import build_sim

    sim, _ = build_sim(copy.deepcopy(cfg["base"]), cfg["controller"], int(cfg["robots"]),
                       int(cfg["solver"]["iters"]), device=device)
    return sim


def circle_rotate(R: int, radius: float) -> tuple:
    """(starts, goals) [R, 3]: R robots evenly on a circle facing its
    centre (yaw in [0, 2 pi)), each bound for the next one's start, yaw
    included (the sweep's instance)."""
    ang = 2 * np.pi * np.arange(R) / R
    so = np.stack([radius * np.cos(ang), radius * np.sin(ang), (ang + np.pi) % (2 * np.pi)], -1)
    return so, np.roll(so, -1, axis=0)


class Episode:
    """One draw of the traffic: starts with noise, goals, and the seed of
    the generator that draws the state noise while it is flown."""

    def __init__(self, rng: np.random.Generator, traffic: dict, R: int, device):
        S = int(traffic["scenarios"])
        so, sf = circle_rotate(R, float(traffic["radius"]))
        noise = rng.normal(0.0, float(traffic["start_noise"]), (S, R, 2))
        start = so[None] + np.concatenate([noise, np.zeros((S, R, 1))], -1)
        t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
        self.pos, self.vel = t(start), t(np.zeros((S, R, 3)))
        self.goals = t(np.broadcast_to(sf, (S, R, 3)))
        self.noise_seed = int(rng.integers(0, 2 ** 62))
        self.device = device
        self.S = S

    def generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.noise_seed)


class Recorder:
    """Keeps, for a sample of scenarios drawn from the seed, what each of
    the program's calls was given and gave back: the states and goals of
    each control step, each solve's QP and answer, each fly's inputs and
    state. Only while ``on``; indexing a few lanes is the only device work."""

    def __init__(self, sim, R: int):
        self.R = R
        self.on = False
        self.steps: List[dict] = []
        self.episodes: List[dict] = []
        self._lanes = self._scn = None
        simpc = sim._structured_impc()
        self._wrap(sim, "control_step", self._control_step)
        self._wrap(simpc.op_qp, "solve", self._solve)
        self._wrap(sim, "fly", self._fly)

    @staticmethod
    def _wrap(obj, attr, hook):
        fn = getattr(obj, attr)
        object.__setattr__(obj, attr, lambda *a, **k: hook(fn, *a, **k))

    def episode(self, ep: Episode, scenarios: np.ndarray) -> None:
        scn = torch.as_tensor(scenarios, device=ep.pos.device)
        self._scn = scn
        self._lanes = (scn[:, None] * self.R + torch.arange(self.R, device=scn.device)).reshape(-1)
        if self.on:
            self.episodes.append({"seed": ep.noise_seed, "S": ep.S, "scenarios": scn,
                                  "first_step": len(self.steps)})

    def _take(self, t, lanes: bool):
        idx = self._lanes if lanes else self._scn
        return None if t is None else t.index_select(0, idx)

    def _control_step(self, fn, states, goals, *a, **k):
        if self.on:
            self.steps.append({"pos": self._take(states.pos, False),
                               "vel": self._take(states.vel, False),
                               "goals": self._take(goals, False), "solves": []})
        out = fn(states, goals, *a, **k)
        if self.on:
            self.steps[-1]["out"] = tuple(self._take(t, False) for t in out[:3])
        return out

    def _solve(self, fn, *a, **k):
        sol = fn(*a, **k)
        if self.on:
            warm = list(a[6:9]) + [None] * (3 - len(a[6:9]))
            warm = [k.get(name, w) for name, w in zip(("x0", "ys0", "yd0"), warm)]
            self.steps[-1]["solves"].append({
                "qp": tuple(self._take(t, True) for t in a[:6]),
                "warm": tuple(self._take(t, True) for t in warm),
                "z": self._take(sol.z, True), "converged": self._take(sol.converged, True),
                "pri_res": self._take(sol.pri_res, True),
                "duals": tuple(self._take(getattr(sol, f, None), True) for f in ("ys", "yd"))})
        return sol

    def _fly(self, fn, coeffs, prev, fresh, generator=None, age=None, has_curve=None):
        out = fn(coeffs, prev, fresh, generator, age, has_curve)
        if self.on:
            lead = fresh.shape
            age = torch.zeros(lead, dtype=torch.int64, device=fresh.device) if age is None else age
            has_curve = torch.zeros_like(fresh) if has_curve is None else has_curve
            st, new_age, new_has = out
            self.steps[-1]["fly"] = {
                "coeffs": self._take(coeffs, False), "prev_pos": self._take(prev.pos, False),
                "fresh": self._take(fresh, False), "age": self._take(age, False),
                "has_curve": self._take(has_curve, False), "pos": self._take(st.pos, False),
                "vel": self._take(st.vel, False), "new_age": self._take(new_age, False),
                "new_has": self._take(new_has, False)}
        return out


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def sync_clock() -> float:
    sync()
    return time.perf_counter()


class Fleet:
    """Whole episodes of ``scenarios`` teams through ``rollout``."""

    def __init__(self, sim, traffic: dict, R: int, rng: np.random.Generator, device,
                 recorder: Recorder):
        self.sim, self.traffic, self.R, self.rng = sim, traffic, R, rng
        self.device, self.rec = device, recorder
        self.steps = int(traffic["episode_steps"])
        self.S = int(traffic["scenarios"])
        self.check_scenarios = int(traffic["check_scenarios"])

    def _episode(self, steps: int):
        ep = Episode(self.rng, self.traffic, self.R, self.device)
        scn = np.sort(self.rng.choice(self.S, self.check_scenarios, replace=False))
        self.rec.episode(ep, scn)
        from mpc_cbf_torch.types import State
        return self.sim.rollout(State(pos=ep.pos, vel=ep.vel), ep.goals, steps,
                                generator=ep.generator())

    def warm_up(self) -> None:
        """Every shape the window uses: both IMPC iterations, cold and warm
        steps, at the full lane count."""
        self._episode(int(self.traffic["warmup_steps"]))
        sync()

    def window(self, seconds: float) -> dict:
        usable, lane_steps, steps, ends = [], 0, 0, []
        t0 = sync_clock()
        while True:
            res = self._episode(self.steps)
            usable.append(res.success.sum())
            lane_steps += res.success.numel()
            steps += self.steps
            del res
            ends.append(sync_clock())
            if ends[-1] - t0 >= seconds:
                break
        ok = int(torch.stack(usable).sum())
        return {"window_s": ends[-1] - t0, "steps": steps, "lanes": self.S * self.R,
                "lane_steps": lane_steps, "usable": ok,
                "episode_s": list(np.diff([t0] + ends))}

    def traced(self, steps: int, spans) -> None:
        """Whole steps inside one span, the device drained before it ends."""
        with spans.span("traced"):
            self._episode(steps)
            sync()

