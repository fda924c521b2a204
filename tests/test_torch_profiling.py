"""The program's spans (mpc_cbf_torch/utils/profiling.py): off by default at
no cost, nested records with their parents and step ids, ``mpc::`` events
under torch.profiler and in ``trace``'s file, the spans a CPU control step
records through the ADMM and the IPM, and results that do not depend on
whether the spans are on."""

import dataclasses
import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpc_cbf_torch.controllers import (
    BezierMPCOperator, BezierParams, ConnectivityIMPCCBF, FovIMPCCBF, IMPCParams, MPCParams)
from mpc_cbf_torch.ops.cbf import ConnectivityCBF, FovCBF
from mpc_cbf_torch.ops.qp import IPM_F32_ENTRY, StructuredConfig, fused_admm
from mpc_cbf_torch.parallel import MultiAgentSim
from mpc_cbf_torch.types import State
from mpc_cbf_torch.utils import instances, profiling
from mpc_cbf_torch.utils.profiling import annotate, recording, span, step, trace

CPU = torch.device("cpu")


def _names(records):
    return [r.name for r in records]


def test_off_span_is_one_shared_noop():
    assert profiling._records is None
    a, b = span("a"), span("b")
    assert a is b is step() is annotate("c")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with a, step():
            torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name.startswith(profiling.PREFIX)]
    with recording() as records:
        pass
    assert records == [] and profiling._records is None


def test_spans_nest_with_parent_and_step():
    with recording() as records:
        with span("outer"):
            with step():
                with span("a"):
                    with span("b"):
                        pass
                with span("c"):
                    pass
            with step():
                with span("d"):
                    pass
        with span("after"):
            pass
    assert span("x") is profiling._OFF
    assert _names(records) == ["outer", "step", "a", "b", "c", "step", "d", "after"]
    assert [r.parent for r in records] == [-1, 0, 1, 2, 1, 0, 5, -1]
    assert [r.step for r in records] == [-1, 0, 0, 0, 0, 1, 1, -1]
    for r in records:
        assert 0 < r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_recordings_nest_and_restore():
    with recording() as outer:
        with step():
            with recording() as inner:
                with step(), span("x"):
                    pass
            with span("y"):
                pass
    assert [(r.name, r.parent, r.step) for r in inner] == [("step", -1, 0), ("x", 0, 0)]
    assert [(r.name, r.parent, r.step) for r in outer] == [("step", -1, 0), ("y", 0, 0)]


def test_spans_are_profiler_events_and_in_trace_file(tmp_path):
    with recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with step(), span("phase"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"mpc::step", "mpc::phase"} <= names
    with trace(str(tmp_path)) as records:
        with annotate("phase"):
            torch.arange(4).sum()
    assert _names(records) == ["phase"]
    files = list(tmp_path.glob("*.json"))
    assert files and "mpc::phase" in {e.get("name") for f in files
                                      for e in json.loads(f.read_text())["traceEvents"]}


def _sim(mode, cfg, agents=3):
    """A float64 CPU closed loop of a small team: connectivity or fov."""
    m = MPCParams()
    op = BezierMPCOperator(BezierParams(), m, dim=3, device=CPU, dtype=torch.float64)
    if mode == "fov":
        ctrl = FovIMPCCBF(op, FovCBF(math.radians(120.0), 0.3, 6.0, m.v_min, m.v_max),
                          IMPCParams(slack_mode=True), agents - 1,
                          box_half_extents=(0.1, 0.1, 0.0))
    else:
        ctrl = ConnectivityIMPCCBF(op, ConnectivityCBF(1.0, 4.0, m.v_min, m.v_max),
                                   IMPCParams(), agents - 1)
    return MultiAgentSim(ctrl, agents, structured=True, solver_cfg=cfg)


def _start(scenarios=2, agents=3):
    tasks = instances.circle_rotate_instance(agents, radius=2.5)["tasks"]
    so = torch.as_tensor(tasks["so"], dtype=torch.float64).expand(scenarios, agents, 3)
    return State(so.clone(), torch.zeros_like(so)), \
        torch.as_tensor(tasks["sf"], dtype=torch.float64).expand(scenarios, agents, 3)


def _count(records, name):
    return sum(r.name == name for r in records)


def _under(records, r, name):
    while r.parent >= 0:
        r = records[r.parent]
        if r.name == name:
            return True
    return False


ADMM = {"plain": StructuredConfig(iters=30), "tail": StructuredConfig(iters=30, iters_tail=10),
        "polish": StructuredConfig(iters=30, polish=True)}


@pytest.mark.parametrize("which", list(ADMM))
def test_admm_control_step_spans(which):
    sim = _sim("connectivity", ADMM[which])
    simpc = sim._structured_impc()
    init, goals = _start()
    with recording() as records:
        sim.control_step(init, goals)
    impc = sim.controller.impc.impc_iter
    phases = len(simpc.op_qp.phases)
    assert _count(records, "step") == 1 and records[0].name == "step"
    assert all(r.step == 0 for r in records)
    assert _count(records, "assembly") == 1 + impc
    assert _count(records, "solve") == impc
    for name in ("admm.scale", "admm.unscale"):
        assert _count(records, name) == impc
    for name in ("admm.operand", "admm.kernel"):
        assert _count(records, name) == impc * phases
    for r in records:
        if r.name.startswith("admm."):
            assert _under(records, r, "solve")
    assert _count(records, "fly") == 0


def test_ipm_iterations_are_counted_per_chunk():
    cfg = dataclasses.replace(IPM_F32_ENTRY, iters=5, chunk=4)
    sim = _sim("fov", cfg)
    init, goals = _start(scenarios=3)                 # 9 lanes: chunks of 4, 4, 1
    with recording() as records:
        sim.rollout(init, goals, 2)
    impc, chunks, steps = sim.controller.impc.impc_iter, 3, 2
    assert _count(records, "step") == _count(records, "fly") == steps
    assert _count(records, "ipm.iteration") == cfg.iters * chunks * impc * steps
    assert _count(records, "ipm.reduce") == _count(records, "ipm.final") == chunks * impc * steps
    for r in records:
        if r.name.startswith("ipm."):
            assert _under(records, r, "solve") and r.step in (0, 1)


@pytest.mark.parametrize("mode", ["connectivity", "fov"])
def test_results_do_not_depend_on_tracing(mode):
    cfg = StructuredConfig(iters=30) if mode == "connectivity" else \
        dataclasses.replace(IPM_F32_ENTRY, iters=5, chunk=4)
    init, goals = _start()
    counter = fused_admm.structured_admm_iterations.launches_by_variant
    runs = []
    for on in (False, True, False):
        before = dict(counter)
        if on:
            with recording() as records:
                res = _sim(mode, cfg).rollout(init, goals, 2)
            assert records
        else:
            res = _sim(mode, cfg).rollout(init, goals, 2)
        runs.append((res, {k: counter[k] - before[k] for k in counter}))
    (off, n_off), (on, n_on), (off2, _) = runs
    assert n_on == n_off
    for field in ("traj_pos", "traj_vel", "success", "coeffs"):
        torch.testing.assert_close(getattr(on, field), getattr(off, field), rtol=0, atol=0)
        torch.testing.assert_close(getattr(off2, field), getattr(off, field), rtol=0, atol=0)
