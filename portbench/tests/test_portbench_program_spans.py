"""The program's own spans (``mpc_cbf_torch.utils.profiling``, ``mpc::``
events) beside the benchmark's (``pb::``) on the CPU: a trace that holds
both keeps the benchmark's spans alone in ``Trace.host`` and its labels, and
a traced run with the program's spans on reports the same metrics and
breakdown keys as one with them off."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpc_cbf_torch.utils import profiling
from portbench.tests.test_portbench_run import CELLS, harness, last_line
from portbench.trace import Spans, Trace


def test_program_spans_stay_out_of_the_benchmarks_labels():
    spans = Spans(sync=False)
    with profiling.recording() as records, profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("traced"), profiling.step():
            with profiling.span("solve"), spans.span("solve"), profiling.span("admm.kernel"):
                torch.ones(64).sum()
    assert [r.name for r in records] == ["step", "solve", "admm.kernel"]
    tr = Trace(prof)
    assert sorted(n for n, _, _ in tr.host) == ["solve", "traced"]
    lo, hi = tr.window()
    assert set(tr.labels_at(list(range(lo, hi, max(1, (hi - lo) // 50))))) <= {"traced", "solve"}
    assert set(tr.breakdown()) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_with_program_spans_on(tmp_path, capsys, cell):
    mod, bench = harness(tmp_path)
    argv = ["--workload", cell + ".tiny", "--seed", str(2 ** 33 + 3), "--seconds", "0.1",
            "--trace", "1"]
    assert mod.main(argv, device="cpu", bench_path=bench) == 0
    off = last_line(capsys)
    with profiling.recording() as records:
        assert mod.main(argv, device="cpu", bench_path=bench) == 0
    on = last_line(capsys)
    assert {r.name for r in records} >= {"step", "assembly", "solve", "fly"}
    assert set(on["metrics"]) == set(off["metrics"]) and on["correct"] is off["correct"] is True
    assert set(on["breakdown"]) == set(off["breakdown"])
    assert {k for k, _ in on["breakdown"]["idle_gaps"]} <= \
        {"traced", "control_step", "assembly", "solve", "fly", "outside the benchmark's spans"}
