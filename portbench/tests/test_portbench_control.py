"""The controls of the correctness check on the card: the program with
PyTorch's TF32 path on, the reference with its products in TF32 in the
program's place, and (where the solver builds the ADMM's operand C) the
program with C built in float32, each come out not correct, where the sound
run comes out correct. The cells keep their lanes and episodes: with
episodes of 3 steps the first control's assembly gap read 8.2e-4 at conn8,
under its limit, where the cell's own episodes read 0.06 and more. A
3-second window, one or two episodes, keeps a test short."""

import json

import pytest
import torch

from portbench.tests.test_portbench_run import CELLS, ROOT, harness, last_line

SHORT = {"warmup_steps": 1, "check_scenarios": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("control", [None, "tf32", "reference_tf32", "c_float32"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(tmp_path, capsys, cuda_device, cell, control):
    if control == "c_float32" and not cell.startswith("conn8"):
        pytest.skip("the configuration's solver builds no ADMM operand C")
    # the TF32 control switches PyTorch's process-wide precision flags
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        run_once(tmp_path, capsys, cuda_device, cell, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def run_once(tmp_path, capsys, cuda_device, cell, control):
    mod, bench = harness(tmp_path)
    spec = json.loads(bench.read_text())
    traffic = next(w["traffic"] for w in spec["workloads"] if w["name"] == cell + ".tiny")
    path = tmp_path / "portbench" / "workloads" / f"{traffic}.json"
    # the cell's own traffic, with a short warm-up
    t = json.loads((ROOT / "portbench" / "workloads" / f"{traffic.removesuffix('_tiny')}.json")
                   .read_text())
    t.update(SHORT)
    path.write_text(json.dumps(t))
    args = ["--workload", cell + ".tiny", "--seed", "3000000901", "--seconds", "3", "--trace", "0"]
    rc = mod.main(args + (["--control", control] if control else []), device=cuda_device,
                  bench_path=bench)
    out = last_line(capsys)
    assert rc == 0
    assert out["correct"] is (control is None), out["check"]
