"""Package rules of mpc_cbf_torch: it imports neither jax nor mpc_cbf_tpu
(checked on the source, since this test process already imports jax through
tests/conftest.py), and its operators refuse what they are not built for.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import mpc_cbf_torch
from mpc_cbf_torch.controllers import StructuredIMPC
from mpc_cbf_torch.ops.qp.structured import StructuredConfig

import torch_parity_cases as cases

PKG = Path(mpc_cbf_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "mpc_cbf_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_package_imports_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 47
    assert {"admm.py", "cbf_qp.py", "particle_filter.py", "run_sim.py", "config.py",
            "polish.py", "linsolve.py", "oracle.py", "sweep.py", "collision_shapes.py",
            "svm.py", "profiling.py", "logging.py", "checkpoint.py", "tree.py",
            "generate_instances.py", "statistics.py", "plot_results.py",
            "audit_failed_lanes.py", "runtime.py", "nodes.py", "mesh.py",
            "distributed.py"} <= {f.name for f in files}
    assert {"deploy/__init__.py", "deploy/nodes.py", "parallel/mesh.py",
            "utils/checkpoint.py"} <= {str(f.relative_to(PKG)) for f in files}
    bad = [(f.relative_to(PKG), mod) for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"mpc_cbf_torch imports the JAX side: {bad}"


def test_chip_smoke_imports_no_jax():
    script = PKG.parent / "chip_smoke.py"
    mods = list(_imported_modules(script))
    assert "mpc_cbf_torch" in {m.split(".")[0] for m in mods}
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_torch_distributed_worker_imports_no_jax():
    """The two-process test's worker runs in processes of torch alone."""
    mods = list(_imported_modules(PKG.parent / "tests" / "torch_distributed_worker.py"))
    assert "mpc_cbf_torch.parallel.distributed" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_precision_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_unported_solver_options_raise():
    """polish=True builds the polished ADMM (ported); a configuration that is
    no solver's is refused."""
    ctrl = cases.torch_controller("fov", "cpu", torch.float32)
    simpc = StructuredIMPC(ctrl, StructuredConfig(iters=4, iters_tail=2, polish=True))
    for op in (simpc.op_qp, simpc.op_qp_tail):
        assert callable(op.solve_polished)
        assert op._guards.group_mask.shape == (ctrl.S, op.m_s + op.m_d)
    with pytest.raises(NotImplementedError):
        StructuredIMPC(ctrl, object())


def test_solve_refuses_other_dtype():
    simpc = StructuredIMPC(cases.torch_controller("connectivity", "cpu", torch.float32),
                           StructuredConfig(iters=4))
    op = simpc.op_qp
    B = 2
    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    with pytest.raises(ValueError):
        op.solve(z(B, op.n), z(B, op.m_s), z(B, op.m_s), z(B, op.m_d, op.n),
                 z(B, op.m_d), z(B, op.m_d))


def test_plain_loop_option_matches_default_on_cpu():
    """use_kernel=False forces the twin; on CPU tensors the default takes
    the twin too, so both give the same bits."""
    rng = np.random.default_rng(5)
    pos, vel, ref, blob, mask = cases.conn_inputs(rng, 3)
    T = lambda a: torch.as_tensor(a, dtype=torch.float32)
    from mpc_cbf_torch.types import State
    args = (State(T(pos), T(vel)), T(ref), T(blob), torch.as_tensor(mask))
    outs = [StructuredIMPC(cases.torch_controller("connectivity", "cpu", torch.float32),
                           StructuredConfig(iters=20, use_kernel=k)).optimize_batch(*args)
            for k in (True, False)]
    torch.testing.assert_close(outs[0].coeffs, outs[1].coeffs, rtol=0, atol=0)
