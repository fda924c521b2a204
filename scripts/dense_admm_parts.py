"""Times the pieces of the dense ADMM (mpc_cbf_torch/ops/qp/admm.py) on the
GPU, at the shapes its callers give it: the cbf-fov QPs (n = 10, m = 44) at
32768 and 2048 lanes and the fov flagship QPs (n = 43, m = 211) at 8192.

    python3 scripts/dense_admm_parts.py        # from the repo root, ~40 s

Per shape: one solve_batch of 200 iterations; then, 100 calls each, the
Cholesky solve as the package does it (two batched triangular solves),
torch.cholesky_solve (MAGMA's batched potrs on the card), a product with an
explicit inverse, the two matrix-vector products with A and a clamp. Ends
with torch.profiler's tables of a 30-iteration solve by host and by device
time. Seeded random QPs of the callers' shapes; needs a CUDA GPU.
"""

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mpc_cbf_torch.types import QPBatch                      # noqa: E402
from mpc_cbf_torch.ops.qp.admm import ADMMConfig, solve_batch  # noqa: E402
from mpc_cbf_torch.ops.qp.ipm import chol_factor, chol_solve   # noqa: E402

DEV = "cuda"


def random_qps(B: int, n: int, m: int, seed: int = 0) -> QPBatch:
    g = torch.Generator(device=DEV).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=DEV)
    M = r(B, n, n)
    P = M @ M.transpose(-1, -2) / n + 0.5 * torch.eye(n, device=DEV)
    A = r(B, m, n)
    mid = (A @ (0.1 * r(B, n))[..., None])[..., 0]
    return QPBatch(P, r(B, n), A, mid - 0.3, mid + 0.3)


def host_ms(fn, reps: int = 3) -> float:
    """Mean host time of fn, each timing ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_admm_parts: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for B, n, m in ((32768, 10, 44), (2048, 10, 44), (8192, 43, 211)):
        qp = random_qps(B, n, m)
        print(f"B = {B}, n = {n}, m = {m}: solve_batch, 200 iterations "
              f"{host_ms(lambda: solve_batch(qp, ADMMConfig(iters=200)), 2):.2f} ms", flush=True)
        L, _ = chol_factor(qp.P + 0.1 * torch.eye(n, device=DEV))
        rhs, col = qp.q, qp.q[..., None]
        Minv = torch.cholesky_inverse(L)
        parts = {
            "chol_solve (two solve_triangular)": lambda: chol_solve(L, rhs),
            "torch.cholesky_solve": lambda: torch.cholesky_solve(col, L),
            "explicit inverse times rhs": lambda: Minv @ col,
            "A x": lambda: qp.A @ col,
            "A' y": lambda: qp.lb[..., None, :] @ qp.A,
            "clamp": lambda: torch.clamp(qp.lb, qp.lb, qp.ub),
        }
        for name, fn in parts.items():
            print(f"  100 x {name}: {host_ms(lambda: [fn() for _ in range(100)]):.2f} ms")
    qp = random_qps(32768, 10, 44)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve_batch(qp, ADMMConfig(iters=30))
        torch.cuda.synchronize()
    for key in ("self_cpu_time_total", "self_cuda_time_total"):
        print(prof.key_averages().table(sort_by=key, row_limit=10, max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())
