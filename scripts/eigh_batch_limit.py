"""Finds how many matrices one torch.linalg.eigh call takes on the GPU.

    python3 scripts/eigh_batch_limit.py        # from anywhere, ~15 s

For float32 symmetric matrices of size 4, 8 and 32 it calls
torch.linalg.eigh on batches of 1024 to 65536 and prints the time or the
library's error. mpc_cbf_torch/ops/cbf.py::EIGH_MAX_BATCH is set from it.
Needs a CUDA GPU.
"""

import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("eigh_batch_limit: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for n in (4, 8, 32):
        for batch in (1024, 4096, 8192, 16384, 32767, 32768, 65536):
            A = torch.randn(batch, n, n, device="cuda")
            A = A + A.transpose(-1, -2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                torch.linalg.eigh(A)
            except RuntimeError as err:            # torch._C._LinAlgError is one
                print(f"n = {n}, batch {batch}: FAILS, {str(err)[:70]}", flush=True)
                continue
            torch.cuda.synchronize()
            print(f"n = {n}, batch {batch}: {(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
