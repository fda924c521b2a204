"""mpc_cbf_torch — the PyTorch/CUDA port of ``mpc_cbf_tpu``.

The JAX package stays the reference; this package keeps its module paths
and class names so each counterpart is easy to find. Plain tensor code is
PyTorch, and the one Pallas kernel of the JAX package (the fused
structured-ADMM loop, ``mpc_cbf_tpu/ops/qp/pallas_admm.py``) is a CUDA C++
kernel for Hopper (``csrc/structured_admm.cu``, built by ``_build.py``).

It covers every module of the JAX package: the fov/connectivity MPC-CBF
control step through ``controllers.mpc_cbf.StructuredIMPC`` with the
structured ADMM (``ops.qp.structured``, optionally with the f64 active-set
polish of ``ops.qp.polish``) or the Mehrotra IPM family (``ops.qp.ipm``),
the dense ADMM and every controller on it, the closed loops, the mesh,
scenario sharding and the multi-process helpers of ``parallel``, the exact
oracle (``ops.qp.oracle``), checkpoint/resume (``utils.checkpoint``), the
deployment node graph (``deploy``) and the apps (``run_sim``, ``sweep``,
``generate_instances``, ``statistics``, ``plot_results``,
``audit_failed_lanes``).
"""

__version__ = "0.1.0"

import torch as _torch

# Reduced-precision f32 GEMMs corrupted QP cost vectors under batching in
# the reference (mpc_cbf_tpu/__init__.py pins 'highest' for the same
# reason), so every f32 matmul and convolution runs in full f32: no TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
