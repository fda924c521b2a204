"""mpc_cbf_torch — the PyTorch/CUDA port of ``mpc_cbf_tpu``.

The JAX package stays the reference; this package keeps its module paths
and class names so each counterpart is easy to find. Plain tensor code is
PyTorch, and the one Pallas kernel of the JAX package (the fused
structured-ADMM loop, ``mpc_cbf_tpu/ops/qp/pallas_admm.py``) is a CUDA C++
kernel for Hopper (``csrc/structured_admm.cu``, built by ``_build.py``).

Ported so far: the fov/connectivity MPC-CBF control step through
``controllers.mpc_cbf.StructuredIMPC`` with the structured ADMM
(``ops.qp.structured``, slice 1) or the Mehrotra IPM family
(``ops.qp.ipm``: the f32 entry, the f64 IPM and the f32 -> f64 hybrid,
slice 2), and the structured closed loop ``parallel.MultiAgentSim``.
"""

__version__ = "0.1.0"

import torch as _torch

# Reduced-precision f32 GEMMs corrupted QP cost vectors under batching in
# the reference (mpc_cbf_tpu/__init__.py pins 'highest' for the same
# reason), so every f32 matmul and convolution runs in full f32: no TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
