// Fused structured-ADMM iteration loop, hand-written for Hopper (sm_90a):
// the entry point, which picks the kernel of a shape and launches it.
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170). One
// launch runs one rho phase of the fixed-count ADMM loop of
// StructuredQPOperator._solve (mpc_cbf_tpu/ops/qp/structured.py:442-463)
// for every lane of the batch (a lane is one QP). Per iteration:
//   RHS = sigma x - q + A_s'(rho_s z_s - y_s) + A_d'(rho_d z_d - y_d)
//   xt  = M_b^-1 RHS,  M_b = M_s + A_d' diag(rho_d) A_d
//   z   = clip(alpha [A_s; A_d] xt + (1 - alpha) z + y / rho, lb, ub)
//   y  += rho (alpha [A_s; A_d] xt + (1 - alpha) z_old - z)
//   x   = alpha xt + (1 - alpha) x
// State and operands are float32. The x-update comes in two forms (the
// caller makes its operand, ops/qp/structured.py). The tiled kernel keeps
// the TPU kernel's Woodbury form, S = Ms_inv RHS, t = A_d S, xt = S - WK t,
// with the two products and the difference in float64 (as the plain twin in
// ops/qp/fused_admm.py does): S and WK t nearly cancel, and float32 rounding
// there costs the fov flagship 3 to 5 points of usable lanes. The other
// kernels take the lane's C = M_b^-1 in float64, factored by the caller on
// the device, and compute xt = C RHS in float64: one [n, n] matrix a lane
// where the Woodbury form needs an [m_d, m_d] inverse, and no float32
// rounding of S and t.
//
// What bounds the loop on an H100 is its arithmetic where the lane's rows
// stay on chip (every operand is read from device memory once a launch and
// then used in each of the 32 to 550 iterations; the count is worked out in
// structured_admm_tiled.cu), and the bytes of the rows where they do not.
// Four kernels, chosen from the shape alone by structured_admm_variant();
// every compiled instance of tiled and folded is a shape that takes it:
//   tiled     structured_admm_tiled.cu: compiled per shape (connectivity,
//             λ₂/CLF connectivity), 32 lanes a block, the two products with
//             the shared A_s on the TF32 tensor cores (3xTF32) with the
//             rows' state in the registers that receive their sums. Takes WK.
//   folded    structured_admm_folded.cu: compiled per shape (the fov flagship,
//             32-agent fov and connectivity), one lane a block, [A_s; A_d]
//             and the rows' state in registers.
//   generic   structured_admm_generic.cu: shapes known only at run time, one
//             lane a block with [A_s; A_d] in registers (the sweep's and
//             run_sim's connectivity teams, the 24-agent fov team).
//   cluster   structured_admm_cluster.cu: every larger lane, in registers on
//             one SM where the lane's rows fit an SM's registers with two
//             lanes on it (one lane a block of 8 warps, no cluster, both
//             exchanges in the block's shared memory: the connectivity teams
//             of 30-33 robots, conn32's (67, 157, 62) among them; at conn32 an
//             iteration on half an SM a lane was latency that nothing hid,
//             ~1.86 us, and two lanes an SM take a step's launches in 144.6
//             ms against 369.2), else one lane a thread-block cluster: the
//             rows in the blocks' registers where they fit, else streamed
//             from device memory once an iteration.
// A shape none of them holds (a lane whose vectors and row state exceed the
// shared memory of a cluster: fov teams past about 1 000 agents) has no
// kernel: the wrapper raises.

#include "structured_admm.cuh"

// The kernel a shape takes: tiled or folded where one takes it, else generic
// where one of its layouts holds the shape, else cluster; kNone where none
// does. The tiled shapes are the ones that take WK (fused_admm.TILED_SHAPES).
extern "C" int structured_admm_variant(int n, int m_s, int m_d) {
  if (structured_admm_tiled_has(n, m_s, m_d)) return kTiled;
  if (structured_admm_folded_has(n, m_s, m_d)) return kFolded;
  if (structured_admm_generic_has(n, m_s, m_d)) return kGeneric;
  if (structured_admm_cluster_has(n, m_s, m_d)) return kCluster;
  return kNone;
}

// Launches one rho phase on `stream` of `device` (arrays as in AdmmArgs; WK
// for the tiled kernel, C for the others, the other pointer null).
// variant < 0: the kernel of structured_admm_variant(); else that kernel,
// for measurements and tests (generic and cluster hold any shape that fits
// them; tiled and folded only their compiled shapes). Returns a cudaError_t
// (0 = launched; cudaErrorInvalidValue for the operand the kernel does not
// take, or a shape it has no instance of). The
// calling thread's current device is left as it was found.
extern "C" int structured_admm_launch(
    const float* Ms_inv, const float* A_s, const float* rho_s, const float* q,
    const float* lbs, const float* ubs, const float* Ad, const float* lbd,
    const float* ubd, const float* rho_d, const float* WK, const double* C, const float* x0,
    const float* zs0, const float* zd0, const float* ys0, const float* yd0,
    float* x_out, float* zs_out, float* zd_out, float* ys_out, float* yd_out,
    int B, int n, int m_s, int m_d, int iters, float sigma, float alpha,
    int device, void* stream, int variant) {
  if (B <= 0 || n <= 0 || m_s < 0 || m_d <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdmmArgs a{Ms_inv, A_s, rho_s, q, lbs, ubs, Ad, lbd, ubd, rho_d, WK, C, x0, zs0,
                   zd0, ys0, yd0, x_out, zs_out, zd_out, ys_out, yd_out, B, n, m_s, m_d,
                   iters, sigma, alpha};
  if (variant < 0) variant = structured_admm_variant(n, m_s, m_d);
  if ((variant == kTiled) != (WK != nullptr) || (variant == kTiled) == (C != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (variant == kTiled)
    rc = structured_admm_tiled_launch(a, s);
  else if (variant == kFolded)
    rc = structured_admm_folded_launch(a, s);
  else if (variant == kGeneric)
    rc = structured_admm_generic_launch(a, s);
  else if (variant == kCluster)
    rc = structured_admm_cluster_launch(a, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (previous != device) cudaSetDevice(previous);
  return rc;
}

extern "C" const char* structured_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
