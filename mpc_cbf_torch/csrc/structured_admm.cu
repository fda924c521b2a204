// Fused structured-ADMM iteration loop, hand-written for Hopper (sm_90a):
// the entry point, and the two first versions of the kernel (resident,
// streamed), which run where a caller names them or no other kernel holds
// the shape.
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170). One
// launch runs one rho phase of the fixed-count ADMM loop of
// StructuredQPOperator._solve (mpc_cbf_tpu/ops/qp/structured.py:442-463)
// for every lane of the batch (a lane is one QP). Per iteration:
//   RHS = sigma x - q + A_s'(rho_s z_s - y_s) + A_d'(rho_d z_d - y_d)
//   S   = Ms_inv RHS,  t = A_d S,  xt = S - WK t   (folded Woodbury solve)
//   z   = clip(alpha [A_s; A_d] xt + (1 - alpha) z + y / rho, lb, ub)
//   y  += rho (alpha [A_s; A_d] xt + (1 - alpha) z_old - z)
//   x   = alpha xt + (1 - alpha) x
// State and operands are float32. The two Woodbury products Ms_inv RHS and
// WK t, and the difference S - WK t, accumulate in float64 (as the plain
// twin in ops/qp/fused_admm.py does): S and WK t nearly cancel, and float32
// rounding there costs the fov flagship 3 to 5 points of usable lanes.
//
// What bounds the loop on an H100 is its arithmetic, not its bytes: every
// operand is read from device memory once a launch and then used in each of
// the 32 to 550 iterations (the count is worked out in
// structured_admm_tiled.cu). Three kernels, chosen from the shape alone by
// structured_admm_variant():
//   tiled     structured_admm_tiled.cu: compiled per shape (fov, connectivity),
//             several lanes a block, A_d in registers. The main paths run it.
//   folded    structured_admm_folded.cu: compiled per shape (32-agent fov and
//             connectivity), one lane a block, [A_s; A_d] in registers, WK
//             folded into the lane's C = (I - WK A_d) Ms_inv.
//   generic   structured_admm_generic.cu: the folded form for shapes known
//             only at run time, three barriers an iteration; every other shape
//             to n = 160 (the sweep's and run_sim's connectivity teams, odd
//             team sizes).
// Two more, below: the first versions, which the generic kernel replaced.
// structured_admm_variant() picks them only for a shape that no layout of
// the generic kernel holds (n above 160, or thousands of rows) and that they
// held before it; otherwise they run when named, so that a measurement can
// time them beside it.
//   resident  one block per lane, every operand of the lane in dynamic shared
//             memory (fov: ~88 KB, two blocks an SM); near 3 % of the bound
//             (two shared-memory loads per multiply-add, eight block-wide
//             barriers an iteration around stages of 43 to 211 threads).
//   streamed  for shapes whose first-version operands exceed the 227 KB a
//             block may have (a 24-agent fov team: n = 59, m_d = 276). A_s,
//             Ms_inv and the vectors stay in shared memory; the lane's A_d and
//             WK stay in device memory and are read again every iteration,
//             one warp a row with coalesced loads. 2 (n m_d) floats, three
//             times and once an iteration, set its pace.
//
// Built without --use_fast_math: inactive dynamic rows carry rho = 1e-12
// and the loop divides by rho, so division must be IEEE and denormals kept.

#include "structured_admm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB: what one block may have on sm_90

// sum over c in [c0, c1) of a[c * stride] * v[c]; two accumulators for ILP.
template <typename T>
__device__ __forceinline__ T dot_strided(const T* a, int stride, const T* v, int c0, int c1) {
  T s0 = 0, s1 = 0;
  int c = c0;
  for (; c + 1 < c1; c += 2) {
    s0 = fma(a[c * stride], v[c], s0);
    s1 = fma(a[(c + 1) * stride], v[c + 1], s1);
  }
  if (c < c1) s0 = fma(a[c * stride], v[c], s0);
  return s0 + s1;
}

// One warp, one row of a float matrix in device memory: the sum over c < C
// of row[c] v[c] in the type of v, with coalesced loads; every thread of
// the warp returns the sum.
template <typename T>
__device__ __forceinline__ T warp_row_dot(const float* row, const T* v, int C) {
  T s = 0;
  for (int c = threadIdx.x % 32; c < C; c += 32) s = fma(static_cast<T>(row[c]), v[c], s);
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Number of column ranges a product with R outputs and C columns is split
// into: as many as the block has threads for, at least 1, at most C.
__device__ __forceinline__ int n_parts(int R, int C) {
  int p = static_cast<int>(blockDim.x) / R;
  p = p < 1 ? 1 : p;
  return p < C ? p : C;
}

// Partial sums of out[r] = sum_c M[r, c] v[c] (r < R, c < C) with
// M[r, c] = A[r * rs + c * cs], over P column ranges: part[p * R + r]
// receives range p. The caller sums the P parts after a barrier.
template <typename T>
__device__ __forceinline__ void partial_matvec(const T* A, int rs, int cs, int R, int C,
                                               const T* v, T* part, int P) {
  const int chunk = (C + P - 1) / P;
  for (int idx = threadIdx.x; idx < R * P; idx += blockDim.x) {
    const int r = idx % R;
    const int c0 = (idx / R) * chunk;
    const int c1 = min(C, c0 + chunk);
    part[idx] = dot_strided(A + r * rs, cs, v, c0, c1);
  }
}

template <typename T>
__device__ __forceinline__ T sum_parts(const T* part, int R, int P, int r) {
  T s = part[r];
  for (int p = 1; p < P; ++p) s += part[p * R + r];
  return s;
}

// Shared-memory layout of one block (the kernel carves it in this order;
// doubles first so that they stay 8-byte aligned).
struct Layout {
  int m, lda, ldw, scratch;
  __host__ __device__ Layout(int n, int m_s, int m_d, int threads)
      : m(m_s + m_d), lda(n | 1), ldw(m_d | 1), scratch(threads > n ? threads : n) {}
  __host__ __device__ size_t doubles(int n, int m_d) const {
    return static_cast<size_t>(n) * lda + static_cast<size_t>(n) * ldw + scratch + n + m_d;
  }
  __host__ __device__ size_t floats(int n) const {
    return static_cast<size_t>(m) * lda + 4 * static_cast<size_t>(n) + 6 * static_cast<size_t>(m)
           + scratch;
  }
  __host__ __device__ size_t bytes(int n, int m_d) const {
    return doubles(n, m_d) * sizeof(double) + floats(n) * sizeof(float);
  }
};

// The first version: one block per lane, every operand in shared memory.
__global__ void __launch_bounds__(kThreads) resident_kernel(const AdmmArgs a) {
  const float *Ms_inv = a.Ms_inv, *A_s = a.A_s, *rho_s = a.rho_s, *q = a.q, *lbs = a.lbs,
              *ubs = a.ubs, *Ad = a.Ad, *lbd = a.lbd, *ubd = a.ubd, *rho_d = a.rho_d,
              *WK = a.WK, *x0 = a.x0, *zs0 = a.zs0, *zd0 = a.zd0, *ys0 = a.ys0, *yd0 = a.yd0;
  float *x_out = a.x_out, *zs_out = a.zs_out, *zd_out = a.zd_out, *ys_out = a.ys_out,
        *yd_out = a.yd_out;
  const int B = a.B, n = a.n, m_s = a.m_s, m_d = a.m_d, iters = a.iters;
  const float sigma = a.sigma, alpha = a.alpha;
  const int lane = blockIdx.x;
  if (lane >= B) return;
  const Layout L(n, m_s, m_d, blockDim.x);
  const int m = L.m, lda = L.lda, ldw = L.ldw;  // odd strides: other banks per row
  const int tid = threadIdx.x, nt = blockDim.x;

  extern __shared__ double smem[];
  double* Minv = smem;               // [n, lda]
  double* W = Minv + n * lda;        // [n, ldw]: the lane's WK
  double* part_d = W + n * ldw;      // [scratch] partial sums of the Woodbury products
  double* rhs = part_d + L.scratch;  // [n]
  double* t = rhs + n;               // [m_d]  A_d S
  float* A = reinterpret_cast<float*>(t + m_d);  // [m, lda]: A_s rows, then the lane's A_d
  float* qv = A + m * lda;           // [n]
  float* x = qv + n;                 // [n]
  float* S = x + n;                  // [n]  Ms_inv RHS
  float* xt = S + n;                 // [n]  x tilde
  float* rho = xt + n;               // [m]
  float* lo = rho + m;               // [m]
  float* hi = lo + m;                // [m]
  float* z = hi + m;                 // [m]
  float* y = z + m;                  // [m]
  float* r = y + m;                  // [m]  rho z - y
  float* part = r + m;               // [scratch] partial sums, float products

  const size_t ln = static_cast<size_t>(lane) * n;
  const size_t ls = static_cast<size_t>(lane) * m_s;
  const size_t ld = static_cast<size_t>(lane) * m_d;
  const float* Ad_l = Ad + ld * n;
  const float* WK_l = WK + ln * m_d;
  for (int i = tid; i < m_s * n; i += nt) A[(i / n) * lda + i % n] = A_s[i];
  for (int i = tid; i < m_d * n; i += nt) A[(m_s + i / n) * lda + i % n] = Ad_l[i];
  for (int i = tid; i < n * n; i += nt) Minv[(i / n) * lda + i % n] = Ms_inv[i];
  for (int i = tid; i < n * m_d; i += nt) W[(i / m_d) * ldw + i % m_d] = WK_l[i];
  for (int i = tid; i < n; i += nt) {
    qv[i] = q[ln + i];
    x[i] = x0[ln + i];
  }
  for (int i = tid; i < m; i += nt) {
    if (i < m_s) {
      rho[i] = rho_s[i];
      lo[i] = lbs[ls + i];
      hi[i] = ubs[ls + i];
      z[i] = zs0[ls + i];
      y[i] = ys0[ls + i];
    } else {
      const size_t k = ld + (i - m_s);
      rho[i] = rho_d[k];
      lo[i] = lbd[k];
      hi[i] = ubd[k];
      z[i] = zd0[k];
      y[i] = yd0[k];
    }
    r[i] = rho[i] * z[i] - y[i];
  }
  __syncthreads();

  const float beta = 1.0f - alpha;
  const float* Adl = A + m_s * lda;
  const int p_rhs = n_parts(n, m);
  const int p_ms = n_parts(n, n);
  const int p_wk = n_parts(n, m_d);
  for (int it = 0; it < iters; ++it) {
    // RHS = sigma x - q + [A_s; A_d]' r   (column j of A: stride lda)
    partial_matvec(A, 1, lda, n, m, r, part, p_rhs);
    __syncthreads();
    for (int j = tid; j < n; j += nt)
      rhs[j] = sigma * x[j] - qv[j] + sum_parts(part, n, p_rhs, j);
    __syncthreads();
    // S = Ms_inv RHS, accumulated in double
    partial_matvec(Minv, lda, 1, n, n, rhs, part_d, p_ms);
    __syncthreads();
    for (int j = tid; j < n; j += nt) S[j] = static_cast<float>(sum_parts(part_d, n, p_ms, j));
    __syncthreads();
    // t = A_d S
    for (int d = tid; d < m_d; d += nt) t[d] = dot_strided(Adl + d * lda, 1, S, 0, n);
    __syncthreads();
    // xt = S - WK t, accumulated in double
    partial_matvec(W, ldw, 1, n, m_d, t, part_d, p_wk);
    __syncthreads();
    for (int j = tid; j < n; j += nt)
      xt[j] = static_cast<float>(static_cast<double>(S[j]) - sum_parts(part_d, n, p_wk, j));
    __syncthreads();
    // over-relaxed z / y updates on every row of [A_s; A_d], relaxed x
    for (int i = tid; i < m; i += nt) {
      r[i] = row_update(dot_strided(A + i * lda, 1, xt, 0, n), rho[i], lo[i], hi[i],
                        alpha, beta, z[i], y[i]);
    }
    for (int j = tid; j < n; j += nt) x[j] = alpha * xt[j] + beta * x[j];
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt) x_out[ln + i] = x[i];
  for (int i = tid; i < m; i += nt) {
    if (i < m_s) {
      zs_out[ls + i] = z[i];
      ys_out[ls + i] = y[i];
    } else {
      zd_out[ld + (i - m_s)] = z[i];
      yd_out[ld + (i - m_s)] = y[i];
    }
  }
}

// Shared-memory layout of one block of the streamed kernel.
struct StreamedLayout {
  int m, lda, scratch;
  __host__ __device__ StreamedLayout(int n, int m_s, int m_d)
      : m(m_s + m_d), lda(n | 1), scratch(kThreads > n ? kThreads : n) {}
  __host__ __device__ size_t doubles(int n, int m_d) const {
    return static_cast<size_t>(n) * lda + scratch + n + m_d;
  }
  __host__ __device__ size_t floats(int n, int m_s) const {
    return static_cast<size_t>(m_s) * lda + 4 * static_cast<size_t>(n)
           + 7 * static_cast<size_t>(m) + 2 * scratch;
  }
  __host__ __device__ size_t bytes(int n, int m_s, int m_d) const {
    return doubles(n, m_d) * sizeof(double) + floats(n, m_s) * sizeof(float);
  }
};

// One block per lane; A_d and WK of the lane are read from device memory in
// every iteration (see the note at the top).
__global__ void __launch_bounds__(kThreads) streamed_kernel(const AdmmArgs a) {
  const int lane = blockIdx.x;
  if (lane >= a.B) return;
  const int n = a.n, m_s = a.m_s, m_d = a.m_d;
  const StreamedLayout L(n, m_s, m_d);
  const int m = L.m, lda = L.lda;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, n_warps = nt / 32;

  extern __shared__ double smem[];
  double* Minv = smem;               // [n, lda]
  double* part_d = Minv + n * lda;   // [scratch]
  double* rhs = part_d + L.scratch;  // [n]
  double* t = rhs + n;               // [m_d]
  float* As = reinterpret_cast<float*>(t + m_d);   // [m_s, lda]
  float* qv = As + m_s * lda;        // [n]
  float* x = qv + n;
  float* S = x + n;
  float* xt = S + n;
  float* rho = xt + n;               // [m] each: shared rows, then the lane's
  float* lo = rho + m;
  float* hi = lo + m;
  float* z = hi + m;
  float* y = z + m;
  float* r = y + m;                  // rho z - y
  float* zA = r + m;                 // [A_s; A_d] xt
  float* part_s = zA + m;            // [scratch] partial sums of A_s' r_s
  float* part_l = part_s + L.scratch;  // [scratch] partial sums of A_d' r_d

  const size_t ln = static_cast<size_t>(lane) * n;
  const size_t ls = static_cast<size_t>(lane) * m_s;
  const size_t ld = static_cast<size_t>(lane) * m_d;
  const float* Ad = a.Ad + ld * n;   // [m_d, n] in device memory
  const float* WK = a.WK + ln * m_d;  // [n, m_d] in device memory
  for (int i = tid; i < m_s * n; i += nt) As[(i / n) * lda + i % n] = a.A_s[i];
  for (int i = tid; i < n * n; i += nt) Minv[(i / n) * lda + i % n] = a.Ms_inv[i];
  for (int i = tid; i < n; i += nt) {
    qv[i] = a.q[ln + i];
    x[i] = a.x0[ln + i];
  }
  for (int i = tid; i < m; i += nt) {
    const bool s = i < m_s;
    const size_t k = s ? ls + i : ld + (i - m_s);
    rho[i] = s ? a.rho_s[i] : a.rho_d[k];
    lo[i] = (s ? a.lbs : a.lbd)[k];
    hi[i] = (s ? a.ubs : a.ubd)[k];
    z[i] = (s ? a.zs0 : a.zd0)[k];
    y[i] = (s ? a.ys0 : a.yd0)[k];
    r[i] = rho[i] * z[i] - y[i];
  }
  __syncthreads();

  const float alpha = a.alpha, beta = 1.0f - a.alpha;
  const int p_s = n_parts(n, m_s), p_l = n_parts(n, m_d), p_ms = n_parts(n, n);
  for (int it = 0; it < a.iters; ++it) {
    // RHS = sigma x - q + A_s' r_s + A_d' r_d  (column j of a matrix: stride = row length;
    // neighbouring threads take neighbouring columns, so the loads of A_d coalesce)
    partial_matvec(As, 1, lda, n, m_s, r, part_s, p_s);
    partial_matvec(Ad, 1, n, n, m_d, r + m_s, part_l, p_l);
    __syncthreads();
    for (int j = tid; j < n; j += nt)
      rhs[j] = a.sigma * x[j] - qv[j] + sum_parts(part_s, n, p_s, j) + sum_parts(part_l, n, p_l, j);
    __syncthreads();
    // S = Ms_inv RHS, accumulated in double
    partial_matvec(Minv, lda, 1, n, n, rhs, part_d, p_ms);
    __syncthreads();
    for (int j = tid; j < n; j += nt) S[j] = static_cast<float>(sum_parts(part_d, n, p_ms, j));
    __syncthreads();
    // t = A_d S
    for (int d = warp; d < m_d; d += n_warps) {
      const float s = warp_row_dot(Ad + d * n, S, n);
      if (tid % 32 == 0) t[d] = s;
    }
    __syncthreads();
    // xt = S - WK t, accumulated in double; x = alpha xt + (1 - alpha) x
    for (int j = warp; j < n; j += n_warps) {
      const double c = warp_row_dot(WK + j * m_d, t, m_d);
      if (tid % 32 == 0) {
        const float v = static_cast<float>(static_cast<double>(S[j]) - c);
        xt[j] = v;
        x[j] = alpha * v + beta * x[j];
      }
    }
    __syncthreads();
    // [A_s; A_d] xt, then the z, y and r updates of every row
    for (int i = tid; i < m_s; i += nt) zA[i] = dot_strided(As + i * lda, 1, xt, 0, n);
    for (int d = warp; d < m_d; d += n_warps) {
      const float s = warp_row_dot(Ad + d * n, xt, n);
      if (tid % 32 == 0) zA[m_s + d] = s;
    }
    __syncthreads();
    for (int i = tid; i < m; i += nt)
      r[i] = row_update(zA[i], rho[i], lo[i], hi[i], alpha, beta, z[i], y[i]);
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt) a.x_out[ln + i] = x[i];
  for (int i = tid; i < m; i += nt) {
    const bool s = i < m_s;
    const size_t k = s ? ls + i : ld + (i - m_s);
    (s ? a.zs_out : a.zd_out)[k] = z[i];
    (s ? a.ys_out : a.yd_out)[k] = y[i];
  }
}

template <typename Kernel>
int launch_per_lane(Kernel kernel, size_t bytes, const AdmmArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.B, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kernel a shape takes: tiled or folded where there is an instantiation,
// else generic. A shape that no layout of the generic kernel holds (n above
// 160, or thousands of rows) takes the first version that holds it, resident
// then streamed, as it did before generic; kNone where neither does.
extern "C" int structured_admm_variant(int n, int m_s, int m_d) {
  if (structured_admm_tiled_has(n, m_s, m_d)) return kTiled;
  if (structured_admm_folded_has(n, m_s, m_d)) return kFolded;
  if (structured_admm_generic_has(n, m_s, m_d)) return kGeneric;
  if (Layout(n, m_s, m_d, kThreads).bytes(n, m_d) <= kMaxSharedBytes) return kResident;
  if (StreamedLayout(n, m_s, m_d).bytes(n, m_s, m_d) <= kMaxSharedBytes) return kStreamed;
  return kNone;
}

// Launches one rho phase on `stream` of `device` (arrays as in AdmmArgs).
// variant < 0: the kernel of structured_admm_variant(); else that kernel,
// for measurements and tests. Returns a cudaError_t (0 = launched). The calling
// thread's current device is left as it was found.
extern "C" int structured_admm_launch(
    const float* Ms_inv, const float* A_s, const float* rho_s, const float* q,
    const float* lbs, const float* ubs, const float* Ad, const float* lbd,
    const float* ubd, const float* rho_d, const float* WK, const float* x0,
    const float* zs0, const float* zd0, const float* ys0, const float* yd0,
    float* x_out, float* zs_out, float* zd_out, float* ys_out, float* yd_out,
    int B, int n, int m_s, int m_d, int iters, float sigma, float alpha,
    int device, void* stream, int variant) {
  if (B <= 0 || n <= 0 || m_s < 0 || m_d <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdmmArgs a{Ms_inv, A_s, rho_s, q, lbs, ubs, Ad, lbd, ubd, rho_d, WK, x0, zs0, zd0,
                   ys0, yd0, x_out, zs_out, zd_out, ys_out, yd_out, B, n, m_s, m_d, iters,
                   sigma, alpha};
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  if (variant < 0) variant = structured_admm_variant(n, m_s, m_d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (variant == kTiled)
    rc = structured_admm_tiled_launch(a, s);
  else if (variant == kFolded)
    rc = structured_admm_folded_launch(a, s);
  else if (variant == kGeneric)
    rc = structured_admm_generic_launch(a, s);
  else if (variant == kResident)
    rc = launch_per_lane(resident_kernel, Layout(n, m_s, m_d, kThreads).bytes(n, m_d), a, s);
  else if (variant == kStreamed)
    rc = launch_per_lane(streamed_kernel, StreamedLayout(n, m_s, m_d).bytes(n, m_s, m_d), a, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (previous != device) cudaSetDevice(previous);
  return rc;
}

extern "C" const char* structured_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
