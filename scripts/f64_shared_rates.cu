// Microbenchmark behind a design choice of mpc_cbf_torch/csrc/structured_admm_tiled.cu:
// how fast an SM of the card feeds float64 multiply-adds from shared memory,
// from float64 data (LDS.64) and from float32 data converted at use.
//
// From the root of a checkout (build/ is not committed):
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/f64_shared_rates scripts/f64_shared_rates.cu
//   build/f64_shared_rates
//
// Prints the time of each loop and its elements per clock and SM, from the
// SM count and the SM clock the card reports (its highest clock: under load
// the card may run below it, so the true rate per clock is no lower).
#include <cstdio>
#include <cuda_runtime.h>
template <int MODE>
__global__ void k(const float* in, double* out, int iters) {
  __shared__ float sf[2048];
  __shared__ double sd[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) { sf[i] = in[i]; sd[i] = in[i]; }
  __syncthreads();
  double a0 = 0, a1 = 0; const double t = in[0];
  int idx = threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      int j = (idx + u * 67 + it) & 2047;
      if (MODE == 0) { a0 = fma(sd[j], t, a0); }                 // LDS.64 + DFMA
      if (MODE == 1) { a0 = fma((double)sf[j], t, a0); }         // LDS.32 + cvt + DFMA
      if (MODE == 2) { a0 = fma(t, t, a0); a1 = fma(t, t, a1); } // DFMA only (2 per u)
      if (MODE == 3) { a0 += (double)(sf[j]); }                  // LDS.32 + cvt + DADD
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1;
}
template <int MODE> void run(const char* name, const float* in, double* out, int sms, double hz) {
  cudaEvent_t s, e; cudaEventCreate(&s); cudaEventCreate(&e);
  k<MODE><<<sms * 2, 1024>>>(in, out, 100);
  cudaEventRecord(s);
  k<MODE><<<sms * 2, 1024>>>(in, out, 2000);
  cudaEventRecord(e); cudaEventSynchronize(e);
  float ms; cudaEventElapsedTime(&ms, s, e);
  double elements = double(sms) * 2 * 1024 * 2000 * 8;
  printf("%s: %.3f ms, %.1f elements/clk/SM at %.3f GHz on %d SMs\n", name, ms,
         elements / (ms * 1e-3) / sms / hz, hz * 1e-9, sms);
}
int main() {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  if (sms <= 0 || khz <= 0) { fprintf(stderr, "no CUDA device\n"); return 1; }
  const double hz = khz * 1e3;
  float* in; double* out; cudaMalloc(&in, 2048 * 4); cudaMalloc(&out, size_t(sms) * 2 * 1024 * 8);
  cudaMemset(in, 0, 2048 * 4);
  run<0>("lds64+dfma", in, out, sms, hz); run<1>("lds32+cvt+dfma", in, out, sms, hz);
  run<2>("dfma x2 (count is half)", in, out, sms, hz); run<3>("lds32+cvt+dadd", in, out, sms, hz);
  return 0;
}
