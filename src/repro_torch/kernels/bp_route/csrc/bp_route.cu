// Per-link backpressure routing decision, the paper's BP box (sm_90a).
//
// Replaces src/repro/kernels/bp_route/kernel.py::bp_route_decide (body
// _bp_route_kernel).  For every link e of pre-gathered endpoint backlogs
// qm, ql [E, C] (float32 or bfloat16) and a capacity cap [E] (float32):
//   diff = float(qm) - float(ql);  best = first argmax over C of |diff|;
//   dmax = diff[best];  rate = cap if |dmax| > 0 else 0;
//   dir = +1 (m -> l) if dmax > 0 else -1.
//
// Bound: bytes.  Per link it reads 2 C inputs and writes 12 bytes; the
// arithmetic is 3 C operations (subtract, |.|, compare).  At the kernel
// table's shape (E = 4096 links, C = 96 classes, float32) that is 3.2 MB,
// 0.94 us at 3.35 TB/s, against 1.2 M operations.
//
// Design: one thread per link, a strictly-greater fold over its C classes
// in order, so the first maximal class wins whatever C is (any C >= 1).
// The TPU kernel's [block_e, C] panels become independent threads.  A
// thread reads its own row, so a warp's load touches 32 rows: blocks are
// one warp each, spreading the links over every SM, so that the L1 of an
// SM holds its warp's 32 rows while they are read (with 256-thread blocks
// at E = 4096 the links sat on 16 SMs whose L1 could not hold their rows,
// and the kernel took 0.027 ms).
//
// Bit-exactness with the plain version (ref.py): the only rounded step is
// one subtraction (__fsub_rn; the build has -fmad=false and no fast math);
// |.|, the compares and the selects are exact.  NaN inputs are not handled.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(), which the ctypes wrapper turns into an exception.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void bp_route_kernel(const T* __restrict__ qm,
                                const T* __restrict__ ql,
                                const float* __restrict__ cap,
                                int32_t* __restrict__ cls,
                                float* __restrict__ rate,
                                int32_t* __restrict__ dir, int E, int C) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const T* a = qm + e * C;
  const T* b = ql + e * C;
  float dmax = __fsub_rn(to_f(a[0]), to_f(b[0]));
  float amax = fabsf(dmax);
  int best = 0;
#pragma unroll 4
  for (int c = 1; c < C; ++c) {
    const float d = __fsub_rn(to_f(a[c]), to_f(b[c]));
    if (fabsf(d) > amax) {
      amax = fabsf(d);
      dmax = d;
      best = c;
    }
  }
  cls[e] = best;
  rate[e] = amax > 0.0f ? cap[e] : 0.0f;
  dir[e] = dmax > 0.0f ? 1 : -1;
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (qm and ql).
int bp_route_decide(const void* qm, const void* ql, const void* cap,
                    void* cls, void* rate, void* dir, int dtype, int E, int C,
                    void* stream) {
  if (E == 0) return (int)cudaSuccess;
  if (C < 1) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const unsigned blocks = (unsigned)((E + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    bp_route_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)qm, (const float*)ql, (const float*)cap,
        (int32_t*)cls, (float*)rate, (int32_t*)dir, E, C);
  } else if (dtype == 1) {
    bp_route_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)qm, (const __nv_bfloat16*)ql,
        (const float*)cap, (int32_t*)cls, (float*)rate, (int32_t*)dir, E, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
