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
// 0.96 us at 3.35 TB/s, against 1.2 M operations.
//
// Design: a group of G lanes owns a link, G the smallest power of two that
// covers the row in one pass (at most 32: a warp), so a warp reads whole
// rows, neighbouring lanes on neighbouring addresses.  Where the row's
// bytes and both pointers allow it, each lane reads 16 bytes of qm and of
// ql at once (4 float32 or 8 bfloat16 classes: C = 96 is 24 lanes in
// float32, 12 in bfloat16, so a warp holds 1 or 2 links); otherwise it
// reads single classes, lane l of the group the classes l, l + G, ...
// Every lane folds its own classes in rising order with a strictly-greater
// rule (the first maximum of its own wins), then a (|d|, index) butterfly
// over the group keeps the larger |d| and, on equal values, the lower
// index: the first maximal class of the row.  256-thread blocks, one
// group per link, give 4,096 warps in flight at E = 4,096 (about 31 per
// SM), enough loads to hide the memory latency; the one-thread-per-link
// kernel this replaces walked each row serially with one warp per SM.
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

#define FULL_MASK 0xffffffffu
#define NO_INDEX 0x7fffffff
#define THREADS 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Fold class c's differential into this lane's running pick.
__device__ __forceinline__ void fold(float d, int c, float& dmax, int& best) {
  if (best == NO_INDEX || fabsf(d) > fabsf(dmax)) {
    dmax = d;
    best = c;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    bp_route_kernel(const T* __restrict__ qm, const T* __restrict__ ql,
                    const float* __restrict__ cap, int32_t* __restrict__ cls,
                    float* __restrict__ rate, int32_t* __restrict__ dir,
                    int E, int C, int G) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t e = tid / G;          // G divides 32: groups never straddle
  const int gl = (int)(tid % G);      // lane within the link's group
  float dmax = 0.0f;                  // an empty lane: |0|, the last index
  int best = NO_INDEX;
  if (e < E) {
    const T* a = qm + e * C;
    const T* b = ql + e * C;
    if (VEC) {
      constexpr int N = 16 / sizeof(T);
      for (int base = gl * N; base < C; base += G * N) {
        const uint4 va = *reinterpret_cast<const uint4*>(a + base);
        const uint4 vb = *reinterpret_cast<const uint4*>(b + base);
        const T* ta = reinterpret_cast<const T*>(&va);
        const T* tb = reinterpret_cast<const T*>(&vb);
#pragma unroll
        for (int j = 0; j < N; ++j)
          fold(__fsub_rn(to_f(ta[j]), to_f(tb[j])), base + j, dmax, best);
      }
    } else {
      for (int c = gl; c < C; c += G)
        fold(__fsub_rn(to_f(a[c]), to_f(b[c])), c, dmax, best);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(FULL_MASK, dmax, o);
    const int oi = __shfl_xor_sync(FULL_MASK, best, o);
    const float ao = fabsf(od), as = fabsf(dmax);
    if (ao > as || (ao == as && oi < best)) {
      dmax = od;
      best = oi;
    }
  }
  if (e < E && gl == 0) {
    cls[e] = best;
    rate[e] = fabsf(dmax) > 0.0f ? cap[e] : 0.0f;
    dir[e] = dmax > 0.0f ? 1 : -1;
  }
}

template <typename T>
static int launch(const void* qm, const void* ql, const void* cap, void* cls,
                  void* rate, void* dir, int E, int C, cudaStream_t s) {
  const bool vec = (C * sizeof(T)) % 16 == 0 &&
                   (uintptr_t)qm % 16 == 0 && (uintptr_t)ql % 16 == 0;
  const int per = vec ? (int)(16 / sizeof(T)) : 1;
  const int need = (C + per - 1) / per;
  int G = 1;
  while (G < need && G < 32) G <<= 1;
  const int64_t threads = (int64_t)E * G;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  if (vec)
    bp_route_kernel<T, true><<<blocks, THREADS, 0, s>>>(
        (const T*)qm, (const T*)ql, (const float*)cap, (int32_t*)cls,
        (float*)rate, (int32_t*)dir, E, C, G);
  else
    bp_route_kernel<T, false><<<blocks, THREADS, 0, s>>>(
        (const T*)qm, (const T*)ql, (const float*)cap, (int32_t*)cls,
        (float*)rate, (int32_t*)dir, E, C, G);
  return (int)cudaGetLastError();
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (qm and ql).
int bp_route_decide(const void* qm, const void* ql, const void* cap,
                    void* cls, void* rate, void* dir, int dtype, int E, int C,
                    void* stream) {
  if (E == 0) return (int)cudaSuccess;
  if (C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(qm, ql, cap, cls, rate, dir, E, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qm, ql, cap, cls, rate, dir, E, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
