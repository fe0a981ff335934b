// The port's counter-based noise in one launch per draw (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws its noise with threefry
// inside XLA.  The port draws every random number as SplitMix64 of
// (seed, slot t, draw site, element index) (see sim/workload.py), and in
// plain PyTorch one [B, n] draw is a chain of 46-48 tiny int64 elementwise
// kernels.  Measured on an H100 (torch.profiler, one replayed 64-slot CUDA
// graph): in the trace simulator's regulated policy at B=9, that chain was
// 47 of the 53.25 kernels and about 54 of the 70 us of device time a slot;
// in the capacity atlas's fleet (1,512 lanes in four batches) about 117 of
// the 279 kernels a batched slot, at ~1.3 us each.  This kernel computes
// the whole draw in one launch.
//
// Bound: launch latency.  It reads 12-20 bytes a row (seed, t and, for the
// Bernoulli form, eps) and writes B*n*4 bytes (8 for uniform64).  The
// fleet's largest draw, 504 x 24 float32, is 48,384 B: 0.015 us at
// 3.35 TB/s.  The arithmetic is three SplitMix64 finalizers a thread in
// 64-bit registers.  Design: one thread per element (b, i); each thread
// recomputes its row's base from seed[b] and t[b] (two finalizers of
// integer work, cheaper than a second pass or a shared-memory exchange),
// then hashes its own index and writes the output form, with the
// Bernoulli compare fused in.  Nothing crosses threads.
//
// Bit-exactness with the plain chain (ref.py), which runs on int64 torch
// tensors: torch's int64 multiply and add wrap modulo 2^64 exactly as
// uint64_t does, and its logical shift (`_srl`, an arithmetic shift and a
// mask) is uint64_t's >>.  t may be int32 (the fleet's slot counter) or
// int64: either is sign-extended to int64 before the +1, as `t.long() + 1`
// is.  The conversions are exact: a 24-bit integer to float and a 53-bit
// integer to double, each times a power of two.  -fmad=false is kept as
// for the port's other bit-exact sources, though nothing here could fuse.
//
// The C entry launches on the caller's stream, never synchronises, and
// returns cudaGetLastError(), which the ctypes wrapper turns into an
// exception.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;

// The output forms, in the order of ref.FORMS.
enum Form { kUniform = 0, kUniform64 = 1, kBernoulli = 2 };

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * kM1;
  z = (z ^ (z >> 27)) * kM2;
  return z ^ (z >> 31);
}

template <typename TSlot, int kForm>
__global__ void counter_hash_kernel(const int64_t* __restrict__ seed,
                                    const TSlot* __restrict__ t,
                                    const float* __restrict__ eps,
                                    void* __restrict__ out, int total, int n,
                                    uint64_t site) {
  // Unsigned: the last block's g reaches total + 127, past INT_MAX where
  // total is within 127 of it, and still below 2^32.
  unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (unsigned)total) return;
  unsigned b = g / (unsigned)n;
  unsigned i = g - b * (unsigned)n;
  uint64_t base = mix64((uint64_t)seed[b] * kGamma + site);
  base = mix64(base + ((uint64_t)(int64_t)t[b] + 1ull) * kGamma);
  uint64_t bits = mix64(base + (uint64_t)(i + 1) * kGamma);
  if (kForm == kUniform64) {
    ((double*)out)[g] = (double)(bits >> 11) * 0x1p-53;
  } else {
    float u = (float)(uint32_t)(bits >> 40) * 0x1p-24f;
    ((float*)out)[g] = kForm == kUniform ? u : (u < eps[b] ? 1.0f : 0.0f);
  }
}

template <typename TSlot>
int launch(const void* seed, const void* t, const void* eps, void* out,
           int total, int n, uint64_t site, int form, cudaStream_t stream) {
  const int threads = 128;
  unsigned blocks = (unsigned)(((long long)total + threads - 1) / threads);
  const int64_t* s = (const int64_t*)seed;
  const TSlot* ts = (const TSlot*)t;
  const float* e = (const float*)eps;
  switch (form) {
    case kUniform:
      counter_hash_kernel<TSlot, kUniform><<<blocks, threads, 0, stream>>>(
          s, ts, e, out, total, n, site);
      break;
    case kUniform64:
      counter_hash_kernel<TSlot, kUniform64><<<blocks, threads, 0, stream>>>(
          s, ts, e, out, total, n, site);
      break;
    case kBernoulli:
      counter_hash_kernel<TSlot, kBernoulli><<<blocks, threads, 0, stream>>>(
          s, ts, e, out, total, n, site);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// seed [B] int64, t [B] int32 (t_bytes 4) or int64 (8), eps [B] float32
// (read by the Bernoulli form only), out [B, n] of the form's type.
int counter_hash(const void* seed, const void* t, int t_bytes,
                 const void* eps, void* out, int B, int n, long long site,
                 int form, void* stream) {
  int total = B * n;                 // the wrapper keeps B * n < 2^31
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (t_bytes == 4)
    return launch<int32_t>(seed, t, eps, out, total, n, (uint64_t)site, form,
                           s);
  if (t_bytes == 8)
    return launch<int64_t>(seed, t, eps, out, total, n, (uint64_t)site, form,
                           s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
