// Fused backpressure top-k gate for MoE routing (sm_90a).
//
// Replaces src/repro/kernels/bp_topk/kernel.py::bp_topk (body
// _bp_topk_kernel).  For every token row of [T, E] float32 gate logits and
// an [E] float32 bias (beta * H / C, the paper's eq. 9 applied to experts):
//   m = max_e s;  probs = exp(s - m) / sum_e exp(s - m);  sel = probs - bias;
//   k passes of argmax over sel (lowest index on ties), each masking its
//   pick with NEG = -1e30;  w = picked probs / max(their sum, 1e-9), summed
//   in pick order.
//
// Bound: bytes.  Per row it reads E logits and writes k indices and k
// weights; the arithmetic is ~(6 + k) E operations, far below the card's
// float32 rate.  At a decode step (T = 4 or 8 slots, E = 32, k = 8) the
// whole call moves under 2 KB and is bound by launch latency; at T = 4096
// it moves 0.8 MB (~0.24 us at 3.35 TB/s).
//
// Design: one warp per row, lanes striding over E (any E: lane l owns
// entries l, l+32, ...); butterfly __shfl_xor_sync reductions for the max,
// the sum and the (value, index) argmax, where a larger value wins and on
// equal values the smaller index wins, so the argmax is the first
// occurrence whatever the tree.  The row's sel values sit in shared memory
// (E floats per warp) so that a pick can be masked; the grid covers the T
// rows with no padding.  The TPU kernel's sequential token-tile grid
// becomes independent warps.
//
// Bit-exactness with the plain version (ref.py): the sum is the one order
// ref.warp_sum spells (per-lane partials in stride order, then halving adds
// over the 32 lanes); the build uses -fmad=false and no fast math, so expf
// is the accurate one and the division is IEEE; every add, subtract and
// divide is written with its _rn intrinsic.  NaN inputs are not handled.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(), which the ctypes wrapper turns into an exception.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define NEG_MASK (-1e30f)

__global__ void bp_topk_kernel(const float* __restrict__ scores,
                               const float* __restrict__ bias,
                               int32_t* __restrict__ idx_out,
                               float* __restrict__ w_out, int T, int E,
                               int k) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= T) return;                 // uniform per warp: whole warp exits
  const float* s = scores + row * E;
  float* work = smem + (int64_t)warp * E;

  // 1. row max (exact in any order)
  float m = -INFINITY;
  for (int e = lane; e < E; e += 32) m = fmaxf(m, s[e]);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));

  // 2. sum of exp(s - m): per-lane partial in stride order, then halving
  float acc = 0.0f;
  for (int e = lane; e < E; e += 32)
    acc = __fadd_rn(acc, expf(__fsub_rn(s[e], m)));
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL_MASK, acc, o));

  // 3. sel = probs - bias, kept in shared memory for the masked passes
  for (int e = lane; e < E; e += 32)
    work[e] = __fsub_rn(__fdiv_rn(expf(__fsub_rn(s[e], m)), acc), bias[e]);
  __syncwarp();

  // 4. k passes of first-occurrence argmax
  float wsum = 0.0f;
  int32_t* idx = idx_out + row * k;
  float* w = w_out + row * k;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int e = lane; e < E; e += 32) {
      float v = work[e];
      if (v > bv || bi == 0x7fffffff) {   // own entries rise with e: first wins
        bv = v;
        bi = e;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_xor_sync(FULL_MASK, bv, o);
      int oi = __shfl_xor_sync(FULL_MASK, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    // every lane now holds the same (bv, bi) and computes the same p
    float p = __fdiv_rn(expf(__fsub_rn(s[bi], m)), acc);
    wsum = __fadd_rn(wsum, p);
    if (lane == (j & 31)) {               // pick j belongs to lane j % 32
      idx[j] = bi;
      w[j] = p;
    }
    if (lane == (bi & 31)) work[bi] = NEG_MASK;
    __syncwarp();
  }

  // 5. renormalise: each lane rescales the picks it wrote itself
  wsum = fmaxf(wsum, 1e-9f);
  for (int j = lane; j < k; j += 32) w[j] = __fdiv_rn(w[j], wsum);
}

extern "C" {

// Largest E one launch takes: one warp's row of sel in shared memory.
int bp_topk_max_experts(void) { return 232448 / 4; }

int bp_topk(const void* scores, const void* bias, void* idx, void* w, int T,
            int E, int k, void* stream) {
  if (T == 0) return (int)cudaSuccess;
  // warps per block: up to 8, fewer when a row's shared memory is large
  int warps = 8;
  while (warps > 1 && (size_t)warps * E * sizeof(float) > 48 * 1024) warps >>= 1;
  size_t smem = (size_t)warps * E * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned blocks = (unsigned)((T + warps - 1) / warps);
  bp_topk_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)bias, (int32_t*)idx, (float*)w, T,
      E, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
