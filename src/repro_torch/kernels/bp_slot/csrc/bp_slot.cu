// Per-slot backpressure decision kernels for the whole fleet batch (sm_90a).
//
// Two kernels carry the paper's control loop; each replaces one Pallas TPU
// kernel of the JAX package and takes every simulation of a batch in one
// launch (the JAX engine gets its batch from vmap; one launch per sim would
// be 1,512 launches per slot at the atlas width).
//
// The decisions themselves are device functions in bp_slot_decide.cuh,
// shared with the fused slot step (bp_slot_step.cu).
//
// Build rules that keep the kernels bit-identical to the plain PyTorch
// versions in ref.py (which evaluate in the JAX package's order):
//   * no --use_fast_math: it implies -ftz=true, and a flushed denormal
//     difference changes which class wins;
//   * -fmad=false: nvcc would otherwise contract (1+eps)*q0 + q1 into an
//     FMA, which PyTorch's eager ops never do, and the single rounding can
//     flip the argmin;
//   * the JAX evaluation order everywhere: ((1+eps)*q0 + q1) + q2 + H,
//     clip(P, 0, min(x1, x2)) = min(max(P, 0), min(x1, x2)), 2*caps + thr.
// Backlogs are never NaN, so the NaN rules of fminf/fmaxf and of
// torch.minimum/torch.maximum never come into play; no NaN handling here.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError(), which the ctypes wrapper turns into an exception.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_slot_decide.cuh"

// ---------------------------------------------------------------------------
// slot_route_decide
//
// Replaces src/repro/kernels/bp_slot/kernel.py::slot_route_decide (body
// _route_kernel).  For every (sim b, edge e) with endpoints (m, l): the
// flat class c maximizing |Qf[b,m,c] - Qf[b,l,c]|, first occurrence on
// ties, and the signed difference there.
//
// Bound: bytes.  Per edge it reads two C-float rows and two indices and
// writes 8 bytes; there is no arithmetic to speak of.  At the main path's
// shape (B=1512, N=16, C=12, E=51) that is ~2.4 MB, under a microsecond at
// the card's memory rate, so a launch is bound by launch latency, not by
// the work.  Design: one thread per (sim, edge); the class loop inside the
// thread takes the place of the TPU kernel's sequential class-tile grid
// axis, and its strictly-greater fold keeps the first maximum, like
// torch.argmax.  Nothing crosses blocks.  The endpoint rows are read from
// global memory (they stay in L1/L2: one sim's panel is 768 B); staging the
// panel in shared memory is left to a later change.
// ---------------------------------------------------------------------------
__global__ void slot_route_decide_kernel(const float* __restrict__ qf,
                                         const int32_t* __restrict__ m_idx,
                                         const int32_t* __restrict__ l_idx,
                                         int32_t* __restrict__ best_out,
                                         float* __restrict__ dmax_out,
                                         int B, int N, int C, int E) {
  int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (int64_t)B * E) return;
  int64_t b = g / E;
  const float* q = qf + b * (int64_t)N * C;
  int best;
  float best_d;
  bp_route_fold(q + (int64_t)m_idx[g] * C, q + (int64_t)l_idx[g] * C, C,
                &best, &best_d);
  best_out[g] = best;
  dmax_out[g] = best_d;
}

// ---------------------------------------------------------------------------
// comp_balance_decide
//
// Replaces src/repro/kernels/bp_slot/kernel.py::comp_balance_decide (body
// _comp_balance_kernel).  Per sim: the pair count P (fifo or bound), the
// combine amount Z (optionally gated by the pi1' threshold), and the masked
// join-shortest-sum-of-queues argmin n* with +inf on masked nodes.
//
// Layout: the wrapper stacks the 12 [B, NC] panels into one contiguous
// [B, 12, NC] tensor in the order of ref.PANELS (q0 q1 q2 H caps mask x1 x2
// ca1 ca2 cc x_net), so a sim's inputs are one contiguous 12*NC-float run.
//
// Bound: bytes.  ~0.33 MB at B=1512, NC=4: a tenth of a microsecond at the
// memory rate, far below launch latency, so at the main path's shape the
// launch is latency bound.  Design: one thread per sim loops over its NC
// comp nodes, writes Z for each, and folds the argmin on a strictly smaller
// score so ties go to the lowest index; if every node is masked every score
// is +inf and n* stays 0, as torch.argmin gives.
// ---------------------------------------------------------------------------
__global__ void comp_balance_decide_kernel(const float* __restrict__ eps,
                                           const float* __restrict__ panels,
                                           float* __restrict__ z_out,
                                           int32_t* __restrict__ nstar_out,
                                           int B, int NC, int pairing_bound,
                                           int thresholded, float threshold) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* p = panels + (int64_t)b * 12 * NC;
  const float* q0 = p + 0 * NC;
  const float* q1 = p + 1 * NC;
  const float* q2 = p + 2 * NC;
  const float* H = p + 3 * NC;
  const float* caps = p + 4 * NC;
  const float* mask = p + 5 * NC;
  const float* x1 = p + 6 * NC;
  const float* x2 = p + 7 * NC;
  const float* ca1 = p + 8 * NC;
  const float* ca2 = p + 9 * NC;
  const float* cc = p + 10 * NC;
  const float* xnet = p + 11 * NC;
  float one_eps = __fadd_rn(1.0f, eps[b]);
  float best_s = INFINITY;
  int best = 0;
  for (int n = 0; n < NC; ++n) {
    z_out[(int64_t)b * NC + n] = bp_combine_amount(
        caps[n], mask[n], x1[n], x2[n], ca1[n], ca2[n], cc[n], xnet[n],
        pairing_bound, thresholded, threshold);
    bp_argmin_step(n, bp_balance_score(one_eps, q0[n], q1[n], q2[n], H[n],
                                       mask[n]),
                   &best_s, &best);
  }
  nstar_out[b] = best;
}

extern "C" {

int bp_slot_route_decide(const void* qf, const void* m_idx, const void* l_idx,
                         void* best, void* dmax, int B, int N, int C, int E,
                         void* stream) {
  int64_t total = (int64_t)B * E;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  slot_route_decide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)qf, (const int32_t*)m_idx, (const int32_t*)l_idx,
      (int32_t*)best, (float*)dmax, B, N, C, E);
  return (int)cudaGetLastError();
}

int bp_slot_comp_balance_decide(const void* eps, const void* panels, void* z,
                                void* nstar, int B, int NC, int pairing_bound,
                                int thresholded, float threshold,
                                void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const int threads = 128;
  unsigned blocks = (unsigned)((B + threads - 1) / threads);
  comp_balance_decide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)eps, (const float*)panels, (float*)z, (int32_t*)nstar, B,
      NC, pairing_bound, thresholded, threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
