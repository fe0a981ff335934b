// The per-slot backpressure decisions as device functions (sm_90a).
//
// Shared by bp_slot.cu (B1 slot_route_decide and B2 comp_balance_decide,
// one launch per decision) and bp_slot_step.cu (the fused slot step, which
// makes the same decisions inside one launch per slot), so that the two
// decide identically on identical inputs by construction.  The rules that
// make them bit-identical to the plain versions in ref.py are those of
// bp_slot.cu's header: no fast math, -fmad=false, the JAX evaluation order
// spelled with _rn intrinsics, strictly-greater / strictly-smaller folds so
// the lowest index wins ties.
#pragma once

#include <math.h>
#include <stdint.h>

// B1 for one link: over the C flattened classes of the rows qm and ql, the
// class c maximizing |qm[c] - ql[c]| (first occurrence on ties) and the
// signed difference there.
__device__ __forceinline__ void bp_route_fold(const float* qm,
                                              const float* ql, int C,
                                              int* best_out,
                                              float* dmax_out) {
  float best_d = __fsub_rn(qm[0], ql[0]);
  int best = 0;
  for (int c = 1; c < C; ++c) {
    float d = __fsub_rn(qm[c], ql[c]);
    if (fabsf(d) > fabsf(best_d)) {     // strictly greater: first wins ties
      best_d = d;
      best = c;
    }
  }
  *best_out = best;
  *dmax_out = best_d;
}

// B2's combine amount Z for one comp node: the pair count P (fifo from the
// cumulative counters, bound from the raw packets in flight), clipped to
// [0, min(x1, x2)], then capped by the masked capacity, optionally gated by
// the pi1' threshold (combine only when x1 + x2 >= 2 caps + threshold).
__device__ __forceinline__ float bp_combine_amount(
    float caps, float mask, float x1, float x2, float ca1, float ca2,
    float cc, float xnet, int pairing_bound, int thresholded,
    float threshold) {
  float capm = __fmul_rn(caps, mask);
  float P;
  if (pairing_bound) {
    P = __fdiv_rn(__fsub_rn(__fadd_rn(x1, x2), xnet), 2.0f);
  } else {
    P = __fsub_rn(fminf(ca1, ca2), cc);
  }
  P = fminf(fmaxf(P, 0.0f), fminf(x1, x2));
  if (thresholded) {
    float xsum = __fadd_rn(x1, x2);
    float bar = __fadd_rn(__fmul_rn(2.0f, capm), threshold);
    return fminf(xsum >= bar ? capm : 0.0f, P);
  }
  return fminf(P, capm);
}

// B2's join-shortest-sum-of-queues score (paper eq. 9) of one comp node,
// ((1+eps) q0 + q1) + q2 + H, and +inf on a masked node.
__device__ __forceinline__ float bp_balance_score(float one_eps, float q0,
                                                  float q1, float q2, float H,
                                                  float mask) {
  float s = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(one_eps, q0), q1), q2),
                      H);
  return mask > 0.0f ? s : INFINITY;
}

// One step n = 0, 1, ... of B2's argmin fold; *best starts at 0.  Strictly
// smaller wins, so ties go to the lowest index, and if every node is masked
// every score is +inf and n* stays 0, as torch.argmin gives.
__device__ __forceinline__ void bp_argmin_step(int n, float s, float* best_s,
                                               int* best) {
  if (n == 0) {
    *best_s = s;
  } else if (s < *best_s) {
    *best_s = s;
    *best = n;
  }
}
