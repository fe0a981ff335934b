// The whole slot step of every simulation of a fleet batch in one launch
// (sm_90a).
//
// Replaces, on the port's main path, the two Pallas TPU kernels of
// src/repro/kernels/bp_slot/kernel.py, slot_route_decide (B1) and
// comp_balance_decide (B2), together with the eager slot step around them
// (src/repro/core/policies.py::slot_step: load_balance_slot,
// bp_route_slot, computation_slot).  On the TPU, XLA fuses the jitted slot
// step around the two Pallas calls.  The port's eager slot step issued
// about 640 CUDA activities per slot instead (gathers, ten sorted
// scatter-adds, the greedy matching's loop over links, B1 once and B2
// twice); this kernel issues one.
//
// What bounds it: neither bytes nor operations.  Per sim it reads about
// 3.4 KB (the state, the problem row, the slot's noise) and writes 1.2 KB;
// at 1,512 sims that is ~1.5 us at the card's memory rate, and the
// arithmetic is a few thousand float operations per sim.  The work is a
// chain of small dependent phases (decide, admit, route, cap, scatter,
// combine), each a few hundred operations wide, so latency sets the time.
// Design: one 128-thread block per sim; the sim's state and problem row
// are loaded into shared memory once, the phases are separated by
// __syncthreads, and each leaf is written back once.  Every shared array
// is addressed from the kernel's __shared__ buffer, so the compiler keeps
// 32-bit shared addresses and shared loads (pointers laundered through an
// integer cost twice the registers and generic loads, and the kernel twice
// the time).  ptxas gives 64 registers, so 8 blocks share an SM and 1,512
// sims take 1.4 waves; capping registers for one wave spills and is
// slower.
//
// Agreement with the plain version (ref.py::slot_step_plain):
//   * The decisions call the device functions of bp_slot_decide.cuh that
//     the B1/B2 kernels call, on the same values, so they decide alike.
//   * No atomics.  A scatter-add runs in one warp over the plain
//     version's update list (departures over links 0..E-1, then arrivals),
//     32 updates at a time: the lanes whose updates hit one index are
//     grouped, and the group's lowest lane adds them to the base in list
//     order, as the plain version does on the CPU.  Where no reduction
//     feeds them, Q, Ddum, X, cum_arr, Y, H and cum_comb then equal the
//     CPU's bit for bit; on the card the plain version's sorted
//     scatter-adds sum an index's updates before adding the base, and
//     differ from both by rounding.
//   * The greedy matching (wireless) visits links by rank: link e's rank
//     is the number of links j with w_j > w_e, or w_j == w_e and j < e,
//     the order of a stable sort by decreasing weight.
//   * Reductions run in a fixed order inside the block: a sum over links or
//     over the queue lanes-strided in one warp, then a butterfly; a sum
//     over nodes or comp nodes serially.  They differ from PyTorch's order
//     by rounding only, and never depend on the batch or on run order.
//   * Every expression keeps the plain version's operations and their
//     order, including multiplies by 0.0/1.0 where it multiplies by a
//     mask.  -fmad=false and no fast math, as for bp_slot.cu.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(), or BP_SLOT_STEP_TOO_LARGE when the sim's shared
// memory does not fit one block; the ctypes wrapper raises on either.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bp_slot_decide.cuh"

#define BP_SLOT_STEP_THREADS 128
#define BP_SLOT_STEP_TOO_LARGE (-1)
// The most dynamic shared memory one block may use on an H100.
#define BP_SLOT_STEP_MAX_SMEM 232448

// torch.clamp(x, min=1e-20) on float32: the double 1e-20 rounded to float.
#define BP_TINY 0x1.79ca1p-67f

struct SlotStepArgs {
  // Queue state in (NetState's fields; [B, ...] contiguous float32).
  const float *Q, *Ddum, *X, *Y, *H, *cum_arr, *cum_comb;
  const float *delivered, *delivered_useful, *delivered_c,
      *delivered_useful_c;
  // Padded problem (PaddedProblem's fields).
  const int32_t* edges;          // [B, E, 2]
  const float* edge_cap;         // [B, E]
  const int32_t *s1, *s2, *dest;  // [B]
  const int32_t* comp_nodes;     // [B, NC]
  const float* comp_caps;        // [B, NC]
  const uint8_t* sink;           // [B, N, 3, NC] bool
  const float* edge_mask;        // [B, E]
  const float* comp_mask;        // [B, NC]
  // This slot's inputs.
  const float* arrivals;         // [B]
  const float* reg_draws;        // [B, NC], read only when regulated
  const float* eps;              // [B]
  // Queue state out.
  float *oQ, *oDdum, *oX, *oY, *oH, *o_cum_arr, *o_cum_comb;
  float *o_delivered, *o_delivered_useful, *o_delivered_c,
      *o_delivered_useful_c;
  // Metrics out.
  float *total_queue, *routed, *computed;  // [B]
  float* Z;                                // [B, NC]
  int32_t* n_star;                         // [B]
  int B, N, NC, E;
  int load_balance, fixed_node, regulated, pairing_bound, thresholded,
      wireless;
  float threshold;
};

// ---------------------------------------------------------------------------
// Shared memory of one sim
// ---------------------------------------------------------------------------

// One sim's arrays in shared memory.  The pointers are formed from the
// kernel's __shared__ buffer, so the compiler knows their address space
// (32-bit shared addresses, shared-memory loads and stores).
struct Smem {
  // state and problem row
  float *Q, *D, *X, *Y, *H, *CA, *CC, *caps, *cmask, *asg, *Z, *tot;
  float* red;                                       // reduction results
  // per link
  float *cap, *emask, *alloc, *w, *act, *moved, *tonet, *mnet, *tox;
  int *m, *l, *bi, *src, *ksrc, *kdst, *dsrc, *ddst, *kx, *order;
  int* comp;                                        // per comp node
  uint8_t *sink, *proc, *used;
};

// Lays the arrays out from ``base`` (16-byte aligned each) into ``s`` and
// returns the bytes they take.  The host calls it with s == nullptr for
// the size alone.
__host__ __device__ inline size_t bp_slot_step_layout(unsigned char* base,
                                                      int N, int NC, int E,
                                                      Smem* s) {
  size_t off = 0;
  auto take = [&](auto*& field, size_t n) {
    off = (off + 15) & ~(size_t)15;
    if (s) field = reinterpret_cast<
        typename std::remove_reference<decltype(field)>::type>(base + off);
    off += n * sizeof(*field);
  };
  Smem none;
  Smem& t = s ? *s : none;
  const size_t QK = (size_t)N * 3 * NC, DK = (size_t)N * NC;
  take(t.Q, QK);
  take(t.tot, QK);
  take(t.D, DK);
  take(t.X, 2 * NC);
  take(t.CA, 2 * NC);
  take(t.Y, NC);
  take(t.H, NC);
  take(t.CC, NC);
  take(t.caps, NC);
  take(t.cmask, NC);
  take(t.asg, NC);
  take(t.Z, NC);
  take(t.red, 8);
  take(t.cap, E);
  take(t.emask, E);
  take(t.alloc, E);
  take(t.w, E);
  take(t.act, E);
  take(t.moved, E);
  take(t.tonet, E);
  take(t.mnet, E);
  take(t.tox, E);
  take(t.m, E);
  take(t.l, E);
  take(t.bi, E);
  take(t.src, E);
  take(t.ksrc, E);
  take(t.kdst, E);
  take(t.dsrc, E);
  take(t.ddst, E);
  take(t.kx, E);
  take(t.order, E);
  take(t.comp, NC);
  take(t.sink, QK);
  take(t.proc, E);
  take(t.used, N);
  return (off + 15) & ~(size_t)15;
}

// Sum over i in [0, n) of f(i) in a fixed order, by one whole warp: lane j
// adds i = j, j+32, ... serially from 0, then a butterfly over the lanes
// (float addition commutes, so every lane ends with the same bits).
template <typename F>
__device__ __forceinline__ float bp_warp_sum(int n, F f) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int i = lane; i < n; i += 32) acc = acc + f(i);
  for (int o = 16; o > 0; o >>= 1)
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// base[key(u)] += val(u) for u = 0, 1, ..., U-1, by one whole warp, each
// index's updates added in the order of u, as a serial loop over the
// update list adds them (the plain version's scatter-add on the CPU).  The
// warp takes 32 updates at a time; __match_any_sync groups the lanes whose
// updates hit one index, and the lowest lane of each group adds its
// group's values in lane order.  Groups hit distinct indices, so they run
// side by side; __syncwarp orders one batch of 32 after the last.
template <typename Key, typename Val>
__device__ __forceinline__ void bp_warp_scatter(int U, Key key, Val val,
                                                float* base) {
  const int lane = threadIdx.x & 31;
  for (int u0 = 0; u0 < U; u0 += 32) {
    const int u = u0 + lane;
    const int k = u < U ? key(u) : -1 - lane;
    const unsigned group = __match_any_sync(0xffffffffu, k);
    if (u < U && (group & ((1u << lane) - 1u)) == 0u) {
      float acc = base[k];
      for (unsigned m = group; m; m &= m - 1u)
        acc = acc + val(u0 + __ffs(m) - 1);
      base[k] = acc;
    }
    __syncwarp();
  }
}

// One compensated-summation step, as ref.kahan_add.
__device__ __forceinline__ void bp_kahan(float* s, float* c, float x) {
  float y = x - *c;
  float t = *s + y;
  *c = (t - *s) - y;
  *s = t;
}

__global__ void __launch_bounds__(BP_SLOT_STEP_THREADS)
    bp_slot_step_kernel(const SlotStepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const int T = BP_SLOT_STEP_THREADS;
  const int N = a.N, NC = a.NC, E = a.E, C = 3 * NC;
  const int QK = N * C, DK = N * NC;
  Smem s;
  bp_slot_step_layout(smem, N, NC, E, &s);
  const int s1 = a.s1[b], s2 = a.s2[b], dest = a.dest[b];
  __shared__ int sh_nstar;

  // ---- load the sim's state and problem row ---------------------------
  for (int i = tid; i < QK; i += T) {
    s.Q[i] = a.Q[(int64_t)b * QK + i];
    s.sink[i] = a.sink[(int64_t)b * QK + i];
  }
  for (int i = tid; i < DK; i += T) s.D[i] = a.Ddum[(int64_t)b * DK + i];
  for (int i = tid; i < 2 * NC; i += T) {
    s.X[i] = a.X[(int64_t)b * 2 * NC + i];
    s.CA[i] = a.cum_arr[(int64_t)b * 2 * NC + i];
  }
  for (int n = tid; n < NC; n += T) {
    const int64_t g = (int64_t)b * NC + n;
    s.Y[n] = a.Y[g];
    s.H[n] = a.H[g];
    s.CC[n] = a.cum_comb[g];
    s.caps[n] = a.comp_caps[g];
    s.cmask[n] = a.comp_mask[g];
    s.comp[n] = a.comp_nodes[g];
  }
  for (int e = tid; e < E; e += T) {
    const int64_t g = (int64_t)b * E + e;
    s.m[e] = a.edges[2 * g];
    s.l[e] = a.edges[2 * g + 1];
    s.cap[e] = a.edge_cap[g];
    s.emask[e] = a.edge_mask[g];
  }
  for (int i = tid; i < N; i += T) s.used[i] = 0;
  __syncthreads();

  // ---- (i) load balance: n*, admission, H (eq. 9/10) -------------------
  if (tid == 0) {
    int ns = a.fixed_node;
    if (a.load_balance) {
      const float one_eps = __fadd_rn(1.0f, a.eps[b]);
      float best_s = INFINITY;
      ns = 0;
      for (int n = 0; n < NC; ++n) {
        const float sc = bp_balance_score(
            one_eps, s.Q[(s.comp[n] * 3 + 0) * NC + n],
            s.Q[(s1 * 3 + 1) * NC + n], s.Q[(s2 * 3 + 2) * NC + n], s.H[n],
            s.cmask[n]);
        bp_argmin_step(n, sc, &best_s, &ns);
      }
    }
    const float arr = a.arrivals[b];
    for (int n = 0; n < NC; ++n) s.asg[n] = n == ns ? arr : 0.0f;
    // A source that is the chosen comp node feeds X directly.
    const int at = s.comp[ns];
    const float to1 = at == s1 ? arr : 0.0f, to2 = at == s2 ? arr : 0.0f;
    const int k1 = (s1 * 3 + 1) * NC + ns, k2 = (s2 * 3 + 2) * NC + ns;
    s.Q[k1] = s.Q[k1] + (at == s1 ? 0.0f : arr);
    s.Q[k2] = s.Q[k2] + (at == s2 ? 0.0f : arr);
    s.X[ns * 2] = s.X[ns * 2] + to1;
    s.CA[ns * 2] = s.CA[ns * 2] + to1;
    s.X[ns * 2 + 1] = s.X[ns * 2 + 1] + to2;
    s.CA[ns * 2 + 1] = s.CA[ns * 2 + 1] + to2;
    for (int n = 0; n < NC; ++n)
      s.H[n] = fmaxf((s.H[n] + s.asg[n]) - s.caps[n], 0.0f);
    sh_nstar = ns;
  }
  __syncthreads();

  // ---- (ii) routing: B1 per link, then the allocation ------------------
  for (int e = tid; e < E; e += T) {
    const int m = s.m[e], l = s.l[e];
    int best;
    float dmax;
    bp_route_fold(s.Q + m * C, s.Q + l * C, C, &best, &dmax);
    const int bi = best / NC, bn = best % NC;
    const float cap = s.cap[e], ad = fabsf(dmax);
    float alloc = cap * (ad > 0.0f ? 1.0f : 0.0f);
    float w = ad * (cap > 0.0f ? 1.0f : 0.0f);
    alloc = alloc * s.emask[e];
    w = w * s.emask[e];
    const bool fwd = dmax > 0.0f;
    const int src = fwd ? m : l, dst = fwd ? l : m;
    s.alloc[e] = alloc;
    s.w[e] = w;
    s.bi[e] = bi;
    s.src[e] = src;
    s.ksrc[e] = (src * 3 + bi) * NC + bn;
    s.kdst[e] = (dst * 3 + bi) * NC + bn;
    s.dsrc[e] = src * NC + bn;
    s.ddst[e] = dst * NC + bn;
    s.kx[e] = bn * 2 + (bi - 1 > 0 ? bi - 1 : 0);
  }
  __syncthreads();

  if (a.wireless) {
    // Greedy maximal matching: links by rank (stable, decreasing weight).
    for (int e = tid; e < E; e += T) {
      const float we = s.w[e];
      int r = 0;
      for (int j = 0; j < E; ++j) {
        const float wj = s.w[j];
        r += (wj > we) || (wj == we && j < e);
      }
      s.order[r] = e;
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < E; ++r) {
        const int e = s.order[r], m = s.m[e], l = s.l[e];
        const bool ok = !s.used[m] && !s.used[l] && s.w[e] > 0.0f;
        if (ok) {
          s.used[m] = 1;
          s.used[l] = 1;
        }
        s.alloc[e] = s.alloc[e] * (ok ? 1.0f : 0.0f);
      }
    }
    __syncthreads();
  }

  // Outflow requested from each (node, class): a scatter-add of alloc
  // into zeros, over links in order.
  if (warp == 0) {
    for (int k = tid; k < QK; k += 32) s.tot[k] = 0.0f;
    __syncwarp();
    bp_warp_scatter(
        E, [&](int e) { return s.ksrc[e]; }, [&](int e) { return s.alloc[e]; },
        s.tot);
  }
  __syncthreads();

  // Capped, proportional outflows; the dummy share; where each link lands.
  for (int e = tid; e < E; e += T) {
    const int k = s.ksrc[e], bi = s.bi[e], src = s.src[e];
    const int bn = s.dsrc[e] - src * NC;
    const float q = s.Q[k], tot = s.tot[k];
    const float scale = tot > q ? q / fmaxf(tot, BP_TINY) : 1.0f;
    const float act = s.alloc[e] * scale;
    const float q0 = s.Q[(src * 3 + 0) * NC + bn], dsr = s.D[s.dsrc[e]];
    const float frac = q0 > 0.0f ? dsr / fmaxf(q0, BP_TINY) : 0.0f;
    const float moved = (act * frac) * (bi == 0 ? 1.0f : 0.0f);
    const bool snk = s.sink[s.kdst[e]] != 0;
    s.act[e] = act;
    s.moved[e] = moved;
    s.tonet[e] = act * (snk ? 0.0f : 1.0f);
    s.mnet[e] = moved * (snk ? 0.0f : 1.0f);
    s.tox[e] = act * (snk && bi >= 1 ? 1.0f : 0.0f);
    s.proc[e] = snk && bi == 0;
  }
  __syncthreads();

  // Departures over links in order, then arrivals: one update list per
  // leaf, one warp per leaf.
  if (warp == 0) {
    bp_warp_scatter(
        2 * E, [&](int u) { return u < E ? s.ksrc[u] : s.kdst[u - E]; },
        [&](int u) { return u < E ? -s.act[u] : s.tonet[u - E]; }, s.Q);
  } else if (warp == 1) {
    bp_warp_scatter(
        2 * E, [&](int u) { return u < E ? s.dsrc[u] : s.ddst[u - E]; },
        [&](int u) { return u < E ? -s.moved[u] : s.mnet[u - E]; }, s.D);
  } else if (warp == 2) {
    bp_warp_scatter(
        E, [&](int e) { return s.kx[e]; }, [&](int e) { return s.tox[e]; },
        s.X);
  } else if (warp == 3) {
    bp_warp_scatter(
        E, [&](int e) { return s.kx[e]; }, [&](int e) { return s.tox[e]; },
        s.CA);
  }
  __syncthreads();

  // ---- (iii) computation: Z (B2 on the routed state), regulator --------
  // Meanwhile warps 1-3 sum routing's deliveries: processed packets sunk
  // at d, their useful part, and all that moved.
  if (warp == 1) {
    const float v = bp_warp_sum(
        E, [&](int e) { return s.act[e] * (s.proc[e] ? 1.0f : 0.0f); });
    if ((tid & 31) == 0) s.red[0] = v;
  } else if (warp == 2) {
    const float v = bp_warp_sum(E, [&](int e) {
      return (s.act[e] - s.moved[e]) * (s.proc[e] ? 1.0f : 0.0f);
    });
    if ((tid & 31) == 0) s.red[1] = v;
  } else if (warp == 3) {
    const float v = bp_warp_sum(E, [&](int e) { return s.act[e]; });
    if ((tid & 31) == 0) s.red[2] = v;
  }
  for (int n = tid; n < NC; n += T) {
    float xnet = 0.0f;
    if (a.pairing_bound) {              // eq. (7): raw packets in flight
      float r1 = 0.0f, r2 = 0.0f;
      for (int k = 0; k < N; ++k) {
        r1 = r1 + s.Q[(k * 3 + 1) * NC + n];
        r2 = r2 + s.Q[(k * 3 + 2) * NC + n];
      }
      xnet = r1 + r2;
    }
    const float z = bp_combine_amount(
        s.caps[n], s.cmask[n], s.X[2 * n], s.X[2 * n + 1], s.CA[2 * n],
        s.CA[2 * n + 1], s.CC[n], xnet, a.pairing_bound, a.thresholded,
        a.threshold);
    s.Z[n] = z;
    s.X[2 * n] = s.X[2 * n] - z;
    s.X[2 * n + 1] = s.X[2 * n + 1] - z;
    s.CC[n] = s.CC[n] + z;
  }
  __syncthreads();
  // Regulator push (or Z straight on), then injection or delivery.  Each
  // comp node writes its own Q and Ddum entry, class 0: no collisions, and
  // no thread above reads class 0.
  for (int n = tid; n < NC; n += T) {
    const float z = s.Z[n];
    float amount = z, dummy = 0.0f;
    if (a.regulated) {
      const float yz = s.Y[n] + z;
      const float F =
          s.asg[n] * (1.0f + a.reg_draws[(int64_t)b * NC + n]);
      const float useful = fminf(yz, F);
      dummy = F - useful;
      s.Y[n] = yz - useful;
      amount = F;
    }
    const int c = s.comp[n];
    const float keep = c == dest ? 0.0f : 1.0f;
    s.Q[(c * 3 + 0) * NC + n] = s.Q[(c * 3 + 0) * NC + n] + amount * keep;
    s.D[c * NC + n] = s.D[c * NC + n] + dummy * keep;
    // What reaches d, and its useful part (tot is free again).
    s.tot[n] = amount * (1.0f - keep);
    s.tot[NC + n] = (amount - dummy) * (1.0f - keep);
  }
  __syncthreads();

  // ---- metrics and write-back ------------------------------------------
  if (warp == 1) {
    const float v = bp_warp_sum(QK, [&](int i) { return s.Q[i]; });
    if ((tid & 31) == 0) s.red[3] = v;
  } else if (warp == 2) {
    const float v = bp_warp_sum(2 * NC, [&](int i) { return s.X[i]; });
    if ((tid & 31) == 0) s.red[4] = v;
  } else if (warp == 3) {
    const float v = bp_warp_sum(NC, [&](int i) { return s.Y[i]; });
    if ((tid & 31) == 0) s.red[5] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float d = a.delivered[b], dc = a.delivered_c[b];
    float du = a.delivered_useful[b], duc = a.delivered_useful_c[b];
    bp_kahan(&d, &dc, s.red[0]);          // routing's deliveries
    bp_kahan(&du, &duc, s.red[1]);
    float d2 = 0.0f, du2 = 0.0f, zs = 0.0f;
    for (int n = 0; n < NC; ++n) {
      d2 = d2 + s.tot[n];
      du2 = du2 + s.tot[NC + n];
      zs = zs + s.Z[n];
    }
    bp_kahan(&d, &dc, d2);                // computation's deliveries
    bp_kahan(&du, &duc, du2);
    a.o_delivered[b] = d;
    a.o_delivered_c[b] = dc;
    a.o_delivered_useful[b] = du;
    a.o_delivered_useful_c[b] = duc;
    a.total_queue[b] = (s.red[3] + s.red[4]) + s.red[5];
    a.routed[b] = s.red[2];
    a.computed[b] = zs;
    a.n_star[b] = sh_nstar;
  }
  for (int i = tid; i < QK; i += T) a.oQ[(int64_t)b * QK + i] = s.Q[i];
  for (int i = tid; i < DK; i += T) a.oDdum[(int64_t)b * DK + i] = s.D[i];
  for (int i = tid; i < 2 * NC; i += T) {
    a.oX[(int64_t)b * 2 * NC + i] = s.X[i];
    a.o_cum_arr[(int64_t)b * 2 * NC + i] = s.CA[i];
  }
  for (int n = tid; n < NC; n += T) {
    const int64_t g = (int64_t)b * NC + n;
    a.oY[g] = s.Y[n];
    a.oH[g] = s.H[n];
    a.o_cum_comb[g] = s.CC[n];
    a.Z[g] = s.Z[n];
  }
}

extern "C" {

// Dynamic shared memory of one block (one sim) at this shape.
size_t bp_slot_step_smem_bytes(int N, int NC, int E) {
  return bp_slot_step_layout(nullptr, N, NC, E, nullptr);
}

int bp_slot_step(const SlotStepArgs* args, void* stream) {
  const SlotStepArgs& a = *args;
  if (a.B == 0) return (int)cudaSuccess;
  if (a.N < 1 || a.NC < 1 || a.E < 1) return BP_SLOT_STEP_TOO_LARGE;
  const size_t bytes = bp_slot_step_smem_bytes(a.N, a.NC, a.E);
  if (bytes > BP_SLOT_STEP_MAX_SMEM) return BP_SLOT_STEP_TOO_LARGE;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_slot_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  bp_slot_step_kernel<<<a.B, BP_SLOT_STEP_THREADS, bytes,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
