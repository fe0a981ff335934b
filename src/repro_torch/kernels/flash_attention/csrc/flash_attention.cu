// Flash attention forward: blockwise online softmax, GQA, causal and
// sliding-window masks (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel).  For q [B, H, S, D] and k, v [B, KH, T, D], query
// head h reading kv head h / (H / KH), query i sees key j when j < T,
// j <= i (causal) and j > i - window (window >= 0):
//   s = (q * scale) . k, masked keys set to NEG_INF = -1e30;
//   per kv block: m' = max(m, max_j s);  alpha = exp(m - m');
//     p = exp(s - m'), forced to 0 on masked keys;
//     l = l * alpha + sum p;  acc = acc * alpha + p . v;
//   out = acc / max(l, 1e-30) (rows with no valid key give 0),
// with float32 running max, sum and accumulator whatever the input type
// (float32 or bfloat16; the output is rounded with __float2bfloat16_rn).
//
// Bound: operations.  A causal call does 4 H D S (S + 1) / 2 flops per
// batch row (two dot products of length D per valid (query, key) pair) and
// moves only q, k, v and out once: at granite's prefill shape (S = 32768,
// H = 16, KH = 8, D = 64, bf16) that is 2.2e12 flops against 0.20 GB,
// 2.2 ms at the card's dense bf16 tensor-core rate of 989 TFLOP/s (the
// operands' type; this kernel computes on the CUDA cores in float32, whose
// 67 TFLOP/s would take 32.8 ms) and 0.06 ms at 3.35 TB/s.
//
// This is the CUDA-core kernel: the wrapper (kernel.py) sends it float32
// inputs and bfloat16 inputs with head dim 16 or 32.  bfloat16 at head dim
// 64 or 128 goes to flash_attention_sm90.cu (wgmma, TMA).
//
// Design (simple and right first): one CTA of 64 threads per (64-query
// block, head, batch row), one thread per query row.  The CTA stages its
// scaled q block in shared memory, transposed so that each thread's float4
// loads are conflict-free, then walks the kv blocks its rows can see: each
// 64-key block of K and V is staged in shared memory as float32, and every
// thread computes its row's 64 scores in registers (d outer, keys inner:
// one broadcast float4 load feeds four FMAs per key), folds them into its
// running max and sum, and accumulates p . v into D float32 registers.
// Blocks that the causal or window mask empties for every row of the CTA
// are not visited (visiting them would leave m, l and acc unchanged), and
// the mask is evaluated only on blocks that cross a mask edge or the end
// of T.  Any S and T are accepted: rows past S compute and are not stored,
// keys past T are masked.  The grid's first blocks take the last query
// blocks, which see the most keys under a causal mask.  q, k, v and out
// are addressed through their batch, head and sequence strides (the last
// axis contiguous), so the model's [B, S, H, D] tensors need no transpose.
//
// The dot products are written with fmaf.  This kernel has no
// bit-exactness contract: it agrees with the plain version (ref.py) to
// rounding, and its build (kernels/_build.py) leaves multiply-adds free to
// fuse (no -fmad=false, which bp_slot, bp_topk and bp_route keep).
//
// Instantiated: head dims 16, 32, 64 and 128 in float32; 16 and 32 in
// bfloat16.  The C entry launches on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not
// instantiate), which the ctypes wrapper turns into an exception.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define NEG_INF (-1e30f)

struct Params {
  int S, T, G;
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  int causal, window;  // window < 0: no window
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool key_ok(int qi, int kj, const Params& p) {
  return kj < p.T && (!p.causal || qi >= kj) &&
         (p.window < 0 || kj > qi - p.window);
}

template <int D, typename T>
__global__ void __launch_bounds__(BQ)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Params p) {
  extern __shared__ float4 smem[];
  float4* q_s = smem;                          // [D/4][BQ] float4
  float* k_s = (float*)(smem + (D / 4) * BQ);  // [BK][D]
  float* v_s = k_s + BK * D;                   // [BK][D]

  const int t = threadIdx.x;
  const int qblk = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qblk * BQ;
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int qi = q0 + t;
  const T* qp = q + b * p.qb + h * p.qh;
  const T* kp = k + b * p.kb + (h / p.G) * p.kh;
  const T* vp = v + b * p.vb + (h / p.G) * p.vh;

  // scaled q block, row r's dims 4c..4c+3 in q_s[c * BQ + r]
  float* qf = (float*)q_s;
  for (int i = t; i < BQ * D; i += BQ) {
    const int r = i / D, d = i % D;
    const float x = q0 + r < p.S ? to_f(qp[(q0 + r) * p.qs + d]) : 0.0f;
    qf[((d / 4) * BQ + r) * 4 + (d % 4)] = x * p.scale;
  }

  // kv blocks some row of this CTA can see
  const int lo_key = p.window >= 0 ? max(q0 - p.window + 1, 0) : 0;
  const int hi_key = p.causal ? min(p.T - 1, q_last) : p.T - 1;
  const int lo = lo_key / BK;
  const int hi = hi_key < lo_key ? lo : hi_key / BK + 1;

  float m = NEG_INF, l = 0.0f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;

  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block is consumed (q is staged)
    for (int i = t; i < BK * D; i += BQ) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < p.T;
      k_s[i] = in ? to_f(kp[(k0 + j) * p.ks + d]) : 0.0f;
      v_s[i] = in ? to_f(vp[(k0 + j) * p.vs + d]) : 0.0f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.0f;
    for (int c = 0; c < D / 4; ++c) {
      const float4 qv = q_s[c * BQ + t];
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 kv = *(const float4*)(k_s + j * D + 4 * c);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    // does some (row, key) pair of this block fall outside the mask?
    const bool edge = k0 + BK > p.T || (p.causal && k0 + BK - 1 > q0) ||
                      (p.window >= 0 && k0 <= q_last - p.window);
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (edge && !key_ok(qi, k0 + j, p)) s[j] = NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float pj = expf(s[j] - m_new);
      if (edge && !key_ok(qi, k0 + j, p)) pj = 0.0f;  // exp(NEG_INF - m)
      l += pj;
      const float* vr = v_s + j * D;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 vv = *(const float4*)(vr + 4 * c);
        acc[4 * c] = fmaf(pj, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(pj, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pj, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pj, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (qi < p.S) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + b * p.ob + h * p.oh + qi * p.os;
#pragma unroll
    for (int d = 0; d < D; ++d) store(orow + d, acc[d] / den);
  }
}

template <int D, typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int H, const Params& p, cudaStream_t stream) {
  const size_t smem = 3 * (size_t)BQ * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((p.S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D, T><<<grid, BQ, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
  return (int)cudaGetLastError();
}

static int dispatch_f32(const void* q, const void* k, const void* v,
                        void* o, int B, int H, int D, const Params& p,
                        cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, float>(q, k, v, o, B, H, p, stream);
    case 32: return launch<32, float>(q, k, v, o, B, H, p, stream);
    case 64: return launch<64, float>(q, k, v, o, B, H, p, stream);
    case 128: return launch<128, float>(q, k, v, o, B, H, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

static int dispatch_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int D, const Params& p,
                         cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  switch (D) {
    case 16: return launch<16, bf16>(q, k, v, o, B, H, p, stream);
    case 32: return launch<32, bf16>(q, k, v, o, B, H, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// strides: 12 element strides, (batch, head, sequence) of q, k, v and out.
// dtype: 0 = float32, 1 = bfloat16.  window < 0: no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KH, int S, int T, int D,
                        const long long* strides, int causal, int window,
                        float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaSuccess;
  if (KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.S = S;
  p.T = T;
  p.G = H / KH;
  p.qb = strides[0]; p.qh = strides[1]; p.qs = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.ks = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vs = strides[8];
  p.ob = strides[9]; p.oh = strides[10]; p.os = strides[11];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_f32(q, k, v, o, B, H, D, p, s);
  if (dtype == 1) return dispatch_bf16(q, k, v, o, B, H, D, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
