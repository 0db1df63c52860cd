// Flash-attention forward on Hopper: tiled stable-softmax attention, causal
// or full, with an optional per-row logsumexp; and its ring-attention form,
// which returns the unnormalized state of q against one K/V block.
//
// Replaces two TPU kernels of cekirdekler_tpu/ops/flash_attention.py:
// _flash_forward (body _fa_kernel with parts=False), kernel fa_fwd_kernel,
// entry point flash_attention_fwd; and flash_attention_parts (the same body
// with parts=True), kernel fa_fwd_parts_kernel, entry point
// flash_attention_fwd_parts.  There the grid is (B*H, q-blocks,
// k-blocks) with the k axis run in order on one core and the running max,
// denominator and accumulator carried in VMEM scratch between grid steps.
// Here blocks run in parallel in no order, so one CTA owns one (b*h, query
// tile) and walks the key tiles itself in a loop: the carries live in
// shared memory (max, denominator) and in registers (the accumulator).
// The tile sizes are this kernel's own (BM query rows, BN keys); the
// caller's block_q/block_k only feed the reference's divisibility check.
//
// What it computes, per query row, as _fa_kernel does:
//   s = (q . k) * scale                    f32 sums of exact products
//   s = NEG where causal and key > query    (finite mask, NEG = -1e30)
//   m' = max(m, rowmax s); p = exp(s - m'); alpha = exp(m - m')
//   acc = acc * alpha + round(p) . v;  l = l * alpha + rowsum p
//   out = acc / max(l, 1e-30);  lse = m + log(max(l, 1e-30))
// round(p) is p rounded to bf16 under the "default" precision (only the
// copy that multiplies V; l sums the f32 p), and p itself under "highest".
// Keys past Tk score -inf, so their p is exactly 0; query rows past Tq are
// computed on zeros and not stored.  Under causal (which needs Tq == Tk)
// the loop stops at the last key tile that the tile's last query can see,
// and since BM == BN every row of every visited tile has a live key.
//
// The parts form takes the global positions of the first query and key,
// q_pos0 and k_pos0, at run time: key j is visible to query i where
// k_pos0 + j <= q_pos0 + i.  So a whole block may be dead
// (k_pos0 > q_pos0 + Tq - 1): the loop then runs no tile and the kernel
// writes the initial state, m = NEG, l = 0, acc = 0, as the reference's
// finish step does.  A row that sees no key of a live tile keeps that
// state too (p = 0 while its running max is still NEG), where the
// reference's p = exp(NEG - NEG) = 1 would add the tile's keys; the ring
// weights such a row out by exp(NEG - m) either way.  It writes the f32
// accumulator unnormalized, [B, Tq, H, D], and the running max and
// denominator, [B, Tq, H], and no lse.  It is a function of its own, with
// the same tiles, products and order of sums as fa_fwd_kernel: folded into
// fa_fwd_kernel behind a template flag, the flag off still changed what
// ptxas made of the single-card instantiation (index math moved off the
// uniform datapath) and cost it 7% at 4x2048x8x64 causal bf16 on an H100.
//
// Bound on this card: operations.  Causal attention at the model's shapes
// (B=4, T=2048, H=8, D=64) is 2*B*H*T^2*D = 17.2 GFLOP against 34 MB of
// q/k/v/o, far above the card's ridge point.  This first version is simple
// on purpose: it stages K/V tiles in shared memory as f32 and runs both
// products as FP32 multiplies and adds on the CUDA cores (4x4 query-by-key
// and 4xNC query-by-column micro-tiles per thread), with no tensor cores,
// wgmma or TMA, and no FMA contraction (the build passes -fmad=false and
// expf/logf are the IEEE ones).  It reads q/k/v in their [B, T, H, D]
// layout through strides, so neither the reference's transposes to
// [B*H, T, D] nor a copy of the q/k/v split views is needed.  The ring
// calls the parts form at "highest" whatever the input type, so there the
// work is f32 arithmetic and its bound is the FP32 peak, not the bf16 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads: rows ty + 16 i, columns tx + 16 j
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// NC = columns of the accumulator per thread (D <= 16 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              void* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, int D,
              long long qsb, long long qst, long long qsh, long long ksb, long long kst,
              long long ksh, long long vsb, long long vst, long long vsh, float scale,
              int causal, int out_bf16, int round_p) {
  extern __shared__ float smem[];
  const int DP = D + 1;               // padded rows: column reads hit distinct banks
  float* Qs = smem;                   // [BM][DP]
  float* Ks = Qs + BM * DP;           // [BN][DP]
  float* Vs = Ks + BN * DP;           // [BN][D]
  float* Ps = Vs + BN * D;            // [BM][BN + 1] scores, then probabilities
  float* m_s = Ps + BM * (BN + 1);    // [BM] running max
  float* l_s = m_s + BM;              // [BM] running denominator
  float* a_s = l_s + BM;              // [BM] this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BM;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = q0 + r;
    Qs[r * DP + c] = t < Tq ? to_f32(qb[t * qst + c]) : 0.0f;
  }
  if (tid < BM) {
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  const int q_last = min(q0 + BM, Tq) - 1;
  const int n_end = causal ? min(Tk, q_last + 1) : Tk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers of Ks, Vs and Ps are done
    for (int i = tid; i < BN * D; i += THREADS) {
      const int r = i / D, c = i - (i / D) * D;
      const int t = n0 + r;
      const bool in = t < Tk;
      Ks[r * DP + c] = in ? to_f32(kb[t * kst + c]) : 0.0f;
      Vs[r * D + c] = in ? to_f32(vb[t * vst + c]) : 0.0f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] + qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kp = n0 + c;
        float val;
        if (kp >= Tk) val = -INFINITY;
        else if (causal && kp > q0 + r) val = NEG;
        else val = s[i][j] * scale;
        Ps[r * (BN + 1) + c] = val;
      }
    }
    __syncthreads();

    // running softmax statistics: four neighbouring threads per row
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = Ps + r * (BN + 1);
      float mx = -INFINITY;
      for (int c = part; c < BN; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = part; c < BN; c += 4) {
        const float p = expf(row[c] - m_new);
        sum = sum + p;
        row[c] = round_p ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V, the tile's product summed on its own first
    float dot[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) dot[i][j] = 0.0f;
    const int n_live = min(BN, Tk - n0);
    for (int n = 0; n < n_live; ++n) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BN + 1) + n];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < D ? Vs[n * D + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) dot[i][j] = dot[i][j] + pv[i] * vv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = acc[i][j] * alpha + dot[i][j];
    }
  }

  // m_s / l_s were last written before the final __syncthreads of the loop
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t >= Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    const long long base = ((long long)(b * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c >= D) continue;
      const float o = acc[i][j] / l;
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[base + c] = __float2bfloat16_rn(o);
      else
        reinterpret_cast<float*>(out)[base + c] = o;
    }
  }
  if (lse != nullptr && tid < BM && q0 + tid < Tq)
    lse[(long long)bh * Tq + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// The parts form: as fa_fwd_kernel, with the causal mask shifted by the
// global positions q_pos0 / k_pos0, the empty state kept by rows that have
// seen no key, and the unnormalized state stored: acc [B, Tq, H, D], m and
// l [B, Tq, H], all f32.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
fa_fwd_parts_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int H, int Tq, int Tk,
                    int D, long long qsb, long long qst, long long qsh, long long ksb,
                    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
                    float scale, int causal, int round_p, int q_pos0, int k_pos0) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;                   // [BM][DP]
  float* Ks = Qs + BM * DP;           // [BN][DP]
  float* Vs = Ks + BN * DP;           // [BN][D]
  float* Ps = Vs + BN * D;            // [BM][BN + 1] scores, then probabilities
  float* m_s = Ps + BM * (BN + 1);    // [BM] running max
  float* l_s = m_s + BM;              // [BM] running denominator
  float* a_s = l_s + BM;              // [BM] this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BM;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = q0 + r;
    Qs[r * DP + c] = t < Tq ? to_f32(qb[t * qst + c]) : 0.0f;
  }
  if (tid < BM) {
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  const int q_last = min(q0 + BM, Tq) - 1;
  // one past the last key the tile's last query can see (0: a dead block)
  const int n_end = causal ? max(0, min(Tk, q_pos0 + q_last - k_pos0 + 1)) : Tk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers of Ks, Vs and Ps are done
    for (int i = tid; i < BN * D; i += THREADS) {
      const int r = i / D, c = i - (i / D) * D;
      const int t = n0 + r;
      const bool in = t < Tk;
      Ks[r * DP + c] = in ? to_f32(kb[t * kst + c]) : 0.0f;
      Vs[r * D + c] = in ? to_f32(vb[t * vst + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] + qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kp = n0 + c;
        float val;
        if (kp >= Tk) val = -INFINITY;
        else if (causal && k_pos0 + kp > q_pos0 + q0 + r) val = NEG;
        else val = s[i][j] * scale;
        Ps[r * (BN + 1) + c] = val;
      }
    }
    __syncthreads();

    {
      const int r = tid >> 2, part = tid & 3;
      float* row = Ps + r * (BN + 1);
      float mx = -INFINITY;
      for (int c = part; c < BN; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool empty = m_new == NEG;  // the row has seen no key
      float sum = 0.0f;
      for (int c = part; c < BN; c += 4) {
        const float p = empty ? 0.0f : expf(row[c] - m_new);
        sum = sum + p;
        row[c] = round_p ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    float dot[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) dot[i][j] = 0.0f;
    const int n_live = min(BN, Tk - n0);
    for (int n = 0; n < n_live; ++n) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BN + 1) + n];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < D ? Vs[n * D + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) dot[i][j] = dot[i][j] + pv[i] * vv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = acc[i][j] * alpha + dot[i][j];
    }
  }

  __syncthreads();  // a dead block runs no tile: m_s / l_s are the initial state
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t >= Tq) continue;
    const long long row = (long long)(b * Tq + t) * H + h;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) acc_out[row * D + c] = acc[i][j];
    }
    if (tx == 0) {
      m_out[row] = m_s[r];
      l_out[row] = l_s[r];
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
           int Tq, int Tk, int D, const long long* st, float scale, int causal, int out_bf16,
           int round_p, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + 3 * BM);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Tq + BM - 1) / BM), (unsigned)(B * H));
  fa_fwd_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, lse,
      H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, out_bf16, round_p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
             int Tq, int Tk, int D, const long long* st, float scale, int causal,
             int out_bf16, int round_p, cudaStream_t stream) {
  if (D <= 16)
    return launch<T, 1>(q, k, v, out, lse, B, H, Tq, Tk, D, st, scale, causal, out_bf16,
                        round_p, stream);
  if (D <= 32)
    return launch<T, 2>(q, k, v, out, lse, B, H, Tq, Tk, D, st, scale, causal, out_bf16,
                        round_p, stream);
  if (D <= 64)
    return launch<T, 4>(q, k, v, out, lse, B, H, Tq, Tk, D, st, scale, causal, out_bf16,
                        round_p, stream);
  return launch<T, 8>(q, k, v, out, lse, B, H, Tq, Tk, D, st, scale, causal, out_bf16,
                      round_p, stream);
}

template <typename T, int NC>
int launch_parts(const void* q, const void* k, const void* v, float* acc, float* m, float* l,
                 int B, int H, int Tq, int Tk, int D, const long long* st, float scale,
                 int causal, int round_p, int q_pos0, int k_pos0, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + 3 * BM);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_parts_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Tq + BM - 1) / BM), (unsigned)(B * H));
  fa_fwd_parts_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), acc, m, l,
      H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, round_p, q_pos0, k_pos0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_parts_d(const void* q, const void* k, const void* v, float* acc, float* m, float* l,
                   int B, int H, int Tq, int Tk, int D, const long long* st, float scale,
                   int causal, int round_p, int q_pos0, int k_pos0, cudaStream_t stream) {
  if (D <= 16)
    return launch_parts<T, 1>(q, k, v, acc, m, l, B, H, Tq, Tk, D, st, scale, causal, round_p,
                              q_pos0, k_pos0, stream);
  if (D <= 32)
    return launch_parts<T, 2>(q, k, v, acc, m, l, B, H, Tq, Tk, D, st, scale, causal, round_p,
                              q_pos0, k_pos0, stream);
  if (D <= 64)
    return launch_parts<T, 4>(q, k, v, acc, m, l, B, H, Tq, Tk, D, st, scale, causal, round_p,
                              q_pos0, k_pos0, stream);
  return launch_parts<T, 8>(q, k, v, acc, m, l, B, H, Tq, Tk, D, st, scale, causal, round_p,
                            q_pos0, k_pos0, stream);
}

}  // namespace

// q/k/v: [B, T, H, D] with unit stride over D and the given (batch, time,
// head) strides in elements, all of one type (f32, or bf16 when in_bf16);
// out: contiguous [B, Tq, H, D], bf16 when out_bf16 else f32; lse: NULL or
// contiguous [B*H, Tq] f32.  Returns a cudaError_t code (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int B, int H, int Tq, int Tk, int D,
                                   long long qsb, long long qst, long long qsh,
                                   long long ksb, long long kst, long long ksh,
                                   long long vsb, long long vst, long long vsh, float scale,
                                   int causal, int in_bf16, int out_bf16, int round_p,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, lse, B, H, Tq, Tk, D, st, scale, causal,
                                   out_bf16, round_p, s);
  return launch_d<float>(q, k, v, out, lse, B, H, Tq, Tk, D, st, scale, causal, out_bf16,
                         round_p, s);
}

// The parts form: q/k/v as above; acc: contiguous [B, Tq, H, D] f32; m, l:
// contiguous [B, Tq, H] f32; q_pos0 / k_pos0: global positions of query 0
// and key 0 for the causal mask.  Returns a cudaError_t code.
extern "C" int flash_attention_fwd_parts(const void* q, const void* k, const void* v,
                                         float* acc, float* m, float* l, int B, int H, int Tq,
                                         int Tk, int D, long long qsb, long long qst,
                                         long long qsh, long long ksb, long long kst,
                                         long long ksh, long long vsb, long long vst,
                                         long long vsh, float scale, int causal, int in_bf16,
                                         int round_p, int q_pos0, int k_pos0, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_parts_d<__nv_bfloat16>(q, k, v, acc, m, l, B, H, Tq, Tk, D, st, scale,
                                         causal, round_p, q_pos0, k_pos0, s);
  return launch_parts_d<float>(q, k, v, acc, m, l, B, H, Tq, Tk, D, st, scale, causal, round_p,
                               q_pos0, k_pos0, s);
}
