// Flash-attention backward on Hopper: the FlashAttention-2 gradients of
// tiled stable-softmax attention, causal or full, as two kernels.
//
// Replaces the TPU kernels of cekirdekler_tpu/ops/flash_attention.py::_flash_backward:
// the dq call (body _fa_bwd_dq_kernel, grid (B*H, q-blocks, k-blocks minor))
// and the dk/dv call (body _fa_bwd_dkv_kernel, grid (B*H, k-blocks,
// q-blocks minor)).  There the minor grid axis runs in order on one core
// and carries its f32 sums in VMEM scratch.  Here blocks run in parallel
// in no order, so one CTA owns one output tile and walks the minor axis
// itself in a loop, the sums in registers:
//   fa_bwd_dq_kernel:  one CTA per (b*h, 64-query tile), walking key tiles
//                      up to the causal limit; dq in registers;
//   fa_bwd_dkv_kernel: one CTA per (b*h, 64-key tile), walking query tiles
//                      from the first that can see the tile to Tq; dk and
//                      dv in registers.
// This is the reference's own split into two calls: every sum has one
// owner, so there are no atomics and the gradients are the same bit for
// bit from run to run.
//
// What both compute, per (query, key) pair of a visited tile pair, as the
// reference kernels do:
//   s  = (q . k) * scale, NEG = -1e30 where causal and key > query
//   p  = exp(s - lse)                 lse from the forward, per query row
//   dp = dO . v                       f32 sums of exact products
//   ds = p * (dp - delta) * scale     delta = rowsum(dO * O), per query row
//   dq += ds' . k;  dv += p' . dO;  dk += ds' . q
// where p' and ds' are p and ds rounded to bf16 under the "default"
// precision and p and ds themselves under "highest"; the f32 ds is never
// kept.  Each tile pair's product is summed on its own and then added to
// the running f32 sum, dq over key tiles and dk/dv over query tiles in
// order.  Keys past Tk score -inf and query rows past Tq take lse = +inf,
// so their p, and so their ds, is exactly 0; a causal row that sees no key
// of a tile gets p = exp(NEG - lse) = 0 as well, so the dk/dv loop may
// start at any query tile at or before the first that sees the key tile.
//
// Bound on this card: operations.  Causal attention at the model's shapes
// (B=4, T=2048, H=8, D=64) needs 10*D operations per live (query, key)
// pair and head (s recomputed, dp, dq, dk, dv: 2*D each), 43 GFLOP,
// against 68 MB of bf16 q/k/v/o/dO/dq/dk/dv and f32 lse/delta, far above
// the ridge point.  This first version is simple on purpose, like the forward: it
// stages the tiles in shared memory as f32 and runs every product as FP32
// multiplies and adds on the CUDA cores (4x4 query-by-key and 4xNC
// row-by-column micro-tiles per thread), with no tensor cores, wgmma or
// TMA, and no FMA contraction (the build passes -fmad=false; expf is the
// IEEE one).  It reads q/k/v/dO in their [B, T, H, D] layout through
// strides, so the q/k/v split views of the forward need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads: rows ty + 16 i, columns tx + 16 j
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(void* out, long long i, float x, int bf16) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(out)[i] = x;
}

// rows [t0, t0 + 64) of one (b, h) slice of a [B, T, H, D] tensor, as f32
// rows of stride ld in shared memory; rows past T are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long st,
                                          int t0, int T_, int D) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = t0 + r;
    dst[r * ld + c] = t < T_ ? to_f32(src[t * st + c]) : 0.0f;
  }
}

// out[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d], in order of d
__device__ __forceinline__ void tile_dot(float (&out)[4][4], const float* A, const float* Bm,
                                         int ld, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = out[i][j] + a[i] * b[j];
  }
}

// dot[i][j] = sum_n S[n][rows ty + 16 i] (or S[rows][n]) * M[n][tx + 16 j]
// over n < n_live: the tile's product summed on its own.  S is a
// [64][BN + 1] tile; transposed reads S[n][row], otherwise S[row][n].
template <int NC, bool TRANSPOSED>
__device__ __forceinline__ void tile_product(float (&dot)[4][NC], const float* S,
                                             const float* M, int ld, int D, int n_live,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dot[i][j] = 0.0f;
  for (int n = 0; n < n_live; ++n) {
    float a[4], m[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = TRANSPOSED ? S[n * (BN + 1) + ty + 16 * i] : S[(ty + 16 * i) * (BN + 1) + n];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      m[j] = c < D ? M[n * ld + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) dot[i][j] = dot[i][j] + a[i] * m[j];
  }
}

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh;
};

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dO, const float* __restrict__ lse,
                 const float* __restrict__ delta, void* __restrict__ dq, int H, int Tq, int Tk,
                 int D, Strides st, float scale, int causal, int dq_bf16, int round_ops) {
  extern __shared__ float smem[];
  const int DP = D + 1;                // padded rows: column reads hit distinct banks
  float* Qs = smem;                    // [BM][DP]
  float* dOs = Qs + BM * DP;           // [BM][DP]
  float* Ks = dOs + BM * DP;           // [BN][DP]
  float* Vs = Ks + BN * DP;            // [BN][DP]
  float* DSs = Vs + BN * DP;           // [BM][BN + 1] the tile's ds'
  float* lse_s = DSs + BM * (BN + 1);  // [BM]
  float* dlt_s = lse_s + BM;           // [BM]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BM;
  const T* kb = k + b * st.ksb + h * st.ksh;
  const T* vb = v + b * st.vsb + h * st.vsh;

  load_tile(Qs, DP, q + b * st.qsb + h * st.qsh, st.qst, q0, Tq, D);
  load_tile(dOs, DP, dO + b * st.osb + h * st.osh, st.ost, q0, Tq, D);
  if (tid < BM) {
    const int t = q0 + tid;
    lse_s[tid] = t < Tq ? lse[(long long)bh * Tq + t] : INFINITY;
    dlt_s[tid] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  const int q_last = min(q0 + BM, Tq) - 1;
  const int n_end = causal ? min(Tk, q_last + 1) : Tk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers of Ks, Vs and DSs are done
    load_tile(Ks, DP, kb, st.kst, n0, Tk, D);
    load_tile(Vs, DP, vb, st.vst, n0, Tk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, DP, D, ty, tx);
    tile_dot(dp, dOs, Vs, DP, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kp = n0 + c;
        float sv;
        if (kp >= Tk) sv = -INFINITY;
        else if (causal && kp > q0 + r) sv = NEG;
        else sv = s[i][j] * scale;
        const float p = expf(sv - lse_s[r]);
        const float ds = p * (dp[i][j] - dlt_s[r]) * scale;
        DSs[r * (BN + 1) + c] = round_ops ? round_bf16(ds) : ds;
      }
    }
    __syncthreads();

    float dot[4][NC];
    tile_product<NC, false>(dot, DSs, Ks, DP, D, min(BN, Tk - n0), ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = acc[i][j] + dot[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const long long base = ((long long)(b * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(dq, base + c, acc[i][j], dq_bf16);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dO, const float* __restrict__ lse,
                  const float* __restrict__ delta, void* __restrict__ dk,
                  void* __restrict__ dv, int H, int Tq, int Tk, int D, Strides st,
                  float scale, int causal, int dk_bf16, int dv_bf16, int round_ops) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Ks = smem;                    // [BN][DP]
  float* Vs = Ks + BN * DP;            // [BN][DP]
  float* Qs = Vs + BN * DP;            // [BM][DP]
  float* dOs = Qs + BM * DP;           // [BM][DP]
  float* Ps = dOs + BM * DP;           // [BM][BN + 1] the tile's p'
  float* DSs = Ps + BM * (BN + 1);     // [BM][BN + 1] the tile's ds'
  float* lse_s = DSs + BM * (BN + 1);  // [BM]
  float* dlt_s = lse_s + BM;           // [BM]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = blockIdx.x * BN;
  const T* qb = q + b * st.qsb + h * st.qsh;
  const T* ob = dO + b * st.osb + h * st.osh;

  load_tile(Ks, DP, k + b * st.ksb + h * st.ksh, st.kst, n0, Tk, D);
  load_tile(Vs, DP, v + b * st.vsb + h * st.vsh, st.vst, n0, Tk, D);

  // rows: keys ty + 16 i of the tile; columns tx + 16 j
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  // the first query tile that holds a query at or after key n0
  const int m_start = causal ? (n0 / BM) * BM : 0;
  for (int m0 = m_start; m0 < Tq; m0 += BM) {
    __syncthreads();  // the previous tile's readers of Qs, dOs, Ps and DSs are done
    load_tile(Qs, DP, qb, st.qst, m0, Tq, D);
    load_tile(dOs, DP, ob, st.ost, m0, Tq, D);
    if (tid < BM) {
      const int t = m0 + tid;
      lse_s[tid] = t < Tq ? lse[(long long)bh * Tq + t] : INFINITY;
      dlt_s[tid] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
    }
    __syncthreads();

    // p and ds of queries ty + 16 i against keys tx + 16 j
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, DP, D, ty, tx);
    tile_dot(dp, dOs, Vs, DP, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kp = n0 + c;
        float sv;
        if (kp >= Tk) sv = -INFINITY;
        else if (causal && kp > m0 + r) sv = NEG;
        else sv = s[i][j] * scale;
        const float p = expf(sv - lse_s[r]);
        const float ds = p * (dp[i][j] - dlt_s[r]) * scale;
        Ps[r * (BN + 1) + c] = round_ops ? round_bf16(p) : p;
        DSs[r * (BN + 1) + c] = round_ops ? round_bf16(ds) : ds;
      }
    }
    __syncthreads();

    const int m_live = min(BM, Tq - m0);
    float dot[4][NC];
    tile_product<NC, true>(dot, Ps, dOs, DP, D, m_live, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) dv_acc[i][j] = dv_acc[i][j] + dot[i][j];
    tile_product<NC, true>(dot, DSs, Qs, DP, D, m_live, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) dk_acc[i][j] = dk_acc[i][j] + dot[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = n0 + ty + 16 * i;
    if (t >= Tk) continue;
    const long long base = ((long long)(b * Tk + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c >= D) continue;
      store(dk, base + c, dk_acc[i][j], dk_bf16);
      store(dv, base + c, dv_acc[i][j], dv_bf16);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  void *g0, *g1;  // dq; or dk and dv
  int B, H, Tq, Tk, D;
  Strides st;
  float scale;
  int causal, bf16_0, bf16_1, round_ops;
  cudaStream_t stream;
};

template <typename T, int NC>
int launch_dq(const Args& a) {
  const size_t smem =
      sizeof(float) * (size_t)(4 * BM * (a.D + 1) + BM * (BN + 1) + 2 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.Tq + BM - 1) / BM), (unsigned)(a.B * a.H));
  fa_bwd_dq_kernel<T, NC><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, a.g0, a.H, a.Tq, a.Tk, a.D, a.st, a.scale,
      a.causal, a.bf16_0, a.round_ops);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_dkv(const Args& a) {
  const size_t smem =
      sizeof(float) * (size_t)(4 * BM * (a.D + 1) + 2 * BM * (BN + 1) + 2 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.Tk + BN - 1) / BN), (unsigned)(a.B * a.H));
  fa_bwd_dkv_kernel<T, NC><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, a.g0, a.g1, a.H, a.Tq, a.Tk, a.D, a.st,
      a.scale, a.causal, a.bf16_0, a.bf16_1, a.round_ops);
  return (int)cudaGetLastError();
}

// NC = columns of the accumulators per thread (D <= 16 * NC)
template <bool DQ, typename T>
int launch_d(const Args& a) {
  if (a.D <= 16) return DQ ? launch_dq<T, 1>(a) : launch_dkv<T, 1>(a);
  if (a.D <= 32) return DQ ? launch_dq<T, 2>(a) : launch_dkv<T, 2>(a);
  if (a.D <= 64) return DQ ? launch_dq<T, 4>(a) : launch_dkv<T, 4>(a);
  return DQ ? launch_dq<T, 8>(a) : launch_dkv<T, 8>(a);
}

template <bool DQ>
int launch_checked(const Args& a, int in_bf16) {
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.D <= 0 || a.D > 128 ||
      a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  return in_bf16 ? launch_d<DQ, __nv_bfloat16>(a) : launch_d<DQ, float>(a);
}

}  // namespace

// q, k, v, dO: [B, T, H, D] with unit stride over D and the given (batch,
// time, head) strides in elements, all of one type (f32, or bf16 when
// in_bf16); lse, delta: contiguous [B*H, Tq] f32.  dq: contiguous
// [B, Tq, H, D], bf16 when dq_bf16 else f32.  Returns a cudaError_t code
// (0 on success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dO, const float* lse, const float* delta,
                                      void* dq, int B, int H, int Tq, int Tk, int D,
                                      long long qsb, long long qst, long long qsh,
                                      long long ksb, long long kst, long long ksh,
                                      long long vsb, long long vst, long long vsh,
                                      long long osb, long long ost, long long osh,
                                      float scale, int causal, int in_bf16, int dq_bf16,
                                      int round_ops, void* stream) {
  const Args a{q, k, v, dO, lse, delta, dq, nullptr, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               scale, causal, dq_bf16, 0, round_ops, static_cast<cudaStream_t>(stream)};
  return launch_checked<true>(a, in_bf16);
}

// As above; dk, dv: contiguous [B, Tk, H, D], each bf16 when its flag is
// set, else f32.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dO, const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                                       long long qsb, long long qst, long long qsh,
                                       long long ksb, long long kst, long long ksh,
                                       long long vsb, long long vst, long long vsh,
                                       long long osb, long long ost, long long osh,
                                       float scale, int causal, int in_bf16, int dk_bf16,
                                       int dv_bf16, int round_ops, void* stream) {
  const Args a{q, k, v, dO, lse, delta, dk, dv, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               scale, causal, dk_bf16, dv_bf16, round_ops, static_cast<cudaStream_t>(stream)};
  return launch_checked<false>(a, in_bf16);
}
