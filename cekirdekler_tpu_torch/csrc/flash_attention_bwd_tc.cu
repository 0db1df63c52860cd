// Flash-attention backward on Hopper's tensor cores: the FlashAttention-2
// gradients of tiled stable-softmax attention, causal or full, as two
// kernels, for bf16 q/k/v/dO under precision="default".
//
// Replaces, on that path, the TPU kernels of
// cekirdekler_tpu/ops/flash_attention.py::_flash_backward (:661): the dq
// call (body _fa_bwd_dq_kernel, :491) and the dk/dv call (body
// _fa_bwd_dkv_kernel, :569), and their ring-attention form
// flash_attention_bwd_parts (:745) when it runs at "default" on bf16.  The
// FP32 kernels of csrc/flash_attention_bwd.cu keep every other case (f32,
// "highest", the ring's parts at "highest").  As there, one CTA owns one
// output tile and walks the other axis in a loop, so every gradient has one
// owner, there are no atomics, and the bits are the same from run to run:
//   fa_bwd_dq_tc_kernel:  one CTA per (b*h, 64-query tile), walking key tiles
//                         up to the causal limit; dq in registers;
//   fa_bwd_dkv_tc_kernel: one CTA per (b*h, 64-key tile), walking query
//                         tiles from the first that can see the tile to Tq;
//                         dk and dv in registers.
//
// What both compute, per (query, key) pair of a visited tile pair, as the
// reference kernels do:
//   s  = (q . k) * scale, NEG = -1e30 where causal and key > query
//   p  = exp(s - lse)                 lse from the forward, per query row
//   dp = dO . v
//   ds = p * (dp - delta) * scale     delta = rowsum(dO * O), f32 from torch
//   dq += ds' . k;  dv += p' . dO;  dk += ds' . q
// with p' = bf16(p) and ds' = bf16(ds), rounded where the reference rounds
// them.  Every operand of the five products is bf16, so each product of two
// elements is exact in f32 and the tensor cores' f32 sums differ from the
// FP32 kernels' only in order.  p comes from expf (IEEE) in f32.  Keys past
// Tk score -inf and query rows past Tq take lse = +inf, so their p and ds
// are exactly 0; a causal row that sees no key of a tile gets
// p = exp(NEG - lse) = 0.  q_pos0 / k_pos0 are the global positions of
// query 0 and key 0 (0 and 0 on one card): key j is visible to query i
// where k_pos0 + j <= q_pos0 + i, and a wholly masked block runs no tile
// and stores zero gradients.
//
// Bound on this card: operations.  Per live (query, key) pair and head the
// dq kernel does 6*D (s, dp, dq) and the dk/dv kernel 8*D (s, dp, dk, dv)
// operations, against the bf16 tensor-core peak (989 TFLOP/s); at the
// model's shapes (B=4, T=2048, H=8, D=64, causal) that is 0.026 ms and
// 0.035 ms, where their 42 MB and 51 MB of bytes take 0.013 and 0.015 ms.
//
// What the design does about the FP32 kernels' three limits:
//   1. no tensor cores: every product is mma.sync.m16n8k16 bf16 x bf16 ->
//      f32 from inline PTX, operands read from shared memory by ldmatrix
//      (.trans where the contraction runs over a tile's rows: K in ds'.K,
//      dO in pT'.dO, Q in dsT'.Q);
//   2. shared memory as the bottleneck: tiles are bf16, [64][Dk + 8] with
//      Dk = D rounded up to 16 (the 16-byte pad puts the 8 rows of an
//      ldmatrix on 8 distinct bank groups); columns past D and rows past T
//      are zeros, which add exact zeros to every product and are never
//      stored.  Each warp owns 16 rows: s and dp (or sT and dpT) are 16x64
//      f32 accumulators in registers, and the m16n8 accumulator layout of
//      two adjacent n8 tiles is the A layout of one k16 step, so ds' (and
//      pT') go from the accumulators straight into the next product's A
//      fragments and never touch shared memory.  The dk/dv kernel computes
//      sT = K.QT and dpT = V.dOT for that reason, with the 64 queries' lse
//      and delta in shared memory, read across the columns.  For Dk <= 64
//      a warp keeps its q and dO (or K and V) fragments in registers for
//      the whole loop; above that it reads them again from shared memory,
//      which leaves the registers to the 16 x Dk accumulators;
//   3. synchronous loads: tiles are copied by cp.async.cg, 16 bytes a copy,
//      in a two-stage ring, so the next K/V (or Q/dO) tile is in flight
//      while the current one is multiplied.  Where D % 8 != 0, or a pointer
//      or a (batch, time, head) stride is not a multiple of 16 bytes, the
//      wrapper passes vec = 0 and the same layout is filled by element
//      loads.
// Under causal the dq kernel takes its query tiles last-first, so the CTAs
// that walk the most key tiles start first; the grid's x axis is b*h, so
// every head's longest tiles lead.  wgmma, TMA, warp specialisation and
// persistent CTAs are not used.  The build passes -fmad=false; the only
// multiply-adds are the tensor cores' own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;  // warp w owns rows 16 w .. 16 w + 15
constexpr float NEG = -1e30f;

struct Strides {
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d[16x8] += a[16x16] . b[16x8], bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of the k16 steps over a 16x64 accumulator tile: step kk
// takes n8 tiles 2 kk and 2 kk + 1, rounded to bf16.
__device__ __forceinline__ void to_a_fragments(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// Row-major 16x16 block at (row, col) of a [.][LD] tile, as an A fragment;
// the same addresses with .trans give the B fragments of two n8 tiles
// (columns col .. col + 15) of a block whose rows run over k.
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int row, int col, int lane) {
  return tile + (row + (lane & 15)) * LD + col + (lane >> 4) * 8;
}

// B fragments of two n8 tiles (rows row .. row + 15 of a [.][LD] tile whose
// rows run over n, columns col .. col + 15 over k): r[0..1] for rows
// row .. row + 7, r[2..3] for rows row + 8 .. row + 15.
template <int LD>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int row, int col, int lane) {
  return tile + (row + (lane & 7) + ((lane >> 4) << 3)) * LD + col + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ void store(void* out, long long i, float x, int as_bf16) {
  if (as_bf16)
    reinterpret_cast<bf16*>(out)[i] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(out)[i] = x;
}

// rows [t0, t0 + 64) of one (b, h) slice of a [B, T, H, D] tensor into a
// [64][DK + 8] bf16 tile; rows past T and columns past D are zeros.  vec:
// 16-byte cp.async copies (the caller commits); else element loads.
template <int DK>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long st, int t0,
                                          int T_, int D, int vec) {
  constexpr int LD = DK + 8;
  if (vec) {
    constexpr int CH = DK / 8;
    for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const int t = t0 + r;
      const bool ok = t < T_ && c < D;
      cp_async16(dst + r * LD + c, ok ? src + t * st + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * DK; i += THREADS) {
      const int r = i / DK, c = i - r * DK;
      const int t = t0 + r;
      dst[r * LD + c] = t < T_ && c < D ? src[t * st + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    void* __restrict__ dq, int H, int Tq, int Tk, int D, Strides st,
                    float scale, int causal, int dq_bf16, int vec, int q_pos0, int k_pos0) {
  constexpr int LD = DK + 8;
  constexpr int TILE = 64 * LD;
  constexpr int NK = DK / 16;       // k16 steps over the head dim
  constexpr bool REGS = DK <= 64;   // q and dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dOs = Qs + TILE;                          // [64][LD]
  bf16* Ks = dOs + TILE;                          // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE;                       // [2][64][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const bf16* kb = k + b * st.ksb + h * st.ksh;
  const bf16* vb = v + b * st.vsb + h * st.vsh;

  const int q_last = min(q0 + BM, Tq) - 1;
  // one past the last key the tile's last query can see (0: a dead block)
  const int n_end = causal ? max(0, min(Tk, q_pos0 + q_last - k_pos0 + 1)) : Tk;
  load_tile<DK>(Qs, q + b * st.qsb + h * st.qsh, st.qst, q0, Tq, D, vec);
  load_tile<DK>(dOs, dO + b * st.osb + h * st.osh, st.ost, q0, Tq, D, vec);
  if (n_end > 0) {
    load_tile<DK>(Ks, kb, st.kst, 0, Tk, D, vec);
    load_tile<DK>(Vs, vb, st.vst, 0, Tk, D, vec);
  }
  cp_async_commit();

  // this thread's query rows in the tile: r0 (accumulator elements 0, 1)
  // and r0 + 8 (elements 2, 3)
  const int r0 = warp * 16 + g;
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    lse_r[i] = t < Tq ? lse[(long long)bh * Tq + t] : INFINITY;
    dlt_r[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
  }

  float acc[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  uint32_t qf[REGS ? NK : 1][4], of[REGS ? NK : 1][4];

  for (int it = 0, n0 = 0; n0 < n_end; ++it, n0 += BN) {
    const int cur = it & 1;
    if (n0 + BN < n_end) {
      load_tile<DK>(Ks + (cur ^ 1) * TILE, kb, st.kst, n0 + BN, Tk, D, vec);
      load_tile<DK>(Vs + (cur ^ 1) * TILE, vb, st.vst, n0 + BN, Tk, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and q/dO's) have landed
    __syncthreads();
    const bf16* Kt = Ks + cur * TILE;
    const bf16* Vt = Vs + cur * TILE;
    if constexpr (REGS) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < NK; ++ks) {
          ldsm_x4(qf[ks], a_addr<LD>(Qs, warp * 16, ks * 16, lane));
          ldsm_x4(of[ks], a_addr<LD>(dOs, warp * 16, ks * 16, lane));
        }
      }
    }

    // s = q . K^T and dp = dO . V^T: 16 x 64 per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t a[4], o[4];
      if constexpr (REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = qf[ks][i];
          o[i] = of[ks][i];
        }
      } else {
        ldsm_x4(a, a_addr<LD>(Qs, warp * 16, ks * 16, lane));
        ldsm_x4(o, a_addr<LD>(dOs, warp * 16, ks * 16, lane));
      }
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, b_addr<LD>(Kt, kp * 16, ks * 16, lane));
        ldsm_x4(bv, b_addr<LD>(Vt, kp * 16, ks * 16, lane));
        mma(s[2 * kp], a, bk[0], bk[1]);
        mma(s[2 * kp + 1], a, bk[2], bk[3]);
        mma(dp[2 * kp], o, bv[0], bv[1]);
        mma(dp[2 * kp + 1], o, bv[2], bv[3]);
      }
    }

    // p and ds in registers; a tile whose every key is real and visible to
    // every query of the CTA's tile needs no mask
    const bool unmasked = n0 + BN <= Tk && (!causal || k_pos0 + n0 + BN - 1 <= q_pos0 + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kp = n0 + 8 * j + 2 * t4 + (e & 1);
        float sv;
        if (unmasked) sv = s[j][e] * scale;
        else if (kp >= Tk) sv = -INFINITY;
        else if (causal && k_pos0 + kp > q_pos0 + q0 + r0 + 8 * i) sv = NEG;
        else sv = s[j][e] * scale;
        const float p = expf(sv - lse_r[i]);
        s[j][e] = p * (dp[j][e] - dlt_r[i]) * scale;  // ds
      }
    }
    uint32_t da[4][4];
    to_a_fragments(da, s);

    // dq += ds' . K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int d2 = 0; d2 < NK; ++d2) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, a_addr<LD>(Kt, kk * 16, d2 * 16, lane));
        mma(acc[2 * d2], da[kk], bk[0], bk[1]);
        mma(acc[2 * d2 + 1], da[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = q0 + r0 + 8 * (e >> 1);
      const int c = 8 * j + 2 * t4 + (e & 1);
      if (t < Tq && c < D)
        store(dq, (((long long)b * Tq + t) * H + h) * D + c, acc[j][e], dq_bf16);
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     void* __restrict__ dk, void* __restrict__ dv, int H, int Tq, int Tk, int D,
                     Strides st, float scale, int causal, int dk_bf16, int dv_bf16, int vec,
                     int q_pos0, int k_pos0) {
  constexpr int LD = DK + 8;
  constexpr int TILE = 64 * LD;
  constexpr int NK = DK / 16;
  constexpr bool REGS = DK <= 64;  // K and V fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + TILE;                           // [64][LD]
  bf16* Qs = Vs + TILE;                           // [2][64][LD]
  bf16* dOs = Qs + 2 * TILE;                      // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][64]
  float* dlt_s = lse_s + 2 * BM;                             // [2][64]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = blockIdx.y * BN;
  const bf16* qb = q + b * st.qsb + h * st.qsh;
  const bf16* ob = dO + b * st.osb + h * st.osh;

  // query tile m0 into stage s: q and dO by copies, lse and delta by loads
  auto load_queries = [&](int m0, int s) {
    load_tile<DK>(Qs + s * TILE, qb, st.qst, m0, Tq, D, vec);
    load_tile<DK>(dOs + s * TILE, ob, st.ost, m0, Tq, D, vec);
    const int i = threadIdx.x & (BM - 1);
    const int t = m0 + i;
    if (threadIdx.x < BM)
      lse_s[s * BM + i] = t < Tq ? lse[(long long)bh * Tq + t] : INFINITY;
    else
      dlt_s[s * BM + i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
  };

  load_tile<DK>(Ks, k + b * st.ksb + h * st.ksh, st.kst, n0, Tk, D, vec);
  load_tile<DK>(Vs, v + b * st.vsb + h * st.vsh, st.vst, n0, Tk, D, vec);
  // the first query tile that holds a query at or after key n0 (at or past
  // Tq: a dead block)
  const int first = k_pos0 + n0 - q_pos0;
  const int m_start = causal && first > 0 ? (first / BM) * BM : 0;
  if (m_start < Tq) load_queries(m_start, 0);
  cp_async_commit();

  // this thread's key rows in the tile: r0 (elements 0, 1) and r0 + 8 (2, 3)
  const int r0 = warp * 16 + g;
  float dka[2 * NK][4], dva[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
  uint32_t kf[REGS ? NK : 1][4], vf[REGS ? NK : 1][4];

  for (int it = 0, m0 = m_start; m0 < Tq; ++it, m0 += BM) {
    const int cur = it & 1;
    if (m0 + BM < Tq) load_queries(m0 + BM, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + cur * TILE;
    const bf16* Ot = dOs + cur * TILE;
    const float* ls = lse_s + cur * BM;
    const float* dl = dlt_s + cur * BM;
    if constexpr (REGS) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < NK; ++ks) {
          ldsm_x4(kf[ks], a_addr<LD>(Ks, warp * 16, ks * 16, lane));
          ldsm_x4(vf[ks], a_addr<LD>(Vs, warp * 16, ks * 16, lane));
        }
      }
    }

    // sT = K . Q^T and dpT = V . dO^T: 16 keys x 64 queries per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t a[4], o[4];
      if constexpr (REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = kf[ks][i];
          o[i] = vf[ks][i];
        }
      } else {
        ldsm_x4(a, a_addr<LD>(Ks, warp * 16, ks * 16, lane));
        ldsm_x4(o, a_addr<LD>(Vs, warp * 16, ks * 16, lane));
      }
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, b_addr<LD>(Qt, kp * 16, ks * 16, lane));
        ldsm_x4(bo, b_addr<LD>(Ot, kp * 16, ks * 16, lane));
        mma(s[2 * kp], a, bq[0], bq[1]);
        mma(s[2 * kp + 1], a, bq[2], bq[3]);
        mma(dp[2 * kp], o, bo[0], bo[1]);
        mma(dp[2 * kp + 1], o, bo[2], bo[3]);
      }
    }

    // pT and dsT in registers (rows: keys, columns: queries)
    const bool unmasked = n0 + BN <= Tk && (!causal || k_pos0 + n0 + BN - 1 <= q_pos0 + m0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = n0 + r0 + 8 * (e >> 1);
        const int c = 8 * j + 2 * t4 + (e & 1);
        float sv;
        if (unmasked) sv = s[j][e] * scale;
        else if (kp >= Tk) sv = -INFINITY;
        else if (causal && k_pos0 + kp > q_pos0 + m0 + c) sv = NEG;
        else sv = s[j][e] * scale;
        const float p = expf(sv - ls[c]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl[c]) * scale;  // ds
      }
    }
    uint32_t pa[4][4], da[4][4];
    to_a_fragments(pa, s);
    to_a_fragments(da, dp);

    // dv += pT' . dO and dk += dsT' . Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int d2 = 0; d2 < NK; ++d2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, a_addr<LD>(Ot, kk * 16, d2 * 16, lane));
        ldsm_x4_trans(bq, a_addr<LD>(Qt, kk * 16, d2 * 16, lane));
        mma(dva[2 * d2], pa[kk], bo[0], bo[1]);
        mma(dva[2 * d2 + 1], pa[kk], bo[2], bo[3]);
        mma(dka[2 * d2], da[kk], bq[0], bq[1]);
        mma(dka[2 * d2 + 1], da[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = n0 + r0 + 8 * (e >> 1);
      const int c = 8 * j + 2 * t4 + (e & 1);
      if (t < Tk && c < D) {
        const long long i = (((long long)b * Tk + t) * H + h) * D + c;
        store(dk, i, dka[j][e], dk_bf16);
        store(dv, i, dva[j][e], dv_bf16);
      }
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
  int causal, bf16_0, bf16_1, vec;
  int q_pos0, k_pos0;
  cudaStream_t stream;
};

constexpr size_t tile_bytes(int dk) { return sizeof(bf16) * 64 * (size_t)(dk + 8); }

template <int DK>
int launch_dq(const Args& a) {
  const size_t smem = 6 * tile_bytes(DK);
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dq_tc_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Tq + BM - 1) / BM));
  fa_bwd_dq_tc_kernel<DK><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse, a.delta, a.g0,
      a.H, a.Tq, a.Tk, a.D, a.st, a.scale, a.causal, a.bf16_0, a.vec, a.q_pos0, a.k_pos0);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_dkv(const Args& a) {
  const size_t smem = 6 * tile_bytes(DK) + sizeof(float) * 4 * BM;
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dkv_tc_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Tk + BN - 1) / BN));
  fa_bwd_dkv_tc_kernel<DK><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse, a.delta, a.g0,
      a.g1, a.H, a.Tq, a.Tk, a.D, a.st, a.scale, a.causal, a.bf16_0, a.bf16_1, a.vec,
      a.q_pos0, a.k_pos0);
  return (int)cudaGetLastError();
}

// Dk = D rounded up to 16
template <bool DQ>
int launch_checked(const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.D <= 0 || a.D > 128 ||
      (long long)a.B * a.H > 0x7fffffffLL || (a.Tq + BM - 1) / BM > 65535 ||
      (a.Tk + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  switch ((a.D + 15) / 16) {
    case 1: return DQ ? launch_dq<16>(a) : launch_dkv<16>(a);
    case 2: return DQ ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 3: return DQ ? launch_dq<48>(a) : launch_dkv<48>(a);
    case 4: return DQ ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 5: return DQ ? launch_dq<80>(a) : launch_dkv<80>(a);
    case 6: return DQ ? launch_dq<96>(a) : launch_dkv<96>(a);
    case 7: return DQ ? launch_dq<112>(a) : launch_dkv<112>(a);
    default: return DQ ? launch_dq<128>(a) : launch_dkv<128>(a);
  }
}

}  // namespace

// q, k, v, dO: bf16 [B, T, H, D] with unit stride over D and the given
// (batch, time, head) strides in elements; lse, delta: contiguous
// [B*H, Tq] f32.  dq: contiguous [B, Tq, H, D], bf16 when dq_bf16 else f32.
// vec: 1 when every pointer is 16-byte aligned and D and every stride are
// multiples of 8 (16-byte copies), else 0.  q_pos0 / k_pos0: global
// positions of query 0 and key 0 for the causal mask (0 and 0 on one
// card).  Returns a cudaError_t code (0 on success).
extern "C" int flash_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                         const void* dO, const float* lse,
                                         const float* delta, void* dq, int B, int H, int Tq,
                                         int Tk, int D, long long qsb, long long qst,
                                         long long qsh, long long ksb, long long kst,
                                         long long ksh, long long vsb, long long vst,
                                         long long vsh, long long osb, long long ost,
                                         long long osh, float scale, int causal, int dq_bf16,
                                         int vec, int q_pos0, int k_pos0, void* stream) {
  const Args a{q, k, v, dO, lse, delta, dq, nullptr, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               scale, causal, dq_bf16, 0, vec, q_pos0, k_pos0,
               static_cast<cudaStream_t>(stream)};
  return launch_checked<true>(a);
}

// As above; dk, dv: contiguous [B, Tk, H, D], each bf16 when its flag is
// set, else f32.
extern "C" int flash_attention_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                          const void* dO, const float* lse,
                                          const float* delta, void* dk, void* dv, int B, int H,
                                          int Tq, int Tk, int D, long long qsb, long long qst,
                                          long long qsh, long long ksb, long long kst,
                                          long long ksh, long long vsb, long long vst,
                                          long long vsh, long long osb, long long ost,
                                          long long osh, float scale, int causal, int dk_bf16,
                                          int dv_bf16, int vec, int q_pos0, int k_pos0,
                                          void* stream) {
  const Args a{q, k, v, dO, lse, delta, dk, dv, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               scale, causal, dk_bf16, dv_bf16, vec, q_pos0, k_pos0,
               static_cast<cudaStream_t>(stream)};
  return launch_checked<false>(a);
}
