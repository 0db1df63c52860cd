// The ring-attention parts kernels on Hopper's tensor cores at f32 accuracy:
// the forward parts (the unnormalized softmax state of q against one K/V
// block) and both halves of the backward parts, dq and dk/dv, for bf16
// q/k/v/dO under precision="highest", the ring's own precision.
//
// Replaces, on that path, three TPU kernels of
// cekirdekler_tpu/ops/flash_attention.py: flash_attention_parts (:420, the
// call at :463, body _fa_kernel :99-215 with parts=True), kernel
// fa_fwd_parts_tc_kernel, entry point flash_attention_fwd_parts_tc; and
// the two calls of flash_attention_bwd_parts (:745): dq (the call at :798,
// body _fa_bwd_dq_kernel :491), kernel fa_bwd_dq_parts_tc_kernel, entry
// point flash_attention_bwd_dq_parts_tc, and dk/dv (the call at :817, body
// _fa_bwd_dkv_kernel), kernel fa_bwd_dkv_parts_tc_kernel, entry point
// flash_attention_bwd_dkv_parts_tc.  The FP32 kernels of
// csrc/flash_attention.cu (fa_fwd_parts_kernel) and csrc/flash_attention_bwd.cu
// (fa_bwd_dq_kernel, fa_bwd_dkv_kernel) keep f32 operands and the forward
// parts at "default".  As there, one CTA owns one output tile
// and walks the other axis in a loop, so nothing carries between CTAs,
// there are no atomics, and the bits are the same from run to run.
//
// What they compute, as the FP32 kernels do at "highest":
//   forward, per query row over the key tiles it can see:
//     s  = (q . k) * scale; NEG (-1e30) where causal and key > query,
//          -inf for keys past Tk
//     m' = max(m, rowmax s); p = exp(s - m') (0 while m' is still NEG);
//     alpha = exp(m - m');  l = l * alpha + rowsum p
//     acc = acc * alpha + p . v
//   stored unnormalized: acc [B, Tq, H, D], m and l [B, Tq, H], all f32;
//   dq, per query row over the key tiles it can see (masked as above):
//     p = exp(s - lse); dp = dO . v^T; ds = p * (dp - delta) * scale
//     dq += ds . K                                  f32 [B, Tq, H, D]
//   dk/dv, per key row over the query tiles that can see it:
//     sT = K . Q^T * scale (masked as above); pT = exp(sT - lse)
//     dpT = V . dO^T; dsT = pT * (dpT - delta) * scale
//     dv += pT . dO;  dk += dsT . Q                 f32 [B, Tk, H, D]
// Key j is visible to query i where k_pos0 + j <= q_pos0 + i.  A dead block
// (k_pos0 > q_pos0 + Tq - 1) runs no tile: the forward writes the empty
// state m = NEG, l = 0, acc = 0 and the backward kernels zero gradients.
// A row that sees no key of a live tile keeps the empty state as well (in
// the backward its p is exp(NEG - lse) = 0, so it adds zeros).
//
// f32 accuracy from bf16 tensor cores: q.k and dO.v have bf16 operands on
// both sides, so every elementwise product is exact in f32 and they run
// as one mma.sync.m16n8k16 bf16 -> f32 each, as in csrc/flash_attention_tc.cu.
// The other operand of p.v, ds.K, pT.dO and dsT.Q is f32.  It is split into three
// bf16 terms, x = hi + mid + lo (hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid), each subtraction exact in f32), which carry all
// 24 bits of its significand for every |x| above about 2^-100; each term's
// product with a bf16 value is exact in f32, so the product costs three
// mma.sync and loses nothing but the order of the f32 sums.  (Two terms
// would leave 2^-17 relative.)  The terms are made in place from the
// accumulator registers (t = bf16(x); x -= t), so no f32 copy stays live.
//
// The order of the f32 sums.  The tensor cores' f32 sums may truncate
// rather than round (measured on A100 by Fasi, Higham, Mikaitis and
// Pranesh, "Numerical behavior of NVIDIA tensor cores", PeerJ CS 2021), and
// a running accumulator that takes every tile's mma (FlashAttention-2's
// order) then carries a one-signed error of up to 12 such truncations a
// tile.  So each 16-column block of a tile's product is summed on its own,
// the lo terms first, then mid, then hi, and the CUDA cores add it to the
// running sum (acc = acc * alpha + t, rounded to nearest: the build passes
// -fmad=false), as the FP32 kernels and the reference add each tile's
// product.  That costs 8 f32 registers a thread.  Measured at one full
// 1x2048x8x64 ring step on an H100 80GB HBM3 (700 W), FlashAttention-2's
// order used 59-67% of the 1e-5 gate on acc, dk and dv, this one 4.5-5.4%.
//
// Bound on this card: operations.  Per live (query, key) pair and head the
// forward issues (1 + 3) x 2D tensor-core operations, dq (1 + 1 + 3) x 2D
// and the dk/dv kernel (1 + 1 + 3 + 3) x 2D; at one full ring step of the
// 1x16384x8x64 causal ring (2048 queries against 2048 keys, H=8, D=64)
// that is 17.2, 21.5 and 34.4 GFLOP, 0.0174, 0.0217 and 0.0347 ms at the
// bf16 tensor-core peak (989 TFLOP/s), where the FP32 kernels' bound was
// 0.128, 0.192 and 0.256 ms.
//
// The design is that of the single-card tensor-core forward and dk/dv
// (csrc/flash_attention_tc.cu, csrc/flash_attention_bwd_tc.cu): a CTA of 4
// warps, warp w owning 16 rows;
// s (with dp, or sT and dpT) as 16x64 f32 accumulator tiles in registers,
// the forward's online softmax across each row's quad of lanes; operands
// read from shared memory by ldmatrix (.trans where the contraction runs
// over a tile's rows); bf16 tiles [64][Dk + 8] with Dk = D rounded up to
// 16, zeros past D and T; the resident tile's fragments (q, q and dO, or
// K and V) held in registers for Dk <= 64; the streamed tiles copied by
// cp.async.cg, 16 bytes a copy, in a two-stage ring (element loads where
// vec = 0).  Each 16-column block of the split product loads its four B
// fragments once and issues its twelve mma from them.  The forward and dq
// own a query tile and stream K and V (dq's is the forward's loop with ds
// in p's place, formed in place in dp's registers, and no rescale); under
// causal they take their query tiles in order of live key tiles, most
// first (the count grows with the tile index whatever the offsets), so the
// longest CTAs start first; the dk/dv kernel's first key tiles, its
// longest, lead already.  wgmma, TMA, warp specialisation and persistent
// CTAs are not used.

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

// Two f32 -> their bf16 terms (to nearest even), lo in the low half, each
// left holding its remainder x - bf16(x), which is exact in f32.
__device__ __forceinline__ uint32_t take_term(float& lo, float& hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  lo = lo - __low2float(t);
  hi = hi - __high2float(t);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// The three bf16 terms of a 16x64 f32 accumulator tile as the A fragments of
// its four k16 steps: f[0] = bf16(x), f[1] = bf16(x - f[0]),
// f[2] = bf16(x - f[0] - f[1]); step kk takes n8 tiles 2 kk and 2 kk + 1.
// x is consumed.
__device__ __forceinline__ void split3(uint32_t (&f)[3][4][4], float (&x)[8][4]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      f[t][kk][0] = take_term(x[2 * kk][0], x[2 * kk][1]);
      f[t][kk][1] = take_term(x[2 * kk][2], x[2 * kk][3]);
      f[t][kk][2] = take_term(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      f[t][kk][3] = take_term(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    }
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

// out[16 x DK] = out * alpha (per row: elements 0, 1 and 2, 3) + x . B, with
// x given by its three bf16 terms f over the 64 rows of the [64][LD] tile B
// (the contraction).  Per 16-column block the four B fragments are loaded
// once and the terms go lo, mid, hi; the block's product is summed on its
// own and added by the CUDA cores.
template <int LD, int NK>
__device__ __forceinline__ void add_split_product(float (&out)[2 * NK][4],
                                                  const uint32_t (&f)[3][4][4], const bf16* tile,
                                                  int lane, float a0, float a1) {
#pragma unroll
  for (int d2 = 0; d2 < NK; ++d2) {
    uint32_t b[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4_trans(b[kk], a_addr<LD>(tile, kk * 16, d2 * 16, lane));
    float t[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.0f;
#pragma unroll
    for (int term = 2; term >= 0; --term) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma(t[0], f[term][kk], b[kk][0], b[kk][1]);
        mma(t[1], f[term][kk], b[kk][2], b[kk][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[2 * d2 + j][e] = out[2 * d2 + j][e] * (e < 2 ? a0 : a1) + t[j][e];
  }
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
fa_fwd_parts_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, float* __restrict__ acc_out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int H, int Tq,
                       int Tk, int D, Strides st, float scale, int causal, int vec, int q_pos0,
                       int k_pos0) {
  constexpr int LD = DK + 8;
  constexpr int TILE = 64 * LD;
  constexpr int NK = DK / 16;       // k16 steps over the head dim
  constexpr bool REGS = DK <= 64;   // q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Ks = Qs + TILE;                           // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE;                       // [2][64][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // under causal a later query tile sees at least as many key tiles
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const bf16* kb = k + b * st.ksb + h * st.ksh;
  const bf16* vb = v + b * st.vsb + h * st.vsh;

  const int q_last = min(q0 + BM, Tq) - 1;
  // one past the last key the tile's last query can see (0: a dead block)
  const int n_end = causal ? max(0, min(Tk, q_pos0 + q_last - k_pos0 + 1)) : Tk;
  load_tile<DK>(Qs, q + b * st.qsb + h * st.qsh, st.qst, q0, Tq, D, vec);
  if (n_end > 0) {
    load_tile<DK>(Ks, kb, st.kst, 0, Tk, D, vec);
    load_tile<DK>(Vs, vb, st.vst, 0, Tk, D, vec);
  }
  cp_async_commit();

  // this thread's query rows in the tile: r0 (accumulator elements 0, 1)
  // and r0 + 8 (elements 2, 3)
  const int r0 = warp * 16 + g;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.0f, 0.0f};
  float acc[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  uint32_t qf[REGS ? NK : 1][4];

  for (int it = 0, n0 = 0; n0 < n_end; ++it, n0 += BN) {
    const int cur = it & 1;
    if (n0 + BN < n_end) {
      load_tile<DK>(Ks + (cur ^ 1) * TILE, kb, st.kst, n0 + BN, Tk, D, vec);
      load_tile<DK>(Vs + (cur ^ 1) * TILE, vb, st.vst, n0 + BN, Tk, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and q's) have landed
    __syncthreads();
    const bf16* Kt = Ks + cur * TILE;
    const bf16* Vt = Vs + cur * TILE;
    if constexpr (REGS) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < NK; ++ks) ldsm_x4(qf[ks], a_addr<LD>(Qs, warp * 16, ks * 16, lane));
      }
    }

    // s = q . K^T: 16 x 64 per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t a[4];
      if constexpr (REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
      } else {
        ldsm_x4(a, a_addr<LD>(Qs, warp * 16, ks * 16, lane));
      }
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t bk[4];
        ldsm_x4(bk, b_addr<LD>(Kt, kp * 16, ks * 16, lane));
        mma(s[2 * kp], a, bk[0], bk[1]);
        mma(s[2 * kp + 1], a, bk[2], bk[3]);
      }
    }

    // scale and mask; a tile whose every key is real and visible to every
    // query of the CTA's tile needs no mask
    const bool unmasked = n0 + BN <= Tk && (!causal || k_pos0 + n0 + BN - 1 <= q_pos0 + q0);
    float mx[2] = {-INFINITY, -INFINITY};
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
        s[j][e] = sv;
        mx[i] = fmaxf(mx[i], sv);
      }
    }

    // online softmax: the quad of lanes 4g .. 4g + 3 holds rows r0, r0 + 8;
    // a row whose max is still NEG has seen no key and keeps p = 0
    float alpha[2], sum[2] = {0.0f, 0.0f};
    bool empty[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      empty[i] = m_new == NEG;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = empty[i] ? 0.0f : expf(s[j][e] - m_r[i]);
        s[j][e] = p;
        sum[i] = sum[i] + p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = sum[i] + __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] = sum[i] + __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_r[i] = l_r[i] * alpha[i] + sum[i];
    }

    // acc = acc * alpha + p . V, p as three bf16 terms
    uint32_t f[3][4][4];
    split3(f, s);
    add_split_product<LD, NK>(acc, f, Vt, lane, alpha[0], alpha[1]);
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    if (t4 == 0 && t < Tq) {
      const long long row = ((long long)b * Tq + t) * H + h;
      m_out[row] = m_r[i];
      l_out[row] = l_r[i];
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = q0 + r0 + 8 * (e >> 1);
      const int c = 8 * j + 2 * t4 + (e & 1);
      if (t < Tq && c < D) acc_out[(((long long)b * Tq + t) * H + h) * D + c] = acc[j][e];
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_parts_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dO,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk,
                           int D, Strides st, float scale, int causal, int vec, int q_pos0,
                           int k_pos0) {
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

    // dv += pT . dO and dk += dsT . Q, pT and dsT as three bf16 terms each
    uint32_t f[3][4][4];
    split3(f, s);
    add_split_product<LD, NK>(dva, f, Ot, lane, 1.0f, 1.0f);
    split3(f, dp);
    add_split_product<LD, NK>(dka, f, Qt, lane, 1.0f, 1.0f);
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
        dk[i] = dka[j][e];
        dv[i] = dva[j][e];
      }
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_parts_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int H, int Tq, int Tk, int D, Strides st,
                          float scale, int causal, int vec, int q_pos0, int k_pos0) {
  constexpr int LD = DK + 8;
  constexpr int TILE = 64 * LD;
  constexpr int NK = DK / 16;
  constexpr bool REGS = DK <= 64;  // q and dO fragments held in registers
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
  // under causal a later query tile sees at least as many key tiles
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const bf16* kb = k + b * st.ksb + h * st.ksh;
  const bf16* vb = v + b * st.vsb + h * st.vsh;

  const int q_last = min(q0 + BM, Tq) - 1;
  // one past the last key the tile's last query can see (0: a dead block)
  const int n_end = causal ? max(0, min(Tk, q_pos0 + q_last - k_pos0 + 1)) : Tk;
  if (n_end > 0) {
    load_tile<DK>(Qs, q + b * st.qsb + h * st.qsh, st.qst, q0, Tq, D, vec);
    load_tile<DK>(dOs, dO + b * st.osb + h * st.osh, st.ost, q0, Tq, D, vec);
    load_tile<DK>(Ks, kb, st.kst, 0, Tk, D, vec);
    load_tile<DK>(Vs, vb, st.vst, 0, Tk, D, vec);
  }
  cp_async_commit();

  // this thread's query rows in the tile: r0 (accumulator elements 0, 1)
  // and r0 + 8 (elements 2, 3), with their lse and delta; rows past Tq
  // have zero q and dO, and lse = inf gives them p = 0
  const int r0 = warp * 16 + g;
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    lse_r[i] = t < Tq ? lse[(long long)bh * Tq + t] : INFINITY;
    dlt_r[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
  }
  float dqa[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.0f;
  uint32_t qf[REGS ? NK : 1][4], of[REGS ? NK : 1][4];

  for (int it = 0, n0 = 0; n0 < n_end; ++it, n0 += BN) {
    const int cur = it & 1;
    if (n0 + BN < n_end) {
      load_tile<DK>(Ks + (cur ^ 1) * TILE, kb, st.kst, n0 + BN, Tk, D, vec);
      load_tile<DK>(Vs + (cur ^ 1) * TILE, vb, st.vst, n0 + BN, Tk, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and q's and dO's) have landed
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

    // s = q . K^T and dp = dO . V^T: 16 queries x 64 keys per warp
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

    // p, then ds in place of dp (rows: queries, columns: keys); a tile whose
    // every key is real and visible to every query of the CTA's tile needs
    // no mask
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
        dp[j][e] = p * (dp[j][e] - dlt_r[i]) * scale;  // ds
      }
    }

    // dq += ds . K, ds as three bf16 terms
    uint32_t f[3][4][4];
    split3(f, dp);
    add_split_product<LD, NK>(dqa, f, Kt, lane, 1.0f, 1.0f);
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  // every element of the tile, zeros for a dead block
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = q0 + r0 + 8 * (e >> 1);
      const int c = 8 * j + 2 * t4 + (e & 1);
      if (t < Tq && c < D) dq[(((long long)b * Tq + t) * H + h) * D + c] = dqa[j][e];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  float *o0, *o1, *o2;  // acc, m, l; dq; or dk, dv
  int B, H, Tq, Tk, D;
  Strides st;
  float scale;
  int causal, vec, q_pos0, k_pos0;
  cudaStream_t stream;
};

constexpr size_t tile_bytes(int dk) { return sizeof(bf16) * 64 * (size_t)(dk + 8); }

template <int DK>
int launch_fwd(const Args& a) {
  const size_t smem = 5 * tile_bytes(DK);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_parts_tc_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Tq + BM - 1) / BM));
  fa_fwd_parts_tc_kernel<DK><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.o0, a.o1, a.o2, a.H, a.Tq, a.Tk, a.D, a.st, a.scale,
      a.causal, a.vec, a.q_pos0, a.k_pos0);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_dkv(const Args& a) {
  const size_t smem = 6 * tile_bytes(DK) + sizeof(float) * 4 * BM;
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dkv_parts_tc_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Tk + BN - 1) / BN));
  fa_bwd_dkv_parts_tc_kernel<DK><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse, a.delta, a.o0,
      a.o1, a.H, a.Tq, a.Tk, a.D, a.st, a.scale, a.causal, a.vec, a.q_pos0, a.k_pos0);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_dq(const Args& a) {
  const size_t smem = 6 * tile_bytes(DK);
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dq_parts_tc_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Tq + BM - 1) / BM));
  fa_bwd_dq_parts_tc_kernel<DK><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse, a.delta, a.o0,
      a.H, a.Tq, a.Tk, a.D, a.st, a.scale, a.causal, a.vec, a.q_pos0, a.k_pos0);
  return (int)cudaGetLastError();
}

enum class Kind { fwd, dq, dkv };

template <int DK>
int launch(const Args& a, Kind kind) {
  switch (kind) {
    case Kind::fwd: return launch_fwd<DK>(a);
    case Kind::dq: return launch_dq<DK>(a);
    default: return launch_dkv<DK>(a);
  }
}

// Dk = D rounded up to 16
int launch_checked(const Args& a, Kind kind) {
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.D <= 0 || a.D > 128 ||
      (long long)a.B * a.H > 0x7fffffffLL || (a.Tq + BM - 1) / BM > 65535 ||
      (a.Tk + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  switch ((a.D + 15) / 16) {
    case 1: return launch<16>(a, kind);
    case 2: return launch<32>(a, kind);
    case 3: return launch<48>(a, kind);
    case 4: return launch<64>(a, kind);
    case 5: return launch<80>(a, kind);
    case 6: return launch<96>(a, kind);
    case 7: return launch<112>(a, kind);
    default: return launch<128>(a, kind);
  }
}

}  // namespace

// q, k, v: bf16 [B, T, H, D] with unit stride over D and the given (batch,
// time, head) strides in elements; acc: contiguous [B, Tq, H, D] f32; m, l:
// contiguous [B, Tq, H] f32.  vec: 1 when every pointer is 16-byte aligned
// and D and every stride are multiples of 8 (16-byte copies), else 0.
// q_pos0 / k_pos0: global positions of query 0 and key 0 for the causal
// mask.  Returns a cudaError_t code (0 on success).
extern "C" int flash_attention_fwd_parts_tc(const void* q, const void* k, const void* v,
                                            float* acc, float* m, float* l, int B, int H,
                                            int Tq, int Tk, int D, long long qsb, long long qst,
                                            long long qsh, long long ksb, long long kst,
                                            long long ksh, long long vsb, long long vst,
                                            long long vsh, float scale, int causal, int vec,
                                            int q_pos0, int k_pos0, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, acc, m, l, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, 0, 0, 0},
               scale, causal, vec, q_pos0, k_pos0, static_cast<cudaStream_t>(stream)};
  return launch_checked(a, Kind::fwd);
}

// As above, with dO: bf16 [B, Tq, H, D] strided like q; lse, delta:
// contiguous [B*H, Tq] f32; dk, dv: contiguous [B, Tk, H, D] f32.
extern "C" int flash_attention_bwd_dkv_parts_tc(const void* q, const void* k, const void* v,
                                                const void* dO, const float* lse,
                                                const float* delta, float* dk, float* dv, int B,
                                                int H, int Tq, int Tk, int D, long long qsb,
                                                long long qst, long long qsh, long long ksb,
                                                long long kst, long long ksh, long long vsb,
                                                long long vst, long long vsh, long long osb,
                                                long long ost, long long osh, float scale,
                                                int causal, int vec, int q_pos0, int k_pos0,
                                                void* stream) {
  const Args a{q, k, v, dO, lse, delta, dk, dv, nullptr, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               scale, causal, vec, q_pos0, k_pos0, static_cast<cudaStream_t>(stream)};
  return launch_checked(a, Kind::dkv);
}


// As flash_attention_bwd_dkv_parts_tc, with dq: contiguous [B, Tq, H, D] f32,
// every element written (zeros for a dead block).
extern "C" int flash_attention_bwd_dq_parts_tc(const void* q, const void* k, const void* v,
                                               const void* dO, const float* lse,
                                               const float* delta, float* dq, int B, int H,
                                               int Tq, int Tk, int D, long long qsb,
                                               long long qst, long long qsh, long long ksb,
                                               long long kst, long long ksh, long long vsb,
                                               long long vst, long long vsh, long long osb,
                                               long long ost, long long osh, float scale,
                                               int causal, int vec, int q_pos0, int k_pos0,
                                               void* stream) {
  const Args a{q, k, v, dO, lse, delta, dq, nullptr, nullptr, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh},
               scale, causal, vec, q_pos0, k_pos0, static_cast<cudaStream_t>(stream)};
  return launch_checked(a, Kind::dq);
}
