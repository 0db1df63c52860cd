// Flash-attention forward on Hopper's tensor cores: tiled stable-softmax
// attention, causal or full, with an optional per-row logsumexp, for bf16
// q/k/v under precision="default".
//
// Replaces, on that path, the TPU kernel of
// cekirdekler_tpu/ops/flash_attention.py::_flash_forward (:351; the call at
// :388, body _fa_kernel :99-215 with parts=False).  The FP32 kernel
// fa_fwd_kernel of csrc/flash_attention.cu keeps every other case (f32
// operands, "highest"), and fa_fwd_parts_kernel there keeps the ring's
// parts.  As there, one CTA owns one (b*h, 64-query tile) and walks the
// key tiles in a loop: the running max and denominator and the output
// accumulator live in registers, so nothing carries between CTAs.
//
// What it computes, per query row over the key tiles the row can see, as
// _fa_kernel does at "default":
//   s  = (q . k) * scale                  f32 sums of exact bf16 products
//   s  = NEG (-1e30) where causal and key > query; -inf for keys past Tk
//   m' = max(m, rowmax s);  p = exp(s - m');  alpha = exp(m - m')
//   l  = l * alpha + rowsum p             over the unrounded f32 p
//   acc = acc * alpha + p' . v            p' = bf16(p), only for this product
//   out = acc / max(l, 1e-30);  lse = m + log(max(l, 1e-30))
// out is bf16, or f32 for f32 inputs that the caller cast to bf16; lse is
// a [B*H, Tq] f32 column when asked for.  Causal needs Tq == Tk; since the
// tiles are square and aligned, every row of every visited tile sees a
// live key.  Query rows past Tq are computed on zeros and never stored.
// Order of the rescale: acc is scaled by alpha first and the tensor cores
// then accumulate p' . v into it (FlashAttention-2's order), where the
// reference sums the tile's product on its own and adds it; that saves
// 16 x Dk f32 registers a warp and changes only the order of f32 sums
// (tests/test_torch_flash_fwd_route.py bounds that on the CPU).  l takes
// each tile's row sum whole (a quad shuffle), as the reference does.
//
// Bound on this card: operations.  q.k and p.v are 4*D operations per
// live (query, key) pair and head; at the model's shapes (B=4, T=2048,
// H=8, D=64, causal) that is 17.2 GFLOP, 0.0174 ms at the bf16
// tensor-core peak (989 TFLOP/s), where the 34 MB of q/k/v/o take 0.010 ms.
//
// What the design does about the FP32 kernel's limits (PR 6's backward
// design, csrc/flash_attention_bwd_tc.cu):
//   1. no tensor cores: both products are mma.sync.m16n8k16 bf16 x bf16 ->
//      f32 from inline PTX, operands read from shared memory by ldmatrix
//      (.trans for V, whose rows are the contraction of p' . v);
//   2. scores staged in shared memory and three barriers a tile: a CTA is
//      4 warps and warp w owns query rows 16 w .. 16 w + 15, so s is a
//      16x64 f32 accumulator tile per warp and the whole online softmax
//      runs in registers, the row max and sum across the quad of lanes
//      that share a row (__shfl_xor_sync 1 and 2).  The m16n8 accumulator
//      layout of two adjacent n8 tiles is the A layout of one k16 step, so
//      p' goes from the accumulators into the A fragments of p' . v
//      without touching shared memory.  Tiles are bf16 [64][Dk + 8], Dk =
//      D rounded up to 16 (the 16-byte pad puts the 8 rows of an ldmatrix
//      on distinct bank groups); columns past D and rows past T are zeros,
//      which add exact zeros and are never stored.  For Dk <= 64 a warp
//      keeps its q fragments in registers for the whole loop; above that
//      it reads them again from shared memory;
//   3. synchronous loads: K and V tiles are copied by cp.async.cg, 16
//      bytes a copy, in a two-stage ring, so the next tile is in flight
//      while the current one is multiplied.  Where D % 8 != 0, or a
//      pointer or a (batch, time, head) stride is not a multiple of 16
//      bytes, the wrapper passes vec = 0 and the same layout is filled by
//      element loads.
// Masks are applied only on the diagonal tile and the ragged last one.
// Under causal the query tiles are taken last-first, so the CTAs that walk
// the most key tiles start first.  wgmma, TMA, warp specialisation and
// persistent CTAs are not used.  The build passes -fmad=false and expf /
// logf are the IEEE ones; the only multiply-adds are the tensor cores'.

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
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
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
fa_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, void* __restrict__ out, float* __restrict__ lse,
                 int H, int Tq, int Tk, int D, Strides st, float scale, int causal,
                 int out_bf16, int vec) {
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
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const bf16* kb = k + b * st.ksb + h * st.ksh;
  const bf16* vb = v + b * st.vsb + h * st.vsh;

  const int q_last = min(q0 + BM, Tq) - 1;
  // one past the last key the tile's last query can see
  const int n_end = causal ? min(Tk, q_last + 1) : Tk;
  load_tile<DK>(Qs, q + b * st.qsb + h * st.qsh, st.qst, q0, Tq, D, vec);
  load_tile<DK>(Ks, kb, st.kst, 0, Tk, D, vec);
  load_tile<DK>(Vs, vb, st.vst, 0, Tk, D, vec);
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
    const bool unmasked = n0 + BN <= Tk && (!causal || n0 + BN - 1 <= q0);
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
        else if (causal && kp > q0 + r0 + 8 * i) sv = NEG;
        else sv = s[j][e] * scale;
        s[j][e] = sv;
        mx[i] = fmaxf(mx[i], sv);
      }
    }

    // online softmax: the quad of lanes 4g .. 4g + 3 holds rows r0, r0 + 8
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf(s[j][e] - m_r[i]);
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
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * alpha[e >> 1];
    uint32_t pa[4][4];
    to_a_fragments(pa, s);

    // acc += p' . V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int d2 = 0; d2 < NK; ++d2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, a_addr<LD>(Vt, kk * 16, d2 * 16, lane));
        mma(acc[2 * d2], pa[kk], bv[0], bv[1]);
        mma(acc[2 * d2 + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  // one lane of each quad writes its rows' lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] = fmaxf(l_r[i], 1e-30f);
    const int t = q0 + r0 + 8 * i;
    if (lse != nullptr && t4 == 0 && t < Tq) lse[(long long)bh * Tq + t] = m_r[i] + logf(l_r[i]);
  }
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = q0 + r0 + 8 * (e >> 1);
      const int c = 8 * j + 2 * t4 + (e & 1);
      if (t < Tq && c < D) {
        const float o = acc[j][e] / l_r[e >> 1];
        const long long i = (((long long)b * Tq + t) * H + h) * D + c;
        if (out_bf16)
          reinterpret_cast<bf16*>(out)[i] = __float2bfloat16_rn(o);
        else
          reinterpret_cast<float*>(out)[i] = o;
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int B, H, Tq, Tk, D;
  Strides st;
  float scale;
  int causal, out_bf16, vec;
  cudaStream_t stream;
};

template <int DK>
int launch(const Args& a) {
  const size_t smem = 5 * sizeof(bf16) * 64 * (size_t)(DK + 8);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_tc_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Tq + BM - 1) / BM));
  fa_fwd_tc_kernel<DK><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.out, a.lse, a.H, a.Tq, a.Tk, a.D, a.st, a.scale,
      a.causal, a.out_bf16, a.vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 [B, T, H, D] with unit stride over D and the given (batch,
// time, head) strides in elements; out: contiguous [B, Tq, H, D], bf16 when
// out_bf16 else f32; lse: NULL or contiguous [B*H, Tq] f32.  vec: 1 when
// every pointer is 16-byte aligned and D and every stride are multiples of
// 8 (16-byte copies), else 0.  Causal needs Tq == Tk.  Dk = D rounded up
// to 16.  Returns a cudaError_t code (0 on success).
extern "C" int flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* out,
                                      float* lse, int B, int H, int Tq, int Tk, int D,
                                      long long qsb, long long qst, long long qsh,
                                      long long ksb, long long kst, long long ksh,
                                      long long vsb, long long vst, long long vsh, float scale,
                                      int causal, int out_bf16, int vec, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      (long long)B * H > 0x7fffffffLL || (Tq + BM - 1) / BM > 65535 || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, B, H, Tq, Tk, D,
               {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh},
               scale, causal, out_bf16, vec, static_cast<cudaStream_t>(stream)};
  switch ((D + 15) / 16) {
    case 1: return launch<16>(a);
    case 2: return launch<32>(a);
    case 3: return launch<48>(a);
    case 4: return launch<64>(a);
    case 5: return launch<80>(a);
    case 6: return launch<96>(a);
    case 7: return launch<112>(a);
    default: return launch<128>(a);
  }
}
