// Blockwise elementwise map on Hopper: out[i] = fn(in0[i], in1[i], ...).
//
// Replaces the TPU kernel cekirdekler_tpu/ops/elementwise.py::map_blocks
// (and saxpy, which is map_blocks of y + alpha*x).  There the inputs are cut
// into (rows, 128) VMEM blocks on a 1-D grid, and the traced fn runs on each
// block: one HBM read per input and one write of the output, however many
// ops fn fuses.  Here fn is traced on the host (ops/elementwise.py) into a
// small expression over the inputs, and that expression is spliced into
// this file as ck_fn / ck_vecs / ck_one where the marker below stands.  One
// build per distinct expression and dtypes, keyed by the content hash of the
// spliced source.
//
// Bound on this card: memory.  Each element reads every input once and
// writes the output once (saxpy in f32: 12 B per element, 2^24 elements in
// 0.0601 ms at 3.35 TB/s).  So the design has to keep enough bytes in
// flight:
// - 16-byte vector loads and stores (CK_VEC elements) where every pointer is
//   aligned for them, a scalar kernel otherwise;
// - each thread loads CK_U vectors of every input before it computes and
//   stores any (ck_vecs), through __restrict__ pointers (out may be exactly
//   one of the inputs: each element is read, then written, by one thread);
// - a grid of one step per thread, CK_THREADS a CTA, walked grid-stride, so
//   that a short array fills the card too.  On the card one vector a step
//   and 512 threads beat 2-4 vectors a step and a grid of the CTAs resident
//   on the card (tools/sweep_stream.py, NVIDIA H100).  The TPU kernel's
//   block (block_rows) does not shape this schedule, and the result does
//   not depend on either: every element is computed by the same ck_fn.
// bfloat16 and float16 convert with the card's instructions (cvt.rn.bf16.f32,
// cvt.rn.f16.f32, and their packed bf16x2 / f16x2 forms for the stored pairs),
// which is what PyTorch's CUDA kernels use, NaN included (0x7fff).
//
// Exactness: built with -fmad=false, so y + a*x rounds the product as the
// plain version does.  bfloat16 and float16 values compute each op in f32
// and round to the storage type after every op (ck_rbf16 / ck_rf16), as
// PyTorch's eager ops do.  The same file compiles with g++ for the host
// (the tests build it there), the grid's threads run one after another and
// the conversions in software.

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#define CK_D __device__ __forceinline__
#else
#define CK_D static inline
#endif

#define CK_THREADS 512
#define CK_MAX_IN 8
#define CK_U 1             // vectors of each input a thread loads before it computes
#define CK_HOST_THREADS 3  // the host build's grid

struct CkArgs {
  const void* in[CK_MAX_IN];
  void* out;
};

template <class S, int V>
struct alignas(sizeof(S) * V) CkVec {
  S v[V];
};

// ---- storage <-> compute ---------------------------------------------------
// f32 and i32 store what they compute; bf16 and f16 are stored as their bits
// in an unsigned short and computed as a float that the type can represent.

CK_D float ck_bits_to_float(unsigned int u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

CK_D unsigned int ck_float_to_bits(float f) {
  unsigned int u;
  memcpy(&u, &f, 4);
  return u;
}

#ifdef __CUDACC__
CK_D unsigned short ck_bf16_bits(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
CK_D float ck_bf16_value(unsigned short b) { return __bfloat162float(__ushort_as_bfloat16(b)); }
CK_D unsigned short ck_f16_bits(float f) { return __half_as_ushort(__float2half_rn(f)); }
CK_D float ck_f16_value(unsigned short b) { return __half2float(__ushort_as_half(b)); }
CK_D void ck_bf16x2_bits(unsigned short* r, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  r[0] = __bfloat16_as_ushort(h.x);
  r[1] = __bfloat16_as_ushort(h.y);
}
CK_D void ck_f16x2_bits(unsigned short* r, float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  r[0] = __half_as_ushort(h.x);
  r[1] = __half_as_ushort(h.y);
}
#else
// round to nearest even; a NaN gives 0xffff, as ATen's vectorized CPU
// conversion does (the card's instruction gives 0x7fff)
CK_D unsigned short ck_bf16_bits(float f) {
  unsigned int u = ck_float_to_bits(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (unsigned short)0xffffu;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}
CK_D float ck_bf16_value(unsigned short b) { return ck_bits_to_float((unsigned int)b << 16); }
CK_D unsigned short ck_f16_bits(float f) {
  _Float16 h = (_Float16)f;
  unsigned short b;
  memcpy(&b, &h, 2);
  return b;
}
CK_D float ck_f16_value(unsigned short b) {
  _Float16 h;
  memcpy(&h, &b, 2);
  return (float)h;
}
CK_D void ck_bf16x2_bits(unsigned short* r, float a, float b) {
  r[0] = ck_bf16_bits(a);
  r[1] = ck_bf16_bits(b);
}
CK_D void ck_f16x2_bits(unsigned short* r, float a, float b) {
  r[0] = ck_f16_bits(a);
  r[1] = ck_f16_bits(b);
}
#endif

CK_D float ck_rbf16(float f) { return ck_bf16_value(ck_bf16_bits(f)); }
CK_D float ck_rf16(float f) { return ck_f16_value(ck_f16_bits(f)); }

// int32 + - * and unary minus wrap like torch's, through unsigned arithmetic
CK_D int ck_iadd(int a, int b) { return (int)((unsigned int)a + (unsigned int)b); }
CK_D int ck_isub(int a, int b) { return (int)((unsigned int)a - (unsigned int)b); }
CK_D int ck_imul(int a, int b) { return (int)((unsigned int)a * (unsigned int)b); }
CK_D int ck_ineg(int a) { return (int)(0u - (unsigned int)a); }
CK_D int ck_iabs(int a) { return a < 0 ? ck_ineg(a) : a; }

// torch.maximum / minimum: NaN propagates, and -0.0 < +0.0
CK_D float ck_fmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return signbit(a) ? b : a;
  return a > b ? a : b;
}
CK_D float ck_fmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return signbit(a) ? a : b;
  return a < b ? a : b;
}
CK_D int ck_imax(int a, int b) { return a > b ? a : b; }
CK_D int ck_imin(int a, int b) { return a < b ? a : b; }

#ifndef __CUDACC__
// the host build flags a vector access the card could not make aligned
static thread_local int ck_misaligned = 0;
#endif

template <class S, int V>
CK_D CkVec<S, V> ck_vload(const S* p, long long i) {
#ifdef __CUDACC__
  return *(const CkVec<S, V>*)(p + i);
#else
  CkVec<S, V> r;
  if ((unsigned long long)(p + i) % sizeof(r) != 0) ck_misaligned = 1;
  memcpy(&r, p + i, sizeof(r));
  return r;
#endif
}

template <class S, int V>
CK_D void ck_vstore(S* p, long long i, const CkVec<S, V>& v) {
#ifdef __CUDACC__
  *(CkVec<S, V>*)(p + i) = v;
#else
  if ((unsigned long long)(p + i) % sizeof(v) != 0) ck_misaligned = 1;
  memcpy(p + i, &v, sizeof(v));
#endif
}

// ---- the traced function ---------------------------------------------------
// ck_fn(compute values) -> compute value, CK_VEC, ck_vecs<U>(a, v, nt), which
// loads, applies and stores U vectors (v, v + nt, ...), and ck_one(a, i),
// which does one element.
// @CK_ELEMENT_FUNCTION@

// one thread of the grid: vectors v = t, t + nt, ... CK_U at a time, then the
// elements after the last whole vector (none where n is a multiple of 128)
CK_D void ew_vec_thread(const CkArgs& a, long long n, long long t, long long nt) {
  const long long nvec = n / CK_VEC;
  long long v = t;
  for (; v + (CK_U - 1) * nt < nvec; v += CK_U * nt) ck_vecs<CK_U>(a, v, nt);
  for (; v < nvec; v += nt) ck_vecs<1>(a, v, nt);
  for (long long i = nvec * CK_VEC + t; i < n; i += nt) ck_one(a, i);
}

CK_D void ew_scalar_thread(const CkArgs& a, long long n, long long t, long long nt) {
  for (long long i = t; i < n; i += nt) ck_one(a, i);
}

#ifdef __CUDACC__

extern "C" __global__ void __launch_bounds__(CK_THREADS) ew_vec_kernel(CkArgs a, long long n) {
  ew_vec_thread(a, n, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                (long long)gridDim.x * blockDim.x);
}

extern "C" __global__ void __launch_bounds__(CK_THREADS) ew_scalar_kernel(CkArgs a, long long n) {
  ew_scalar_thread(a, n, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                   (long long)gridDim.x * blockDim.x);
}

// vec != 0: every pointer is aligned to CK_VEC elements of its type
extern "C" int ew_launch(void* out, const void* const* ins, int n_in, long long n, int vec,
                         void* stream) {
  if (n <= 0) return 0;
  if (n_in < 0 || n_in > CK_MAX_IN) return (int)cudaErrorInvalidValue;
  CkArgs a;
  for (int k = 0; k < CK_MAX_IN; ++k) a.in[k] = k < n_in ? ins[k] : 0;
  a.out = out;
  // one step for each thread
  const long long steps = vec ? (n / CK_VEC + CK_U - 1) / CK_U : n;
  const long long grid = (steps + CK_THREADS - 1) / CK_THREADS;
  const unsigned int blocks = (unsigned int)(grid > 0 ? grid : 1);
  if (vec)
    ew_vec_kernel<<<blocks, CK_THREADS, 0, (cudaStream_t)stream>>>(a, n);
  else
    ew_scalar_kernel<<<blocks, CK_THREADS, 0, (cudaStream_t)stream>>>(a, n);
  return (int)cudaGetLastError();
}

#else

// the host build: the grid's threads, run one after another
extern "C" int ew_launch(void* out, const void* const* ins, int n_in, long long n, int vec,
                         void* stream) {
  (void)stream;
  if (n <= 0) return 0;
  if (n_in < 0 || n_in > CK_MAX_IN) return 1;
  CkArgs a;
  for (int k = 0; k < CK_MAX_IN; ++k) a.in[k] = k < n_in ? ins[k] : 0;
  a.out = out;
  ck_misaligned = 0;
  for (long long t = 0; t < CK_HOST_THREADS; ++t) {
    if (vec)
      ew_vec_thread(a, n, t, CK_HOST_THREADS);
    else
      ew_scalar_thread(a, n, t, CK_HOST_THREADS);
  }
  return ck_misaligned;  // nonzero: a vector the card could not load
}

#endif
