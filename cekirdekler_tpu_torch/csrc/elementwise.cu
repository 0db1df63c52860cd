// Blockwise elementwise map on Hopper: out[i] = fn(in0[i], in1[i], ...).
//
// Replaces the TPU kernel cekirdekler_tpu/ops/elementwise.py::map_blocks
// (and saxpy, which is map_blocks of y + alpha*x).  There the inputs are cut
// into (rows, 128) VMEM blocks on a 1-D grid, and the traced fn runs on each
// block: one HBM read per input and one write of the output, however many
// ops fn fuses.  Here fn is traced on the host (ops/elementwise.py) into a
// small expression over the inputs, and that expression is spliced into
// this file as ck_fn / ck_vec / ck_one where the marker below stands.  One
// build per distinct expression and dtypes, keyed by the content hash of the
// spliced source.
//
// Bound on this card: memory.  Each element reads every input once and
// writes the output once (saxpy in f32: 12 B per element, 2^24 elements in
// 0.0601 ms at 3.35 TB/s); the arithmetic is a few FP32 operations per
// element.  So the design only has to move bytes well: 16-byte vector loads
// and stores (CK_VEC elements a thread a step) where every pointer is
// aligned for them, a scalar path otherwise, and enough CTAs in flight.
//
// Geometry: a CTA takes tiles of `tile` = block_rows * 128 elements, the
// TPU kernel's block, in a grid-stride loop over tiles; inside a tile its
// threads stride by blockDim.x * CK_VEC.  The result does not depend on
// block_rows: every element is computed by the same ck_fn.
//
// Exactness: built with -fmad=false, so y + a*x rounds the product as the
// plain version does.  bfloat16 and float16 values compute each op in f32
// and round to the storage type after every op (ck_rbf16 / ck_rf16), as
// PyTorch's eager ops do.  The same file compiles with g++ for the host
// (the tests build it there), with a loop in place of the grid.

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#define CK_D __device__ __forceinline__
#else
#define CK_D static inline
#endif

#define CK_THREADS 256
#define CK_MAX_IN 8

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

// round to nearest even, the conversion of torch and of __float2bfloat16
CK_D unsigned short ck_bf16_bits(float f) {
  unsigned int u = ck_float_to_bits(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (unsigned short)0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}

CK_D float ck_bf16_value(unsigned short b) { return ck_bits_to_float((unsigned int)b << 16); }

CK_D float ck_rbf16(float f) { return ck_bf16_value(ck_bf16_bits(f)); }

#ifdef __CUDACC__
CK_D unsigned short ck_f16_bits(float f) { return __half_as_ushort(__float2half_rn(f)); }
CK_D float ck_f16_value(unsigned short b) { return __half2float(__ushort_as_half(b)); }
#else
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
#endif

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

template <class S, int V>
CK_D CkVec<S, V> ck_vload(const void* p, long long i) {
  return *(const CkVec<S, V>*)((const S*)p + i);
}

template <class S, int V>
CK_D void ck_vstore(void* p, long long i, const CkVec<S, V>& v) {
  *(CkVec<S, V>*)((S*)p + i) = v;
}

// ---- the traced function ---------------------------------------------------
// ck_fn(compute values) -> compute value, CK_VEC, and ck_vec(a, i) / ck_one(a, i)
// which load, apply and store CK_VEC elements or one element at i.
// @CK_ELEMENT_FUNCTION@

#ifdef __CUDACC__

extern "C" __global__ void __launch_bounds__(CK_THREADS)
ew_vec_kernel(CkArgs a, long long n, long long tile) {
  long long ntiles = (n + tile - 1) / tile;
  long long stride = (long long)blockDim.x * CK_VEC;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long lo = t * tile;
    long long hi = lo + tile < n ? lo + tile : n;
    long long i = lo + (long long)threadIdx.x * CK_VEC;
    for (; i + CK_VEC <= hi; i += stride) ck_vec(a, i);
    for (; i < hi; ++i) ck_one(a, i);  // a tail shorter than one vector
  }
}

extern "C" __global__ void __launch_bounds__(CK_THREADS)
ew_scalar_kernel(CkArgs a, long long n, long long tile) {
  long long ntiles = (n + tile - 1) / tile;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long lo = t * tile;
    long long hi = lo + tile < n ? lo + tile : n;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) ck_one(a, i);
  }
}

// vec != 0: every pointer is aligned to CK_VEC elements of its type
extern "C" int ew_launch(void* out, const void* const* ins, int n_in, long long n,
                         long long tile, int vec, void* stream) {
  if (n <= 0) return 0;
  if (n_in < 0 || n_in > CK_MAX_IN || tile <= 0) return (int)cudaErrorInvalidValue;
  CkArgs a;
  for (int k = 0; k < CK_MAX_IN; ++k) a.in[k] = k < n_in ? ins[k] : 0;
  a.out = out;
  long long ntiles = (n + tile - 1) / tile;
  unsigned int blocks = (unsigned int)(ntiles < 65535 ? ntiles : 65535);
  if (vec)
    ew_vec_kernel<<<blocks, CK_THREADS, 0, (cudaStream_t)stream>>>(a, n, tile);
  else
    ew_scalar_kernel<<<blocks, CK_THREADS, 0, (cudaStream_t)stream>>>(a, n, tile);
  return (int)cudaGetLastError();
}

#else

// the host build: the CUDA grid's loops, run in order
extern "C" int ew_launch(void* out, const void* const* ins, int n_in, long long n,
                         long long tile, int vec, void* stream) {
  (void)stream;
  if (n <= 0) return 0;
  if (n_in < 0 || n_in > CK_MAX_IN || tile <= 0) return 1;
  CkArgs a;
  for (int k = 0; k < CK_MAX_IN; ++k) a.in[k] = k < n_in ? ins[k] : 0;
  a.out = out;
  for (long long lo = 0; lo < n; lo += tile) {
    long long hi = lo + tile < n ? lo + tile : n;
    long long i = lo;
    if (vec)
      for (; i + CK_VEC <= hi; i += CK_VEC) ck_vec(a, i);
    for (; i < hi; ++i) ck_one(a, i);
  }
  return 0;
}

#endif
