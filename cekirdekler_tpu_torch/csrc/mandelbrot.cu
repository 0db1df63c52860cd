// Mandelbrot escape counts on Hopper, one thread per pixel.
//
// Replaces the TPU kernel cekirdekler_tpu/ops/mandelbrot.py::mandelbrot_pallas
// (body _mandel_kernel): there a (rows, 128) pixel block sits in VMEM for a
// per-block early-exit while_loop; here each thread iterates its own orbit,
// so no block-wide loop and no masks.  An escaped orbit freezes its count in
// both versions, so the counts agree.
//
// Bound on this card: issue.  One pass of the escape loop is 8 FP32
// instructions under -fmad=false (zx*zx, zy*zy, their sum for the test,
// zx2 - zy2, + cx, 2*zx, * zy, + cy), and an escaped pixel's failing test
// 3 more.  The FP32 pipe and the issue both take one warp instruction a
// clock on each of the 528 schedulers (132 SMs x 128 lanes x 1.98 GHz), so
// the least time is (8 x sum(counts) + 3 x escaped pixels) over that rate:
// 0.068 ms at 2048x2048, max_iter 256 (the 0.0422 stated before counted 10
// operations a pass at 67 TFLOP/s, which counts an FMA as two).  Memory is
// 4 B a pixel written once.
//
// What the design does about it: every instruction besides those 8 costs an
// issue slot, and a plain loop spends four to six a pass on its own overhead
// (the SASS of the first version: the test's branch out, a loop counter and
// its test, the count, the branch back).  So the loop runs in groups of
// MANDEL_GROUP passes, unrolled, with no branch inside a group:
// - a sticky flag, in = in & (zx2 + zy2 < 4), drops at the first failing
//   test and never rises again; ptxas folds the test and the fold into one
//   FSETP.AND, and keeps each pass's flag f[u] in its own predicate (at 6
//   passes a group it spills one with P2R: 9.67 instructions a pass);
// - the one counter rises by MANDEL_GROUP a group; in the group where the
//   flag dropped it is set to the group's start plus its passes whose flag
//   held, which is where a break would have stopped it (adding the flag to
//   the count each pass costs two integer instructions a pass in the SASS);
// - zx and zy run on after the flag drops (to inf or NaN: NaN < 4 is false,
//   so the flag stays down), and nothing reads them afterwards;
// - a group runs only while it + MANDEL_GROUP <= max_iter, so no pass of a
//   group can pass max_iter, and the loop leaves after a group whose flag
//   dropped: one branch and one max_iter test a group;
// - a tail of fewer than MANDEL_GROUP passes runs the plain loop.
// So every pixel's count is the plain loop's, bit for bit.  The SASS
// (tools/sweep_mandelbrot.py --sass) has 9 instructions a pass (8 FP32, one
// FSETP) and 3 a group (IADD3, ISETP, BRA): 9.75 a pass at 4 a group, where
// the first version had 14.  Groups of 4 read fastest on an H100 (groups of
// 2 / 4 / 6 / 8 / 16: 0.1218 / 0.1147 / 0.1167 / 0.1204 / 0.1377 ms at
// 2048x2048, max_iter 256): a warp runs a whole group past its last
// pixel's escape, which costs more at 8 and 16 than their fewer group
// overheads save.
//
// Exactness: build with -fmad=false (an FMA changes counts on the set's
// boundary).  The coefficients arrive already rounded to f32 and the pixel
// coordinates are computed in int32, matching the plain version.
//
// The kernel writes its counts directly into out[offset, offset + n) of the
// whole output buffer, in place: the counterpart of the TPU path's update
// pass, without the extra copy.  The same file compiles with g++ for the
// host (the tests build it there), the pixels run one after another.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MB_D __device__ __forceinline__
#define MB_UNROLL _Pragma("unroll")
#else
#define MB_D static inline
#define MB_UNROLL
#endif

#ifndef MANDEL_GROUP
#define MANDEL_GROUP 4  // passes a group runs (a sweep on the card chose it)
#endif

MB_D float mandel_count(int idx, float x0, float y0, float dx, float dy, int width,
                        int max_iter) {
  const int px = idx % width;
  const int py = idx / width;
  const float cx = x0 + dx * (float)px;
  const float cy = y0 + dy * (float)py;
  float zx = 0.0f, zy = 0.0f;
  int it = 0;
  bool in = true;
  const long long last = (long long)max_iter - MANDEL_GROUP;  // a group may start at it <= last
  if (last >= 0) {
    const int lim = (int)last;
    bool f[MANDEL_GROUP];
    while (in && it <= lim) {
      in = true;  // so it is: saying so keeps the flag out of a register between groups
      MB_UNROLL
      for (int u = 0; u < MANDEL_GROUP; ++u) {
        const float zx2 = zx * zx;
        const float zy2 = zy * zy;
        in = in & (zx2 + zy2 < 4.0f);
        f[u] = in;
        const float tr = zx2 - zy2 + cx;
        zy = 2.0f * zx * zy + cy;
        zx = tr;
      }
      it += MANDEL_GROUP;
    }
    if (!in) {  // the group the flag dropped in: count its passes whose test held
      it -= MANDEL_GROUP;
      MB_UNROLL
      for (int u = 0; u < MANDEL_GROUP; ++u) it += (int)f[u];
    }
  }
  if (in) {
    for (; it < max_iter; ++it) {
      const float zx2 = zx * zx;
      const float zy2 = zy * zy;
      if (!(zx2 + zy2 < 4.0f)) break;
      const float tr = zx2 - zy2 + cx;
      zy = 2.0f * zx * zy + cy;
      zx = tr;
    }
  }
  return (float)it;
}

#ifdef __CUDACC__

extern "C" __global__ void __launch_bounds__(256)
mandelbrot_kernel(float* out, long long n_out, int offset, int n, float x0,
                  float y0, float dx, float dy, int width, int max_iter) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int idx = offset + (int)t;
  const float count = mandel_count(idx, x0, y0, dx, dy, width, max_iter);
  if (idx >= 0 && (long long)idx < n_out) out[idx] = count;
}

extern "C" int mandelbrot_launch(float* out, long long n_out, int offset, int n,
                                 float x0, float y0, float dx, float dy,
                                 int width, int max_iter, void* stream) {
  if (n <= 0) return 0;
  unsigned int blocks = (unsigned int)((n + 255) / 256);
  mandelbrot_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      out, n_out, offset, n, x0, y0, dx, dy, width, max_iter);
  return (int)cudaGetLastError();
}

#else

// the host build: the grid's pixels, run one after another
extern "C" int mandelbrot_launch(float* out, long long n_out, int offset, int n,
                                 float x0, float y0, float dx, float dy,
                                 int width, int max_iter, void* stream) {
  (void)stream;
  for (int t = 0; t < n; ++t) {
    const int idx = offset + t;
    const float count = mandel_count(idx, x0, y0, dx, dy, width, max_iter);
    if (idx >= 0 && (long long)idx < n_out) out[idx] = count;
  }
  return 0;
}

#endif
