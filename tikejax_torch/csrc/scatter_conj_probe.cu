// scatter_conj_probe: the hybrid tier's adjoint with respect to the object,
// after the inverse FFT (cuFFT, outside), for NVIDIA Hopper (sm_90a):
// conj-probe multiply, mode sum and overlap scatter-add in one pass,
//   out[t, sy + y, sx + x] += sum_m conj(prb[t, m, y, x]) near[t, s, m, y, x].
//
// Replaces the TPU kernel tikejax/ops/pallas_kernels.py scatter_conj_probe
// (_scatter_kernel); its zero-margined rotated read-modify-write of aligned
// windows serves Mosaic's alignment and has no counterpart. A position
// whose scan row is < 0 (a masked dummy) or whose window leaves the object
// (invalid input) adds nothing, and its frames are not read.
//
// The frames are read in place through their strides (in complex elements;
// the innermost stride is 1): the caller hands the top-left p x p crop of
// the d x d inverse-FFT frames as a strided view, and a contiguous copy of
// it would be one more pass over all frames.
//
// What bounds it: bytes. Every frame pixel is read once (8 bytes a pixel
// and mode, 2.1 GB at 16384 frames of 128^2: 0.64 ms at 3.35 TB/s); the
// probe and the object (2 MiB at 512^2) stay in L2, where the atomic adds
// resolve. One block per frame, neighbouring threads on neighbouring pixels
// of a row; the modes are summed in registers, so each pixel costs one pair
// of atomics whatever the number of modes.
//
// Contract: the scatter uses atomicAdd on the fp32 re/im planes
// (dft_frame.cuh scatter_add_pixel), as adj.cu's: deterministic only up to
// the order in which overlapping patches are summed (the TPU kernel's
// in-order grid is bitwise deterministic).

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* nearp; // (t, s, m, p, p) through the strides below
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float* out;          // (t, nz, n) complex as interleaved re/im floats
  int t, s, nz, n, m, p;
  int64_t st_t, st_s, st_m, st_row;  // strides of nearp, complex elements
};

__global__ void __launch_bounds__(kThreads) scatter_conj_probe_kernel(Params q) {
  const int p = q.p, m = q.m;
  const int pp = p * p;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int64_t si = f - static_cast<int64_t>(th) * q.s;
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* fr = q.nearp + th * q.st_t + si * q.st_s;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * pp;
    for (int i = threadIdx.x; i < pp; i += kThreads) {
      const int y = i / p, x = i - y * p;
      const float2* px = fr + y * q.st_row + x;
      float2 g = make_float2(0.f, 0.f);
      for (int mm = 0; mm < m; ++mm) {
        const float2 v = cmul(conjf2(__ldg(prb + mm * pp + i)), px[mm * q.st_m]);
        g.x += v.x;
        g.y += v.y;
      }
      scatter_add_pixel(q.out, th, q.nz, q.n, sy + y, sx + x, g);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one block per frame (grid-strided past
// 2^31 - 1 frames); returns cudaGetLastError() (0 on success). `out` must
// be zeroed. The strides of `nearp` are in complex elements.
int tk_scatter_conj_probe(const void* nearp, const void* prb, const void* scan,
                          void* out, int t, int s, int nz, int n, int m, int p,
                          int64_t st_t, int64_t st_s, int64_t st_m,
                          int64_t st_row, void* stream) {
  Params q{static_cast<const float2*>(nearp), static_cast<const float2*>(prb),
           static_cast<const int*>(scan), static_cast<float*>(out),
           t, s, nz, n, m, p, st_t, st_s, st_m, st_row};
  const int64_t frames = static_cast<int64_t>(t) * s;
  if (frames == 0) return 0;
  const int grid = static_cast<int>(frames < 2147483647 ? frames : 2147483647);
  scatter_conj_probe_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
