// gather_probe_mul: the hybrid tier's forward nearplane, for NVIDIA Hopper
// (sm_90a): gather the object patch of every scan position and multiply it
// by every probe mode, in one pass,
//   near[t, s, m, y, x] = psi[t, sy + y, sx + x] * prb[t, m, y, x].
// The unitary FFT of the (zero-padded) frames follows outside, in cuFFT.
//
// Replaces the TPU kernel tikejax/ops/pallas_kernels.py gather_probe_mul
// (_gather_mul_kernel). That kernel's aligned power-of-two windows, object
// padding and sublane/lane rotates serve Mosaic's (8, 128) alignment and
// have no counterpart: a patch row here is a plain unaligned run of
// interleaved complex64. A position whose scan row is < 0 (a masked dummy)
// or whose window leaves the object (invalid input) gets zero frames, and
// the object is not read for it.
//
// What bounds it: bytes. The nearplane is written once (8 bytes a pixel and
// mode, 2.1 GB at 16384 frames of 128^2: 0.64 ms at 3.35 TB/s); the object
// (2 MiB at 512^2) and the probe stay in L2, and the arithmetic is one
// complex multiply a pixel. One block per frame; neighbouring threads take
// neighbouring pixels of a row, so the writes are whole 8-byte runs, and
// each object pixel is loaded once for all modes. Offsets are 64-bit: the
// nearplane passes 2^31 floats at 4 modes x 16384 x 128^2.
//
// Contract: bitwise reproducible (no reduction).

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* out;         // (t, s, m, p, p)
  int t, s, nz, n, m, p;
};

__global__ void __launch_bounds__(kThreads) gather_probe_mul_kernel(Params q) {
  const int p = q.p, m = q.m;
  const int pp = p * p;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    float2* out = q.out + f * m * pp;
    if (!frame_valid(sy, sx, q.nz, q.n, p)) {
      for (int64_t i = threadIdx.x; i < static_cast<int64_t>(m) * pp;
           i += kThreads) {
        out[i] = make_float2(0.f, 0.f);
      }
      continue;
    }
    const float2* obj = q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * pp;
    for (int i = threadIdx.x; i < pp; i += kThreads) {
      const int y = i / p, x = i - y * p;
      const float2 a = obj[static_cast<int64_t>(y) * q.n + x];
      for (int mm = 0; mm < m; ++mm) {
        out[static_cast<int64_t>(mm) * pp + i] = cmul(a, __ldg(prb + mm * pp + i));
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one block per frame (grid-strided past
// 2^31 - 1 frames); returns cudaGetLastError() (0 on success).
int tk_gather_probe_mul(const void* psi, const void* prb, const void* scan,
                        void* out, int t, int s, int nz, int n, int m, int p,
                        void* stream) {
  Params q{static_cast<const float2*>(psi), static_cast<const float2*>(prb),
           static_cast<const int*>(scan), static_cast<float2*>(out),
           t, s, nz, n, m, p};
  const int64_t frames = static_cast<int64_t>(t) * s;
  if (frames == 0) return 0;
  const int grid = static_cast<int>(frames < 2147483647 ? frames : 2147483647);
  gather_probe_mul_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
