// adj: the far-field ptychography adjoint with respect to the object, in
// one kernel pass over a farplane, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py adj (_adj_kernel).
// For every (angle, position, mode) frame of the farplane it computes
//   adj = F^H far[t, s, m] conj(F),  F[u, y] = e^{-2 pi i u y / d} / sqrt(d)
// (the unitary inverse DFT cropped to the top-left p x p patch), multiplies
// by conj(prb[m]) and scatter-adds the mode sum into the object at the
// position's window: out = sum over frames of T_s^H (conj(prb) * adj).
// Positions whose scan row is < 0 (masked dummies) or whose window leaves
// the object (invalid input) contribute nothing.
//
// What bounds it: one read of the farplane (8 bytes a pixel, 2.1 GB at
// 16384 frames of 128^2: 0.64 ms at 3.35 TB/s) against the two adjoint
// DFT products, d*p*(d+p) complex multiply-adds per frame and mode
// (5.5e11 fp32 FLOPs there), on the SIMT fp32 units (dft_frame.cuh cgemm),
// which take far longer. The farplane is read straight from device memory
// by the first product's tile loads (neighbouring threads on neighbouring
// pixels); the only per-block scratch is one p x d intermediate.
//
// Contract: the scatter uses atomicAdd on the fp32 re/im planes, as
// grad_fused's does, so the result is deterministic only up to summation
// order (the TPU kernel's in-order scatter is bitwise deterministic).

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* far;   // (t, s, m, d, d)
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float* out;          // (t, nz, n) complex as interleaved re/im floats
  float2* scratch;     // gridDim.x * (p*d)
  int t, s, nz, n, m, p, d;
};

__global__ void __launch_bounds__(kThreads, 2) adj_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  load_twiddles(tw, d);

  const int64_t dd = static_cast<int64_t>(d) * d;
  float2* a1 = q.scratch + blockIdx.x * static_cast<int64_t>(p) * d;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    for (int mm = 0; mm < m; ++mm) {
      const float2* fr = q.far + (f * m + mm) * dd;
      const float2* pr = prb + static_cast<int64_t>(mm) * p * p;
      adjoint_frame_mode(
          [&](int u, int v) { return fr[u * d + v]; }, p, d, tw, a1,
          [&](int y, int x, float2 z) {
            const float2 g = cmul(conjf2(pr[y * p + x]), z);
            scatter_add_pixel(q.out, th, q.nz, q.n, sy + y, sx + x, g);
          },
          sm);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with `grid` blocks; returns
// cudaGetLastError() (0 on success). `out` must be zeroed; `scratch` holds
// grid * p * d complex floats.
int tk_adj(const void* far, const void* prb, const void* scan, void* out,
           void* scratch, int t, int s, int nz, int n, int m, int p, int d,
           int grid, void* stream) {
  Params q{static_cast<const float2*>(far), static_cast<const float2*>(prb),
           static_cast<const int*>(scan), static_cast<float*>(out),
           static_cast<float2*>(scratch), t, s, nz, n, m, p, d};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  adj_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at detector side `d` (`has_base` is unused);
// returns the CUDA error code.
int tk_adj_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, adj_kernel, kThreads, smem));
}

}  // extern "C"
