// adj_probe: the far-field ptychography adjoint with respect to the probe,
// in one kernel pass over a farplane, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py adj_probe
// (_adj_probe_kernel). For every (angle, position, mode) frame of the
// farplane it computes
//   adj = F^H far[t, s, m] conj(F),  F[u, y] = e^{-2 pi i u y / d} / sqrt(d)
// (the unitary inverse DFT cropped to the top-left p x p patch), multiplies
// by conj(psi[y:y+p, x:x+p]) and sums over the positions into the probe
// mode: out (t, m, p, p). Positions whose scan row is < 0 (masked dummies)
// or whose window leaves the object (invalid input) contribute nothing.
// The TPU kernel's ry-binned accumulator (_combine_probe_bins) serves
// Mosaic's row alignment and has no counterpart here.
//
// What bounds it: one read of the farplane (8 bytes a pixel, 2.1 GB at
// 16384 frames of 128^2: 0.64 ms at 3.35 TB/s) against the two adjoint
// DFT products, d*p*(d+p) complex multiply-adds per frame and mode
// (5.5e11 fp32 FLOPs there), on the SIMT fp32 units (dft_frame.cuh cgemm),
// which take far longer. Every frame adds into the same p^2 probe pixels,
// so, as in grad_prb_fused, each block adds its frames without atomics into
// a block-owned partial (t, m, p, p) in scratch sized by the grid, and
// sum_block_partials adds the partials over the blocks in a fixed order.
//
// Contract: bitwise reproducible (fixed frame-to-block assignment, fixed
// order within a block and over the blocks).

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* far;   // (t, s, m, d, d)
  const float2* psi;   // (t, nz, n)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* acc;         // gridDim.x * (t*m*p*p) block partials
  float2* scratch;     // gridDim.x * (p*d)
  int t, s, nz, n, m, p, d;
};

__global__ void __launch_bounds__(kThreads, 2) adj_probe_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  const int64_t pp = static_cast<int64_t>(p) * p;
  const int64_t dd = static_cast<int64_t>(d) * d;
  float2* mine = q.acc + blockIdx.x * (q.t * m * pp);
  for (int64_t i = threadIdx.x; i < q.t * m * pp; i += kThreads) {
    mine[i] = make_float2(0.f, 0.f);
  }
  load_twiddles(tw, d);  // its closing barrier also orders the zeroing

  float2* a1 = q.scratch + blockIdx.x * static_cast<int64_t>(p) * d;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* obj = q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    for (int mm = 0; mm < m; ++mm) {
      const float2* fr = q.far + (f * m + mm) * dd;
      float2* out = mine + (static_cast<int64_t>(th) * m + mm) * pp;
      adjoint_frame_mode(
          [&](int u, int v) { return fr[u * d + v]; }, p, d, tw, a1,
          [&](int y, int x, float2 z) {
            const float2 g = cmul(conjf2(obj[static_cast<int64_t>(y) * q.n + x]), z);
            float2& a = out[y * p + x];
            a = make_float2(a.x + g.x, a.y + g.y);
          },
          sm);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel and the block sum on `stream` with `grid` blocks;
// returns the first cudaGetLastError() that is not 0 (0 on success).
// `acc` holds grid * t*m*p*p complex floats, `scratch` grid * p * d; `out`
// (t, m, p, p) receives the sum.
int tk_adj_probe(const void* far, const void* psi, const void* scan,
                 void* out, void* acc, void* scratch, int t, int s, int nz,
                 int n, int m, int p, int d, int grid, void* stream) {
  Params q{static_cast<const float2*>(far), static_cast<const float2*>(psi),
           static_cast<const int*>(scan), static_cast<float2*>(acc),
           static_cast<float2*>(scratch), t, s, nz, n, m, p, d};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  adj_probe_kernel<<<grid, kThreads, smem, st>>>(q);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t total = static_cast<int64_t>(t) * m * p * p;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  sum_block_partials<float2><<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(acc), static_cast<float2*>(out), total,
      grid);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at detector side `d` (`has_base` is unused);
// returns the CUDA error code.
int tk_adj_probe_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, adj_probe_kernel, kThreads, smem));
}

}  // extern "C"
