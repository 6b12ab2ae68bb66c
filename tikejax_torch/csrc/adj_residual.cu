// adj_residual: the gradient tail of far-field ptychography from a farplane
// held in device memory, in one kernel pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py adj_residual
// (_adj_residual_kernel, with _likelihood_factor). It is grad_fused's second
// half: for every (angle, position) frame of the farplane it
//   1. sums |far[t, s, m]|^2 over the modes into the frame's intensity and
//      forms the likelihood factor and objective against the measured frame
//      (dft_frame.cuh pixel_objective);
//   2. takes adj = F^H (factor * far[t, s, m]) conj(F) per mode, the unitary
//      inverse DFT cropped to the top-left p x p patch
//      (F[u, y] = e^{-2 pi i u y / d} / sqrt(d));
//   3. multiplies by conj(prb[m]), sums the modes and scatter-adds into the
//      object gradient.
// Outputs grad = G^H(factor * far) (no factor 2) and per-block objective
// partials. Positions whose scan row is < 0 (masked dummies) contribute
// nothing, to the gradient or to the objective (the TPU kernel's `valid`);
// so do positions whose window leaves the object (invalid input).
//
// What bounds it: one read of the farplane and the data (8 + 4 bytes a
// pixel, 3.2 GB at 16384 frames of 128^2: 0.96 ms at 3.35 TB/s) against the
// two adjoint DFT products, d*p*(d+p) complex multiply-adds per frame and
// mode (5.5e11 fp32 FLOPs there), on the SIMT fp32 units (dft_frame.cuh
// cgemm), which take far longer. The factor is kept as one d x d plane in
// per-block scratch and applied in the first product's tile loads, so the
// weighted farplane is never stored; the farplane itself is read straight
// from device memory, as in adj.cu.
//
// Contract: the gradient scatter uses atomicAdd on the fp32 re/im planes, as
// adj's does, so it is deterministic only up to summation order; the
// objective is summed per thread and per block in double in a fixed order,
// then over the blocks in a fixed order by the caller: bitwise reproducible.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* far;   // (t, s, m, d, d)
  const float* data;   // (t, s, d, d)
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float* grad;         // (t, nz, n) complex as interleaved re/im floats
  float* scratch;      // gridDim.x * stride floats: p x d complex, d x d real
  double* partial;     // gridDim.x objective partials
  int64_t stride;      // floats of scratch per block (even)
  int t, s, nz, n, m, p, d, model;
};

__global__ void __launch_bounds__(kThreads, 2) adj_residual_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  load_twiddles(tw, d);

  const int64_t dd = static_cast<int64_t>(d) * d;
  float* mine = q.scratch + blockIdx.x * q.stride;
  float2* a1 = reinterpret_cast<float2*>(mine);             // p x d
  float* factor = mine + 2 * static_cast<int64_t>(p) * d;  // d x d
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  double fsum = 0.0;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* fr = q.far + f * m * dd;
    const float* dat = q.data + f * dd;

    // Stage 1: the likelihood factor and objective of every pixel.
    for (int64_t i = threadIdx.x; i < dd; i += kThreads) {
      float inten = 0.f;
      for (int mm = 0; mm < m; ++mm) {
        const float2 z = fr[mm * dd + i];
        inten += z.x * z.x + z.y * z.y;
      }
      fsum += pixel_objective(q.model, inten, dat[i], &factor[i]);
    }
    __syncthreads();

    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    for (int mm = 0; mm < m; ++mm) {
      const float2* fm = fr + mm * dd;
      const float2* pr = prb + static_cast<int64_t>(mm) * p * p;
      // Stages 2-3: the adjoint DFT of factor * far; scatter
      // conj(prb) * adj into the gradient.
      adjoint_frame_mode(
          [&](int u, int v) {
            const int i = u * d + v;
            const float2 z = fm[i];
            return make_float2(z.x * factor[i], z.y * factor[i]);
          },
          p, d, tw, a1,
          [&](int y, int x, float2 z) {
            const float2 g = cmul(conjf2(pr[y * p + x]), z);
            scatter_add_pixel(q.grad, th, q.nz, q.n, sy + y, sx + x, g);
          },
          sm);
    }
    // adjoint_frame_mode ends with a barrier: the next frame may overwrite
    // the factor plane.
  }

  block_sum_store(fsum, q.partial + blockIdx.x);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with `grid` blocks; returns
// cudaGetLastError() (0 on success). `grad` must be zeroed, `scratch` hold
// grid * stride floats with stride >= 2*p*d + d*d and even, `partial` grid
// doubles.
int tk_adj_residual(const void* far, const void* data, const void* prb,
                    const void* scan, void* grad, void* scratch,
                    void* partial, int t, int s, int nz, int n, int m, int p,
                    int d, int model, int grid, int64_t stride,
                    void* stream) {
  Params q{static_cast<const float2*>(far), static_cast<const float*>(data),
           static_cast<const float2*>(prb), static_cast<const int*>(scan),
           static_cast<float*>(grad), static_cast<float*>(scratch),
           static_cast<double*>(partial), stride, t, s, nz, n, m, p, d,
           model};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  adj_residual_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at detector side `d` (`has_base` is unused);
// returns the CUDA error code.
int tk_adj_residual_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, adj_residual_kernel, kThreads, smem));
}

}  // extern "C"
