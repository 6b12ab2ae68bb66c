// grad_prb_fused: the probe gradient and the objective of far-field
// ptychography in one kernel pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py grad_prb_fused
// (_grad_prb_kernel), the joint-recovery twin of grad_fused. For every
// (angle, position, mode) frame it computes
//   1. near = psi[y:y+p, x:x+p] * prb[m]                       (p x p)
//   2. far  = F near F^T, F[u, y] = e^{-2 pi i u y / d} / sqrt(d) (d x p);
//   3. the likelihood factor and objective from the mode-summed
//      intensity (dft_frame.cuh pixel_objective);
//   4. adj = F^H (factor * far) conj(F);
//   5. conj(psi[y:y+p, x:x+p]) * adj, summed over the positions into the
//      probe gradient (t, m, p, p).
// Outputs grad_prb = G_prb^H(factor * G psi) (no factor 2) and per-block
// objective partials. Positions whose scan row is < 0 (masked dummies)
// contribute nothing to either; so do out-of-bounds positions (invalid
// input: the kernel never reads outside the object).
//
// What bounds it: as grad_fused, the four DFT products, 2*d*p*(d+p) complex
// multiply-adds per frame and mode (1.1e12 fp32 FLOPs at 16384 frames of
// 128^2) on the SIMT fp32 units; its only large read is the data. What its
// design is about: every frame adds into the same p^2 probe pixels, so the
// atomics that grad_fused scatters with would collide 16384-fold on each
// pixel. Instead each block owns a partial (t, m, p, p) in scratch sized by
// the grid and adds its frames into it without atomics (in stage 4's
// epilogue each (y, x) has one owning thread, and the frames of a block
// follow one another); sum_block_partials then adds the partials over the
// blocks in a fixed order.
//
// Contract: bitwise reproducible -- the frame-to-block assignment, the
// order of the frames within a block, the block sum and the objective
// (summed per thread and per block in double in a fixed order, then over
// the blocks by the caller) are all fixed, as the TPU kernel's in-order
// grid accumulation is.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const float* data;   // (t, s, d, d)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* acc;         // gridDim.x * (t*m*p*p) block partials
  float2* scratch;     // gridDim.x * (m*p*d + m*d*d)
  double* partial;     // gridDim.x objective partials
  int t, s, nz, n, m, p, d, model;
};

// Two resident blocks per SM: caps registers at 128 per thread.
__global__ void __launch_bounds__(kThreads, 2)
    grad_prb_fused_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  const int64_t pp = static_cast<int64_t>(p) * p;
  const int64_t pd = static_cast<int64_t>(p) * d;
  const int64_t dd = static_cast<int64_t>(d) * d;
  float2* mine = q.acc + blockIdx.x * (q.t * m * pp);
  for (int64_t i = threadIdx.x; i < q.t * m * pp; i += kThreads) {
    mine[i] = make_float2(0.f, 0.f);
  }
  load_twiddles(tw, d);  // its closing barrier also orders the zeroing

  float2* s1 = q.scratch + blockIdx.x * (m * pd + m * dd);  // m x (p x d)
  float2* s2 = s1 + m * pd;                                 // m x (d x d)
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  double fsum = 0.0;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* obj = q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * pp;
    const float* dat = q.data + f * dd;

    for (int mm = 0; mm < m; ++mm) {
      float2* a2 = s2 + mm * dd;
      // Stages 1-2: a2 = the farplane of this mode.
      forward_frame_mode(obj, q.n, prb + mm * pp, p, d, tw, s1 + mm * pd,
                         [&](int u, int v, float2 z) { a2[u * d + v] = z; },
                         sm);
    }

    // Likelihood factor and objective from the mode-summed intensity.
    for (int64_t i = threadIdx.x; i < dd; i += kThreads) {
      float inten = 0.f;
      for (int mm = 0; mm < m; ++mm) {
        const float2 z = s2[mm * dd + i];
        inten += z.x * z.x + z.y * z.y;
      }
      float factor;
      fsum += pixel_objective(q.model, inten, dat[i], &factor);
      for (int mm = 0; mm < m; ++mm) {
        float2& z = s2[mm * dd + i];
        z = make_float2(z.x * factor, z.y * factor);
      }
    }
    __syncthreads();

    for (int mm = 0; mm < m; ++mm) {
      const float2* a2 = s2 + mm * dd;
      float2* out = mine + (static_cast<int64_t>(th) * m + mm) * pp;
      // Stages 3-4: the adjoint DFT of the weighted farplane; add
      // conj(patch) * adj into this block's partial of the probe mode.
      adjoint_frame_mode(
          [&](int u, int v) { return a2[u * d + v]; }, p, d, tw, s1 + mm * pd,
          [&](int y, int x, float2 z) {
            const float2 g = cmul(conjf2(obj[static_cast<int64_t>(y) * q.n + x]), z);
            float2& a = out[y * p + x];
            a = make_float2(a.x + g.x, a.y + g.y);
          },
          sm);
    }
  }

  block_sum_store(fsum, q.partial + blockIdx.x);
}

}  // namespace

extern "C" {

// Launches the kernel and the block sum on `stream` with `grid` blocks;
// returns the first cudaGetLastError() that is not 0 (0 on success).
// `acc` holds grid * t*m*p*p complex floats, `scratch` grid * (m*p*d +
// m*d*d), `partial` grid doubles; `grad` (t, m, p, p) receives the sum.
int tk_grad_prb_fused(const void* psi, const void* prb, const void* data,
                      const void* scan, void* grad, void* acc, void* scratch,
                      void* partial, int t, int s, int nz, int n, int m,
                      int p, int d, int model, int grid, void* stream) {
  Params q{static_cast<const float2*>(psi), static_cast<const float2*>(prb),
           static_cast<const float*>(data), static_cast<const int*>(scan),
           static_cast<float2*>(acc), static_cast<float2*>(scratch),
           static_cast<double*>(partial), t, s, nz, n, m, p, d, model};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  grad_prb_fused_kernel<<<grid, kThreads, smem, st>>>(q);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t total = static_cast<int64_t>(t) * m * p * p;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  sum_block_partials<float2><<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(acc), static_cast<float2*>(grad), total,
      grid);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at detector side `d` (`has_base` is unused: the
// probe gradient has no split-operator base); returns the CUDA error code.
int tk_grad_prb_fused_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, grad_prb_fused_kernel, kThreads, smem));
}

}  // extern "C"
