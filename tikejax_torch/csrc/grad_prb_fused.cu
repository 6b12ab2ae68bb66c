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
// What its design is about: every frame adds into the same p^2 probe
// pixels, so the atomics that grad_fused scatters with would collide
// 16384-fold on each pixel. Instead each block owns a partial (t, m, p, p)
// in scratch sized by the grid and adds its frames into it without atomics
// (each (y, x) always by the same thread, and the frames of a block follow
// one another); sum_block_partials then adds the partials over the blocks
// in a fixed order.
//
// Two kernels compute it; the wrapper picks one from the shapes alone, the
// same way for grad_fused, minf_fused and this one (a line search compares
// their objectives: dft_frame.cuh, "the forward half of a frame").
//
// The FFT variant (grad_prb_fused_fft_kernel; detector side 16, 32, 64 or
// 128) is grad_fused's, with adj_probe's epilogue in place of the scatter:
// one frame per block, the complex frame in dynamic shared memory,
// dft_frame.cuh fft2_frame in place both ways, no scratch but the partial.
// What bounds it: the sweeps over the frame in shared memory, the
// partial's read and write in L2 (2 x 128 KiB a frame at 128^2) and the
// one read of the data.
//
// The GEMM variant (grad_prb_fused_kernel; every other size): as
// grad_fused's, the four DFT products, 2*d*p*(d+p) complex multiply-adds
// per frame and mode (1.1e12 fp32 FLOPs at 16384 frames of 128^2) on the
// SIMT fp32 units; its only large read is the data.
//
// Contract (both variants): bitwise reproducible -- the frame-to-block
// assignment, the order of the frames within a block, the block sum and the
// objective (summed per thread and per block in double in a fixed order,
// then over the blocks by the caller) are all fixed, as the TPU kernel's in-
// order grid accumulation is.

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
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
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
            const float2 g =
                cmul(conjf2(obj[static_cast<int64_t>(y) * q.n + x]), z);
            float2& a = out[y * p + x];
            a = make_float2(a.x + g.x, a.y + g.y);
          },
          sm);
    }
  }

  block_sum_store(fsum, q.partial + blockIdx.x);
}

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const float* data;   // (t, s, d, d)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* acc;         // gridDim.x * (t*m*p*p) block partials
  double* partial;     // gridDim.x objective partials
  int t, s, nz, n, m, p, model;
  int prefetch;  // one mode only: fetch the next measured frame ahead
};

// out[patch pixel] += conj(psi[patch]) * fr (the cropped inverse
// transform): pixel i of the partial always by thread i mod kT. Ends with a
// barrier, after which the frame may be overwritten.
template <int kD, int kT>
__device__ __forceinline__ void add_probe_patch(const float2* fr, float2* out,
                                                const float2* obj, int n,
                                                int p) {
  for (int i = threadIdx.x; i < p * p; i += kT) {
    const int y = i / p, x = i - y * p;
    const float2 g = cmul(conjf2(obj[static_cast<int64_t>(y) * n + x]),
                          fr[fft_near_index<kD>(y, x)]);
    float2& a = out[i];
    a = make_float2(a.x + g.x, a.y + g.y);
  }
  __syncthreads();
}

template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1)
    grad_prb_fused_fft_kernel(FftParams q) {
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;    // e^{-2 pi i k / d}
  float2* tws = tw + kD;  // the same / d
  float2* fr = tws + kD;  // the frame
  // With several modes: the mode-summed intensity, then the factor. With
  // one mode and q.prefetch: the measured frame, fetched ahead.
  float* plane = reinterpret_cast<float*>(fr + FftFrame<kD>::size);

  const int p = q.p, m = q.m;
  const int64_t pp = static_cast<int64_t>(p) * p;
  constexpr int dd = kD * kD;
  float2* mine = q.acc + blockIdx.x * (q.t * m * pp);
  for (int64_t i = threadIdx.x; i < q.t * m * pp; i += kT) {
    mine[i] = make_float2(0.f, 0.f);
  }
  fft_load_twiddles<kD, kT>(tw, tws);  // its barrier also orders the zeroing

  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  double fsum = 0.0;
  int64_t fetched = -1;  // the frame whose data `plane` holds or awaits

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;  // block-uniform
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * pp;
    const float* dat = q.data + f * dd;
    float2* out = mine + static_cast<int64_t>(th) * m * pp;

    if (m == 1) {
      if (q.prefetch && fetched != f) {  // the block's first frame
        fft_fetch_data<kD, kT>(plane, dat);
      }
      fsum += fft_forward_one_mode<kD, kT, false, true>(
          fr, tw, tws, obj, q.n, prb, p, nullptr, dat,
          q.prefetch ? plane : nullptr, q.model);
      if (q.prefetch) {
        fetched = fft_next_frame(q.scan, f, frames, q.nz, q.n, p);
        if (fetched < frames) {
          fft_fetch_data<kD, kT>(plane, q.data + fetched * dd);
        }
      }
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      add_probe_patch<kD, kT>(fr, out, obj, q.n, p);
      continue;
    }

    fsum += fft_forward_modes<kD, kT, false>(fr, plane, tw, tws, obj, q.n,
                                             prb, m, p, nullptr, dat,
                                             q.model);
    for (int mm = 0; mm < m; ++mm) {
      fft_weighted_mode<kD, kT, false>(fr, plane, tw, tws, obj, q.n,
                                       prb + mm * pp, p, nullptr);
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      add_probe_patch<kD, kT>(fr, out + mm * pp, obj, q.n, p);
    }
  }

  block_sum_store_n<kT>(fsum, q.partial + blockIdx.x);
}

struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return grad_prb_fused_fft_kernel<kD, kT>;
  }
};

// grad = the sum of the `grid` block partials in `acc`, in a fixed order.
int sum_partials(const void* acc, void* grad, int t, int m, int p, int grid,
                 cudaStream_t st) {
  const int64_t total = static_cast<int64_t>(t) * m * p * p;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  sum_block_partials<float2><<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(acc), static_cast<float2*>(grad), total,
      grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the GEMM variant and the block sum on `stream` with `grid`
// blocks; returns the first cudaGetLastError() that is not 0 (0 on
// success). `acc` holds grid * t*m*p*p complex floats, `scratch` grid *
// (m*p*d + m*d*d), `partial` grid doubles; `grad` (t, m, p, p) receives the
// sum.
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
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_partials(acc, grad, t, m, p, grid, st);
}

// Resident blocks per SM of the GEMM variant at detector side `d`
// (`has_base` is unused: the probe gradient has no split-operator base);
// returns the CUDA error code.
int tk_grad_prb_fused_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, grad_prb_fused_kernel, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) and the block sum on `stream` with `grid` blocks; returns the first
// CUDA error (0 on success). `acc` and `partial` as in tk_grad_prb_fused; there
// is no scratch. `prefetch` != 0 (one mode only, `data` 16-byte aligned)
// fetches each measured frame a frame ahead.
int tk_grad_prb_fused_fft(const void* psi, const void* prb, const void* data,
                          const void* scan, void* grad, void* acc,
                          void* partial, int t, int s, int nz, int n, int m,
                          int p, int d, int model, int prefetch, int grid,
                          int threads, void* stream) {
  if (prefetch && m != 1) return static_cast<int>(cudaErrorInvalidValue);
  FftParams q{static_cast<const float2*>(psi),
              static_cast<const float2*>(prb),
              static_cast<const float*>(data), static_cast<const int*>(scan),
              static_cast<float2*>(acc), static_cast<double*>(partial),
              t, s, nz, n, m, p, model, prefetch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fft_launch<FftKernels>(
      q, d, threads, m > 1 || prefetch ? 1 : 0, grid, st);
  if (err) return err;
  return sum_partials(acc, grad, t, m, p, grid, st);
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes, with `planes` (0 or 1) float planes beside the frame
// (`has_base` is unused); returns the CUDA error code.
int tk_grad_prb_fused_fft_blocks_per_sm(int d, int has_base, int planes,
                                        int threads, int* out,
                                        int* smem_bytes) {
  (void)has_base;
  return fft_occupancy<FftKernels>(d, threads, planes, out, smem_bytes);
}

}  // extern "C"
