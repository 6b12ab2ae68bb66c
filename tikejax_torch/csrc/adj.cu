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
// the object (invalid input) contribute nothing, and their frames are not
// read.
//
// Two kernels compute it; the wrapper picks one from the shapes alone, as
// for the other DFT kernels (ops/fused.py dft_variant).
//
// The FFT variant (adj_fft_kernel; detector side 16, 32, 64 or 128) is
// adj_residual.cu's FFT tail without the likelihood: one frame per block,
// the complex frame in dynamic shared memory (140 KiB at 128^2, one block
// per SM), loaded with 16-byte streaming loads, two neighbouring pixels a
// load, straight into the order the inverse transform takes
// (fft_far_index); then dft_frame.cuh fft2_frame and scatter_patch. With
// several modes each mode is loaded, transformed and scattered in turn.
// What bounds it: the one read of the farplane (8 bytes a pixel, 2.1 GB at
// 16384 frames of 128^2: 0.64 ms at 3.35 TB/s), against the sweeps over
// the frame in shared memory (the load, four inverse stages, the scatter)
// and the scatter's fp32 atomics, two per patch pixel and mode. The FFT
// arithmetic (1.1 MFLOP a frame) is far below these.
//
// The GEMM variant (adj_kernel; every other size): the two adjoint DFT
// products, d*p*(d+p) complex multiply-adds per frame and mode (5.5e11
// fp32 FLOPs at 16384 frames of 128^2), on the SIMT fp32 units
// (dft_frame.cuh cgemm), which take far longer than the read. The
// farplane is read straight from device memory by the first product's tile
// loads (neighbouring threads on neighbouring pixels); the only per-block
// scratch is one p x d intermediate.
//
// Contract (both variants): the scatter uses atomicAdd on the fp32 re/im
// planes, as grad_fused's does, so the result is deterministic only up to
// summation order (the TPU kernel's in-order scatter is bitwise
// deterministic).

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

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* far;   // (t, s, m, d, d), 16-byte aligned
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float* out;          // (t, nz, n) complex as interleaved re/im floats
  int t, s, nz, n, m, p;
};

// One block per SM at 128^2 (the frame fills the shared memory): registers
// are capped at 65536 / kT. Thread j loads the farplane pixel pairs
// (2i, 2i + 1), i = j, j + kT, ... of every frame.
template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1) adj_fft_kernel(FftParams q) {
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;    // e^{-2 pi i k / d}
  float2* tws = tw + kD;  // the same / d
  float2* fr = tws + kD;  // the frame
  fft_load_twiddles<kD, kT>(tw, tws);

  const int p = q.p, m = q.m;
  constexpr int dd = kD * kD;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;  // block-uniform
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    for (int mm = 0; mm < m; ++mm) {
      // Two neighbouring pixels a load; the farplane is read once, so it
      // streams past the caches.
      const float4* src =
          reinterpret_cast<const float4*>(q.far + (f * m + mm) * dd);
      for (int i = threadIdx.x; i < dd / 2; i += kT) {
        const float4 w = __ldcs(src + i);
        const int u = (2 * i) / kD, v = (2 * i) % kD;
        fr[fft_far_index<kD>(u, v)] = make_float2(w.x, w.y);
        fr[fft_far_index<kD>(u, v + 1)] = make_float2(w.z, w.w);
      }
      __syncthreads();
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      // Ends with a barrier: the next mode's load may overwrite the frame.
      scatter_patch<kD, kT>(fr, q.out, th, q.nz, q.n, sy, sx,
                            prb + static_cast<int64_t>(mm) * p * p, p);
    }
  }
}

struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return adj_fft_kernel<kD, kT>;
  }
};

}  // namespace

extern "C" {

// Launches the GEMM variant on `stream` with `grid` blocks; returns
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

// Resident blocks per SM of the GEMM variant at detector side `d`
// (`has_base` is unused); returns the CUDA error code.
int tk_adj_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, adj_kernel, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 512, or 1024
// at d = 128) on `stream` with `grid` blocks; returns the first CUDA error
// (0 on success). `far` is 16-byte aligned, `out` zeroed; there is no
// scratch.
int tk_adj_fft(const void* far, const void* prb, const void* scan, void* out,
               int t, int s, int nz, int n, int m, int p, int d, int grid,
               int threads, void* stream) {
  FftParams q{static_cast<const float2*>(far),
              static_cast<const float2*>(prb), static_cast<const int*>(scan),
              static_cast<float*>(out), t, s, nz, n, m, p};
  return fft_launch<FftKernels>(q, d, threads, 0, grid,
                                static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes (`has_base` and `planes` are unused: the kernel has neither);
// returns the CUDA error code.
int tk_adj_fft_blocks_per_sm(int d, int has_base, int planes, int threads,
                             int* out, int* smem_bytes) {
  (void)has_base;
  (void)planes;
  return fft_occupancy<FftKernels>(d, threads, 0, out, smem_bytes);
}

}  // extern "C"
