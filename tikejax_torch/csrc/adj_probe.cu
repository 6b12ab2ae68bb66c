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
// Every frame adds into the same p^2 probe pixels, so, as in
// grad_prb_fused, each block adds its frames without atomics into a
// block-owned partial (t, m, p, p) in scratch sized by the grid (each pixel
// of it always by the same thread), and sum_block_partials adds the partials
// over the blocks in a fixed order.
//
// Two kernels compute it; the wrapper picks one from the shapes alone.
//
// The FFT variant (adj_probe_fft_kernel; detector side 16, 32, 64 or 128).
// One frame, one block: the d x d farplane frame is loaded into dynamic
// shared memory with 16-byte coalesced loads (140,288 bytes at 128^2, one
// block per SM), transformed in place by dft_frame.cuh fft2_frame, whose
// last two passes produce only the p x p crop, and multiplied into the
// partial. No per-block scratch. What bounds it now: the one read of the
// farplane (8 bytes a pixel, 2.1 GB at 16384 frames of 128^2: 0.64 ms at
// 3.35 TB/s), whose latency one block per SM hides badly; then the sweeps
// over the frame in shared memory (the load, four inverse stages, the
// epilogue) and the partial's read and write in L2 (2 x 128 KiB a frame at
// 128^2). The FFT arithmetic (1.1 MFLOP a frame) is far below these. The
// frame is stored straight into the order the inverse transform takes
// (fft_far_index), so nothing is reordered afterwards.
//
// The GEMM variant (adj_probe_kernel; every other size): the two adjoint
// DFT products, d*p*(d+p) complex multiply-adds per frame and mode
// (5.5e11 fp32 FLOPs at 16384 frames of 128^2, 29 times what the FFT
// needs), on the SIMT fp32 units (dft_frame.cuh cgemm), with the p x d
// intermediate in per-block scratch.
//
// Contract (both variants): bitwise reproducible (fixed frame-to-block
// assignment, fixed order within a block and over the blocks).

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
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    for (int mm = 0; mm < m; ++mm) {
      const float2* fr = q.far + (f * m + mm) * dd;
      float2* out = mine + (static_cast<int64_t>(th) * m + mm) * pp;
      adjoint_frame_mode(
          [&](int u, int v) { return fr[u * d + v]; }, p, d, tw, a1,
          [&](int y, int x, float2 z) {
            const float2 g =
                cmul(conjf2(obj[static_cast<int64_t>(y) * q.n + x]), z);
            float2& a = out[y * p + x];
            a = make_float2(a.x + g.x, a.y + g.y);
          },
          sm);
    }
  }
}

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* far;   // (t, s, m, d, d)
  const float2* psi;   // (t, nz, n)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* acc;         // gridDim.x * (t*m*p*p) block partials
  int t, s, nz, n, m, p;
};

template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1) adj_probe_fft_kernel(FftParams q) {
  extern __shared__ float2 shared[];
  float2* tw = shared;    // e^{-2 pi i k / d}
  float2* tws = tw + kD;  // the same / d
  float2* fr = tws + kD;  // the frame

  const int p = q.p, m = q.m;
  const int64_t pp = static_cast<int64_t>(p) * p;
  constexpr int dd = kD * kD;
  float2* mine = q.acc + blockIdx.x * (q.t * m * pp);
  for (int64_t i = threadIdx.x; i < q.t * m * pp; i += kT) {
    mine[i] = make_float2(0.f, 0.f);
  }
  // Its closing barrier also orders the zeroing. Pixel i of a partial is
  // zeroed and added to by thread i mod kT alone.
  fft_load_twiddles<kD, kT>(tw, tws);

  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;  // block-uniform
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
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
      float2* out = mine + (static_cast<int64_t>(th) * m + mm) * pp;
      for (int i = threadIdx.x; i < p * p; i += kT) {
        const int y = i / p, x = i - y * p;
        const float2 g = cmul(conjf2(obj[static_cast<int64_t>(y) * q.n + x]),
                              fr[fft_near_index<kD>(y, x)]);
        float2& a = out[i];
        a = make_float2(a.x + g.x, a.y + g.y);
      }
      __syncthreads();  // the next load overwrites the frame
    }
  }
}

struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return adj_probe_fft_kernel<kD, kT>;
  }
};

// out = the sum of the `grid` block partials in `acc`, in a fixed order.
int sum_partials(const void* acc, void* out, int t, int m, int p, int grid,
                 cudaStream_t st) {
  const int64_t total = static_cast<int64_t>(t) * m * p * p;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  sum_block_partials<float2><<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(acc), static_cast<float2*>(out), total,
      grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the GEMM variant and the block sum on `stream` with `grid`
// blocks; returns the first cudaGetLastError() that is not 0 (0 on
// success). `acc` holds grid * t*m*p*p complex floats, `scratch` grid * p *
// d; `out` (t, m, p, p) receives the sum.
int tk_adj_probe(const void* far, const void* psi, const void* scan,
                 void* out, void* acc, void* scratch, int t, int s, int nz,
                 int n, int m, int p, int d, int grid, void* stream) {
  Params q{static_cast<const float2*>(far), static_cast<const float2*>(psi),
           static_cast<const int*>(scan), static_cast<float2*>(acc),
           static_cast<float2*>(scratch), t, s, nz, n, m, p, d};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  adj_probe_kernel<<<grid, kThreads, smem, st>>>(q);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_partials(acc, out, t, m, p, grid, st);
}

// Resident blocks per SM of the GEMM variant at detector side `d`
// (`has_base` is unused); returns the CUDA error code.
int tk_adj_probe_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, adj_probe_kernel, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) and the block sum on `stream` with `grid` blocks; returns the first
// CUDA error (0 on success). `acc` as in tk_adj_probe; there is no scratch.
int tk_adj_probe_fft(const void* far, const void* psi, const void* scan,
                     void* out, void* acc, int t, int s, int nz, int n,
                     int m, int p, int d, int grid, int threads,
                     void* stream) {
  FftParams q{static_cast<const float2*>(far),
              static_cast<const float2*>(psi), static_cast<const int*>(scan),
              static_cast<float2*>(acc), t, s, nz, n, m, p};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fft_launch<FftKernels>(q, d, threads, 0, grid, st);
  if (err) return err;
  return sum_partials(acc, out, t, m, p, grid, st);
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes (`has_base` and `planes` are unused: the kernel has neither);
// returns the CUDA error code.
int tk_adj_probe_fft_blocks_per_sm(int d, int has_base, int planes,
                                   int threads, int* out, int* smem_bytes) {
  (void)has_base;
  (void)planes;
  return fft_occupancy<FftKernels>(d, threads, 0, out, smem_bytes);
}

}  // extern "C"
