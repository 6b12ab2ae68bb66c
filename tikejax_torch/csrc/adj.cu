// adj: the far-field ptychography adjoint with respect to the object for
// NVIDIA Hopper (sm_90a), first stage: the inverse DFT of every frame,
// cropped, stored for scatter_conj_probe.cu's tile kernel, which sums them
// into the object in scan order.
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py adj (_adj_kernel), a
// deterministic overlap scatter-add. For every (angle, position, mode)
// frame of the farplane this file computes
//   near[t, s, m] = F^H far[t, s, m] conj(F),  F[u, y] = e^{-2 pi i u y / d}
//   / sqrt(d)
// (the unitary inverse DFT cropped to the top-left p x p patch) and stores
// it, without the probe, into a (t, s, m, p, p) scratch of frames; the
// wrapper (ops/fused.py) then launches scatter_conj_probe's tile kernel on
// that scratch, which forms sum_m conj(prb[m]) near[t, s, m] and adds it
// into the object at the position's window: out = sum over frames of
// T_s^H (conj(prb) * near). The wrapper takes the positions in chunks
// whose scratch stays within a fixed budget, and the tile kernel continues
// each chunk from the partial object the one before stored, so the sums
// are those of one pass, whatever the chunk. Positions whose scan row is
// < 0 (masked dummies) or whose window leaves the object (invalid input)
// are skipped: their frames are neither read nor written, and the tile
// kernel never reads them.
//
// Two kernels form the frames; the wrapper picks one from the shapes
// alone, as for the other DFT kernels (ops/fused.py dft_variant).
//
// The FFT variant (adj_fft_kernel; detector side 16, 32, 64 or 128) is
// adj_residual.cu's FFT tail without the likelihood: one frame per block,
// the complex frame in dynamic shared memory (140 KiB at 128^2, one block
// per SM), loaded with 16-byte streaming loads, two neighbouring pixels a
// load, straight into the order the inverse transform takes
// (fft_far_index); then dft_frame.cuh fft2_frame, and the p x p crop
// written out. With several modes each mode is loaded, transformed and
// stored in turn. What bounds it: the one read of the farplane and the one
// write of the crop (8 bytes a pixel each, 2.1 GB apiece at 16384 frames of
// 128^2: 0.64 ms each at 3.35 TB/s), against the sweeps over the frame in
// shared memory (the load, four inverse stages, the store). The FFT
// arithmetic (1.1 MFLOP a frame) is far below these.
//
// The GEMM variant (adj_kernel; every other size): the two adjoint DFT
// products, d*p*(d+p) complex multiply-adds per frame and mode, on the
// SIMT fp32 units (dft_frame.cuh cgemm), which take far longer than the
// read. The farplane is read straight from device memory by the first
// product's tile loads; the only per-block scratch is one p x d
// intermediate.
//
// The atomic kernel (adj_atomic_fft_kernel) is the FFT kernel this design
// replaced: the same transform, then conj-probe multiply and scatter-add
// with fp32 atomics (dft_frame.cuh scatter_add_pixel) into a zeroed object,
// deterministic only up to the order the atomics land. Only a caller that
// forces it (ops/fused.py, variant='atomic') launches it, to time the two
// designs in turns.
//
// Contract: with the tile kernel after it, adj is bitwise repeatable: each
// object pixel sums its positions' contributions in increasing scan order
// (the TPU kernel's order), whatever the chunk of positions.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* far;   // (t, s, m, d, d), angle th at far + th * st_t
  const int* scan;     // (t, s, 2) int (y, x)
  float2* near;        // (t, s, m, p, p), the cropped inverse frames
  float2* scratch;     // gridDim.x * (p*d)
  int t, s, nz, n, m, p, d;
  int64_t st_t;        // far's angle stride, complex elements
};

__global__ void __launch_bounds__(kThreads, 2) adj_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  load_twiddles(tw, d);

  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t pp = static_cast<int64_t>(p) * p;
  float2* a1 = q.scratch + blockIdx.x * static_cast<int64_t>(p) * d;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int64_t si = f - static_cast<int64_t>(th) * q.s;
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    for (int mm = 0; mm < m; ++mm) {
      const float2* fr = q.far + th * q.st_t + (si * m + mm) * dd;
      float2* nr = q.near + (f * m + mm) * pp;
      adjoint_frame_mode(
          [&](int u, int v) { return fr[u * d + v]; }, p, d, tw, a1,
          [&](int y, int x, float2 z) { nr[y * p + x] = z; }, sm);
    }
  }
}

// -- the FFT variant and the atomic kernel it replaced ----------------

struct FftParams {
  const float2* far;   // (t, s, m, d, d), 16-byte aligned; angle th at
                       // far + th * st_t
  const float2* prb;   // (t, m, p, p); the atomic kernel's only
  const int* scan;     // (t, s, 2) int (y, x)
  float2* near;        // (t, s, m, p, p); the FFT variant's output
  float* out;          // (t, nz, n) complex as interleaved re/im floats;
                       // the atomic kernel's output
  int t, s, nz, n, m, p;
  int64_t st_t;        // far's angle stride, complex elements
};

// One block per SM at 128^2 (the frame fills the shared memory): registers
// are capped at 65536 / kT. Thread j loads the farplane pixel pairs
// (2i, 2i + 1), i = j, j + kT, ... of every frame. kAtomic: scatter the
// conj-probe product with atomics (the replaced design) instead of storing
// the crop.
template <int kD, int kT, bool kAtomic>
__device__ __forceinline__ void adj_fft_body(const FftParams& q) {
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;    // e^{-2 pi i k / d}
  float2* tws = tw + kD;  // the same / d
  float2* fr = tws + kD;  // the frame
  fft_load_twiddles<kD, kT>(tw, tws);

  const int p = q.p, m = q.m;
  constexpr int dd = kD * kD;
  const int64_t pp = static_cast<int64_t>(p) * p;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int64_t si = f - static_cast<int64_t>(th) * q.s;
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;  // block-uniform
    for (int mm = 0; mm < m; ++mm) {
      // Two neighbouring pixels a load; the farplane is read once, so it
      // streams past the caches.
      const float4* src = reinterpret_cast<const float4*>(
          q.far + th * q.st_t + (si * m + mm) * dd);
      for (int i = threadIdx.x; i < dd / 2; i += kT) {
        const float4 w = __ldcs(src + i);
        const int u = (2 * i) / kD, v = (2 * i) % kD;
        fr[fft_far_index<kD>(u, v)] = make_float2(w.x, w.y);
        fr[fft_far_index<kD>(u, v + 1)] = make_float2(w.z, w.w);
      }
      __syncthreads();
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      if constexpr (kAtomic) {
        // Ends with a barrier: the next mode's load may overwrite the
        // frame.
        scatter_patch<kD, kT>(
            fr, q.out, th, q.nz, q.n, sy, sx,
            q.prb + (static_cast<int64_t>(th) * m + mm) * pp, p);
      } else {
        // Ends with a barrier: the next mode's load overwrites the frame.
        store_crop<kD, kT>(fr, q.near + (f * m + mm) * pp, p);
      }
    }
  }
}

template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1) adj_fft_kernel(FftParams q) {
  adj_fft_body<kD, kT, false>(q);
}

template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1) adj_atomic_fft_kernel(FftParams q) {
  adj_fft_body<kD, kT, true>(q);
}

struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return adj_fft_kernel<kD, kT>;
  }
};

struct AtomicKernels {
  template <int kD, int kT>
  static auto get() {
    return adj_atomic_fft_kernel<kD, kT>;
  }
};

}  // namespace

extern "C" {

// Launches the GEMM variant on `stream` with `grid` blocks: the cropped
// inverse frames of the (t, s) positions of `far` (angle stride st_t
// complex elements) into `near` (t, s, m, p, p); returns
// cudaGetLastError() (0 on success). `scratch` holds grid * p * d complex
// floats.
int tk_adj(const void* far, const void* scan, void* near, void* scratch,
           int t, int s, int nz, int n, int m, int p, int d, int64_t st_t,
           int grid, void* stream) {
  Params q{static_cast<const float2*>(far), static_cast<const int*>(scan),
           static_cast<float2*>(near), static_cast<float2*>(scratch),
           t, s, nz, n, m, p, d, st_t};
  if (static_cast<int64_t>(t) * s == 0) return 0;
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

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) on `stream` with `grid` blocks: the frames as tk_adj writes them;
// returns the first CUDA error (0 on success). `far` is 16-byte aligned (st_t
// even); there is no scratch.
int tk_adj_fft(const void* far, const void* scan, void* near, int t, int s,
               int nz, int n, int m, int p, int d, int64_t st_t, int grid,
               int threads, void* stream) {
  FftParams q{static_cast<const float2*>(far), nullptr,
              static_cast<const int*>(scan), static_cast<float2*>(near),
              nullptr, t, s, nz, n, m, p, st_t};
  if (static_cast<int64_t>(t) * s == 0) return 0;
  return fft_launch<FftKernels>(q, d, threads, 0, grid,
                                static_cast<cudaStream_t>(stream));
}

// Launches the atomic kernel, the FFT variant's design before it stored
// frames: the whole adjoint into `out` (t, nz, n), which must be zeroed;
// `far` contiguous (t, s, m, d, d) and 16-byte aligned. Returns the first
// CUDA error (0 on success).
int tk_adj_atomic_fft(const void* far, const void* prb, const void* scan,
                      void* out, int t, int s, int nz, int n, int m, int p,
                      int d, int grid, int threads, void* stream) {
  FftParams q{static_cast<const float2*>(far),
              static_cast<const float2*>(prb), static_cast<const int*>(scan),
              nullptr, static_cast<float*>(out), t, s, nz, n, m, p,
              static_cast<int64_t>(s) * m * d * d};
  if (static_cast<int64_t>(t) * s == 0) return 0;
  return fft_launch<AtomicKernels>(q, d, threads, 0, grid,
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
