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
//   3. multiplies by conj(prb[m]), sums the modes and adds into the object
//      gradient at the position's window.
// Outputs grad = G^H(factor * far) (no factor 2) and per-block objective
// partials. Positions whose scan row is < 0 (masked dummies) contribute
// nothing, to the gradient or to the objective (the TPU kernel's `valid`);
// so do positions whose window leaves the object (invalid input).
//
// Two passes, as grad_fused.cu's: the frame kernel in this file does steps
// 1-2 for a chunk of frames and stores each cropped inverse frame into a
// scratch, and scatter_conj_probe.cu's tile kernel does step 3 in scan
// order, continuing from the running sums of the chunk before; the frame
// kernel runs every chunk with the grid of one launch on all frames and
// carries each thread's objective sum between the launches
// (dft_frame.cuh Range), so the gradient and the objective are the same
// bits whatever the chunk. On the FFT variant the inverse half is
// grad_fused's (the factor from the mode-summed intensity, the frame times
// it, fft2_frame, the crop), so adj_residual(fwd(psi)) gives
// grad_fused(psi)'s gradient bit for bit.
//
// Two kernels form the frames; the wrapper picks one from the shapes alone,
// as for grad_fused (ops/fused.py dft_variant).
//
// The FFT variant (adj_residual_fft_kernel; detector side 16, 32, 64 or
// 128). One frame per block, the complex frame in dynamic shared memory
// (one block per SM at 128^2), transformed in place by dft_frame.cuh
// fft2_frame. With one mode the farplane frame is loaded with 16-byte
// streaming loads, two neighbouring pixels a load, straight into the order
// the inverse transform takes (fft_far_index, as adj_probe.cu loads); in
// the same pass each thread reads its two measured pixels, coalesced, forms
// the factor and the objective and scales the frame in place. Then the
// inverse transform and the crop's store (dft_frame.cuh store_crop).
// (Fetching the measured frame a frame ahead with cp.async, as grad_fused
// does, gained nothing here -- 3.44 against 3.51 ms and 3.53 against 3.49
// ms at 16384 frames of 128^2 in two runs on an H100 80GB HBM3 at 700 W,
// PERF.md -- and was taken out: the 64 KiB of data are read in the same
// loop as the frame's 128 KiB.) With several modes each thread first sums
// the intensity of its pixels over the modes, read straight from device
// memory, turns it into the factor in a float plane in shared memory and
// sums the objective; then each mode's frame is loaded again, scaled by the
// plane, transformed and its crop stored. The farplane is read twice with several modes (the first read
// through L2 only, so that the second may find it there); a scratch buffer
// to avoid that is not built. What bounds it: the one read of the farplane
// and the data (8 + 4 bytes a pixel, 3.2 GB at 16384 frames of 128^2: 0.96
// ms at 3.35 TB/s), against the sweeps over the frame in shared memory (the
// load, four inverse stages, the crop's store). The FFT arithmetic (1.1
// MFLOP a frame) is far below these.
//
// The GEMM variant (adj_residual_kernel; every other size): the two adjoint
// DFT products, d*p*(d+p) complex multiply-adds per frame and mode (5.5e11
// fp32 FLOPs at 16384 frames of 128^2) on the SIMT fp32 units
// (dft_frame.cuh cgemm), which take far longer than the reads. The factor
// is kept as one d x d plane in per-block scratch and applied in the first
// product's tile loads, so the weighted farplane is never stored; the
// farplane itself is read straight from device memory, as in adj.cu.
//
// The atomic kernel (adj_residual_atomic_fft_kernel; FFT sizes) is the
// one-pass FFT kernel this design replaced: the same frames, then
// conj-probe multiply and scatter-add with fp32 atomics (dft_frame.cuh
// scatter_patch) into a zeroed gradient, deterministic only up to the
// order the atomics land. Only a caller that forces it (ops/fused.py,
// variant='atomic') launches it, to time the two designs in turns.
//
// Contract (both variants): with the tile kernel after them the gradient
// is bitwise repeatable, the same bits whatever the chunk; the objective is
// summed per thread and per block in double in a fixed order, then over the
// blocks in a fixed order by the caller: bitwise reproducible, whatever the
// chunk. It reads only the held farplane, so no other kernel need round it
// alike; its low bits differ between the two variants, whose blocks have
// other thread counts and visit the pixels in another order.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* far;   // (t, s, m, d, d)
  const float* data;   // (t, s, d, d)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* near;        // (g1 - g0, m, p, p): the range's cropped frames
  float* scratch;      // gridDim.x * stride floats: p x d complex, d x d real
  double* partial;     // gridDim.x objective partials
  int64_t stride;      // floats of scratch per block (even)
  int t, s, nz, n, m, p, d, model;
  Range r;
};

__global__ void __launch_bounds__(kThreads, 2) adj_residual_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  load_twiddles(tw, d);

  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t pp = static_cast<int64_t>(p) * p;
  float* mine = q.scratch + blockIdx.x * q.stride;
  float2* a1 = reinterpret_cast<float2*>(mine);             // p x d
  float* factor = mine + 2 * static_cast<int64_t>(p) * d;  // d x d
  double fsum = range_carry_in(q.r, kThreads);

  for (int64_t f = range_start(q.r); f < q.r.g1; f += gridDim.x) {
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

    for (int mm = 0; mm < m; ++mm) {
      const float2* fm = fr + mm * dd;
      float2* nr = q.near + ((f - q.r.g0) * m + mm) * pp;
      // Stage 2: the adjoint DFT of factor * far, cropped, into the range's
      // frames.
      adjoint_frame_mode(
          [&](int u, int v) {
            const int i = u * d + v;
            const float2 z = fm[i];
            return make_float2(z.x * factor[i], z.y * factor[i]);
          },
          p, d, tw, a1, [&](int y, int x, float2 z) { nr[y * p + x] = z; },
          sm);
    }
    // adjoint_frame_mode ends with a barrier: the next frame may overwrite
    // the factor plane.
  }

  range_carry_out<kThreads>(q.r, fsum, q.partial);
}

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* far;   // (t, s, m, d, d), 16-byte aligned
  const float* data;   // (t, s, d, d)
  const float2* prb;   // (t, m, p, p); the atomic kernel's only
  const int* scan;     // (t, s, 2) int (y, x)
  float2* near;        // (g1 - g0, m, p, p): the range's cropped frames
  float* grad;         // (t, nz, n) complex as interleaved re/im floats;
                       // the atomic kernel's output
  double* partial;     // gridDim.x objective partials
  int t, s, nz, n, m, p, model;
  Range r;
};

// One block per SM at 128^2 (the frame fills the shared memory): registers
// are capped at 65536 / kT. Thread j owns the pixel pairs (2i, 2i + 1),
// i = j, j + kT, ...: of the farplane, the data and the factor plane.
// kAtomic: scatter the conj-probe product into q.grad with atomics (the
// replaced design) instead of storing the crop.
template <int kD, int kT, bool kAtomic>
__device__ __forceinline__ void adj_residual_fft_body(const FftParams& q) {
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;    // e^{-2 pi i k / d}
  float2* tws = tw + kD;  // the same / d
  float2* fr = tws + kD;  // the frame
  // With several modes: the likelihood factor.
  float* plane = reinterpret_cast<float*>(fr + FftFrame<kD>::size);
  fft_load_twiddles<kD, kT>(tw, tws);

  const int p = q.p, m = q.m;
  constexpr int dd = kD * kD;
  const int64_t pp = static_cast<int64_t>(p) * p;
  double fsum = range_carry_in(q.r, kT);

  for (int64_t f = range_start(q.r); f < q.r.g1; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;  // block-uniform
    const float2* prb = kAtomic
                            ? q.prb + static_cast<int64_t>(th) * m * pp
                            : nullptr;
    const float* dat = q.data + f * dd;
    const float4* src = reinterpret_cast<const float4*>(q.far + f * m * dd);

    if (m == 1) {
      // Two neighbouring pixels a load; the farplane and the data are read
      // once, so they stream past the caches.
      for (int i = threadIdx.x; i < dd / 2; i += kT) {
        const float4 w = __ldcs(src + i);
        const float d0 = __ldcs(dat + 2 * i), d1 = __ldcs(dat + 2 * i + 1);
        float f0, f1;
        fsum += pixel_objective(q.model,
                                fft_intensity(make_float2(w.x, w.y)), d0,
                                &f0);
        fsum += pixel_objective(q.model,
                                fft_intensity(make_float2(w.z, w.w)), d1,
                                &f1);
        const int u = (2 * i) / kD, v = (2 * i) % kD;
        fr[fft_far_index<kD>(u, v)] = make_float2(w.x * f0, w.y * f0);
        fr[fft_far_index<kD>(u, v + 1)] = make_float2(w.z * f1, w.w * f1);
      }
      __syncthreads();
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      if constexpr (kAtomic) {
        scatter_patch<kD, kT>(fr, q.grad, th, q.nz, q.n, sy, sx, prb, p);
      } else {
        store_crop<kD, kT>(fr, q.near + (f - q.r.g0) * pp, p);
      }
      continue;
    }

    // Several modes: the factor of each pixel from its mode-summed
    // intensity, the first read through L2 only (it is read again below).
    for (int i = threadIdx.x; i < dd / 2; i += kT) {
      float i0 = 0.f, i1 = 0.f;
      for (int mm = 0; mm < m; ++mm) {
        const float4 w = __ldcg(src + mm * (dd / 2) + i);
        i0 += fft_intensity(make_float2(w.x, w.y));
        i1 += fft_intensity(make_float2(w.z, w.w));
      }
      fsum += pixel_objective(q.model, i0, __ldcs(dat + 2 * i), &plane[2 * i]);
      fsum += pixel_objective(q.model, i1, __ldcs(dat + 2 * i + 1),
                              &plane[2 * i + 1]);
    }
    // No barrier: each thread reads back only the plane entries it wrote,
    // and the last scatter_patch ended with one before the frame is loaded.
    for (int mm = 0; mm < m; ++mm) {
      for (int i = threadIdx.x; i < dd / 2; i += kT) {
        const float4 w = __ldcs(src + mm * (dd / 2) + i);
        const float f0 = plane[2 * i], f1 = plane[2 * i + 1];
        const int u = (2 * i) / kD, v = (2 * i) % kD;
        fr[fft_far_index<kD>(u, v)] = make_float2(w.x * f0, w.y * f0);
        fr[fft_far_index<kD>(u, v + 1)] = make_float2(w.z * f1, w.w * f1);
      }
      __syncthreads();
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      if constexpr (kAtomic) {
        scatter_patch<kD, kT>(fr, q.grad, th, q.nz, q.n, sy, sx,
                              prb + mm * pp, p);
      } else {
        store_crop<kD, kT>(fr, q.near + ((f - q.r.g0) * m + mm) * pp, p);
      }
    }
  }

  range_carry_out<kT>(q.r, fsum, q.partial);
}

template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1)
    adj_residual_fft_kernel(FftParams q) {
  adj_residual_fft_body<kD, kT, false>(q);
}

template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1)
    adj_residual_atomic_fft_kernel(FftParams q) {
  adj_residual_fft_body<kD, kT, true>(q);
}

struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return adj_residual_fft_kernel<kD, kT>;
  }
};

struct AtomicKernels {
  template <int kD, int kT>
  static auto get() {
    return adj_residual_atomic_fft_kernel<kD, kT>;
  }
};

}  // namespace

extern "C" {

// Launches the GEMM variant on `stream` with `grid` blocks on the frames
// [g0, g1) of the t * s; returns cudaGetLastError() (0 on success). The
// cropped inverse frames go to `near` ((g1 - g0) x m x p x p complex
// floats; masked frames are not written), `scratch` holds grid * stride
// floats with stride >= 2*p*d + d*d and even, `carry` grid * 256 doubles
// (read unless `first`, written unless `last`), `partial` grid doubles
// (written when `last`).
int tk_adj_residual(const void* far, const void* data, const void* scan,
                    void* near, void* scratch, void* partial, void* carry,
                    int t, int s, int nz, int n, int m, int p, int d,
                    int model, int64_t g0, int64_t g1, int first, int last,
                    int grid, int64_t stride, void* stream) {
  Params q{static_cast<const float2*>(far), static_cast<const float*>(data),
           static_cast<const int*>(scan), static_cast<float2*>(near),
           static_cast<float*>(scratch), static_cast<double*>(partial),
           stride, t, s, nz, n, m, p, d, model,
           Range{g0, g1, static_cast<double*>(carry), first, last}};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  adj_residual_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the GEMM variant at detector side `d`
// (`has_base` is unused); returns the CUDA error code.
int tk_adj_residual_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, adj_residual_kernel, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) on `stream` with `grid` blocks on the frames [g0, g1) of the t * s;
// returns the first CUDA error (0 on success). `far` is 16-byte aligned;
// `near`, `carry` (grid * threads doubles), `partial`, `first` and `last` as in
// tk_adj_residual; there is no other scratch.
int tk_adj_residual_fft(const void* far, const void* data, const void* scan,
                        void* near, void* partial, void* carry, int t, int s,
                        int nz, int n, int m, int p, int d, int model,
                        int64_t g0, int64_t g1, int first, int last,
                        int grid, int threads, void* stream) {
  FftParams q{static_cast<const float2*>(far),
              static_cast<const float*>(data), nullptr,
              static_cast<const int*>(scan), static_cast<float2*>(near),
              nullptr, static_cast<double*>(partial), t, s, nz, n, m, p,
              model,
              Range{g0, g1, static_cast<double*>(carry), first, last}};
  return fft_launch<FftKernels>(q, d, threads, m > 1 ? 1 : 0, grid,
                                static_cast<cudaStream_t>(stream));
}

// Launches the atomic kernel, the FFT variant's design before it stored
// frames, on all t * s frames: the whole gradient into `grad` (t, nz, n),
// which must be zeroed, and the objective partials. Returns the first CUDA
// error (0 on success).
int tk_adj_residual_atomic_fft(const void* far, const void* data,
                               const void* prb, const void* scan, void* grad,
                               void* partial, int t, int s, int nz, int n,
                               int m, int p, int d, int model, int grid,
                               int threads, void* stream) {
  FftParams q{static_cast<const float2*>(far),
              static_cast<const float*>(data),
              static_cast<const float2*>(prb), static_cast<const int*>(scan),
              nullptr, static_cast<float*>(grad),
              static_cast<double*>(partial), t, s, nz, n, m, p, model,
              Range{0, static_cast<int64_t>(t) * s, nullptr, 1, 1}};
  return fft_launch<AtomicKernels>(q, d, threads, m > 1 ? 1 : 0, grid,
                                   static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes, with `planes` (0 or 1) float planes beside the frame (one with
// several modes; `has_base` is unused); returns the CUDA error code.
int tk_adj_residual_fft_blocks_per_sm(int d, int has_base, int planes,
                                      int threads, int* out,
                                      int* smem_bytes) {
  (void)has_base;
  return fft_occupancy<FftKernels>(d, threads, planes, out, smem_bytes);
}

}  // extern "C"
