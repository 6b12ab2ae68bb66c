// minf_fused: the far-field ptychography objective in one kernel pass,
// with nothing farplane-sized in memory, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py minf_fused
// (_minf_kernel): the forward half of grad_fused and the objective only.
// For every (angle, position) frame it computes, per mode,
//   far = F (psi[y:y+p, x:x+p] * prb[m]) F^T  (+ base[t, s, m])
// (the unitary DFT of the zero-padded patch; the split-operator base frame
// is added as in grad_fused), sums |far|^2 over the modes into the frame's
// intensity and reduces the per-pixel objective against the measured frame
// (dft_frame.cuh pixel_objective). Positions whose scan row is < 0 (masked
// dummies) or whose window leaves the object contribute nothing.
//
// Two kernels compute it; the wrapper picks one from the shapes alone, the
// same way for grad_fused, grad_prb_fused and this one: a line search
// compares this kernel's objective with theirs, so the three compute a
// frame's farplane with the same arithmetic (dft_frame.cuh, "the forward
// half of a frame"). Within the FFT variant the wrapper picks one of two
// bodies, also from the shapes alone, as it does for grad_fused
// (ops/fused.py fft_body).
//
// The FFT variant's fused body (minf_fused_regs_kernel; detector side 128,
// one mode: the joint cell's line-search candidates) is grad_fused.cu
// grad_fused_regs_kernel's forward half, built from the same helpers
// (dft_frame.cuh, "the frame's FFT with fewer trips through shared
// memory"): the forward row pass takes psi * prb from device memory straight
// into registers, each warp owning four rows; a barrier; the forward column
// pass's first stage; a barrier; then one forward-only step on a thread's
// 16 points of a column (fft_col_forward): the column pass's second stage
// and the likelihood (plus the base) against the measured frame, fetched a
// frame ahead with cp.async and swizzled as in grad_fused, with nothing
// written back; a barrier before the next frame's row pass. A frame makes
// 6 one-way sweeps of its 128 KiB through shared memory and 3 block
// barriers (the shared-memory body about 10 and 6: the gather's write, four
// fft2_frame stages of a read and a write each, the likelihood's read). What
// bounds it now, as grad_fused's fused body after its change (PERF.md): the
// row pass's gather of 256 KiB a frame of object and probe from the L2,
// which one block per SM (the 140 KiB frame and the 64 KiB staged data)
// cannot overlap with another frame's column work; then the likelihood's
// square roots or logarithm on the special-function units and the read of
// the measured frame (64 KiB a frame, and the base's 128 KiB where there is
// one). The same bits as the shared-memory body and as grad_fused's fused
// body: each thread sums its 16 pixels in the order the shared-memory
// body's thread of the same slot does, a frame's sum at a time, and the
// block sums the slots in grad_fused_regs_kernel's order (block_sum_store_n
// over the slot, as its range_carry_out does); the caller sums the blocks'
// partials in a fixed order, on the same grid as grad_fused's.
//
// The FFT variant's shared-memory body (minf_fused_fft_kernel; detector
// side 16, 32, 64 or 128; every size but 128 with one mode, and forced
// there only by a caller that times or compares the two bodies:
// ops/fused.py variant='fft_smem') is grad_fused's shared-memory forward
// half: one frame per block, the complex frame in dynamic shared memory,
// dft_frame.cuh fft2_frame in place, the measured frame fetched a frame
// ahead with cp.async (one mode) or read once, coalesced; with several
// modes the intensity is summed in a float plane in shared memory. No
// scratch in device memory. What bounds it: the sweeps over the frame in
// shared memory (gather, four FFT stages, the likelihood pass) and the one
// read of the data.
//
// The GEMM variant (minf_fused_kernel; every other size): the two forward
// DFT products, d*p*(d+p) complex multiply-adds per frame and mode (5.5e11
// fp32 FLOPs at 16384 frames of 128^2, half of grad_fused's) on the SIMT
// fp32 units, against one read of the data (and of the base); per-block
// scratch is one p x d intermediate plus one d x d intensity plane.
//
// The kernel exists so that a line-search candidate or an Anderson
// safeguard candidate costs no farplane.
//
// Contract (both variants): the objective is summed per thread and per
// block in double in a fixed order, then over the blocks in a fixed order
// by the caller, so it is bitwise reproducible.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* psi;  // (t, nz, n)
  const float2* prb;  // (t, m, p, p)
  const float* data;  // (t, s, d, d)
  const int* scan;    // (t, s, 2) int (y, x)
  float* scratch;     // gridDim.x * stride floats: p x d complex, d x d real
  double* partial;    // gridDim.x objective partials
  const float2* base;  // (t, s, m, d, d), read only when kBase
  int64_t stride;     // floats of scratch per block (even)
  int t, s, nz, n, m, p, d, model;
};

template <bool kBase>
__global__ void __launch_bounds__(kThreads, 2) minf_fused_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  load_twiddles(tw, d);

  const int64_t dd = static_cast<int64_t>(d) * d;
  float* mine = q.scratch + blockIdx.x * q.stride;
  float2* a1 = reinterpret_cast<float2*>(mine);    // p x d
  float* inten = mine + 2 * static_cast<int64_t>(p) * d;  // d x d
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  double fsum = 0.0;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    const float* dat = q.data + f * dd;

    for (int mm = 0; mm < m; ++mm) {
      const int64_t b0 = (f * m + mm) * dd;
      // Each pixel's intensity is written by one thread per mode, and
      // cgemm's closing barrier orders the modes.
      forward_frame_mode(obj, q.n, prb + static_cast<int64_t>(mm) * p * p,
                         p, d, tw, a1,
                         [&](int u, int v, float2 z) {
                           if constexpr (kBase) {
                             const float2 b = base_at(q.base, b0 + u * d + v);
                             z.x += b.x;
                             z.y += b.y;
                           }
                           const float i2 = z.x * z.x + z.y * z.y;
                           float& dst = inten[u * d + v];
                           dst = mm == 0 ? i2 : dst + i2;
                         },
                         sm);
    }
    for (int64_t i = threadIdx.x; i < dd; i += kThreads) {
      float factor;
      fsum += pixel_objective(q.model, inten[i], dat[i], &factor);
    }
    __syncthreads();  // the next frame overwrites inten
  }

  block_sum_store(fsum, q.partial + blockIdx.x);
}

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const float* data;   // (t, s, d, d)
  const int* scan;     // (t, s, 2) int (y, x)
  double* partial;     // gridDim.x objective partials
  const float2* base;  // (t, s, m, d, d), read only when kBase
  int t, s, nz, n, m, p, model;
  int prefetch;  // one mode only: fetch the next measured frame ahead
};

template <int kD, int kT, bool kBase>
__global__ void __launch_bounds__(kT, 1) minf_fused_fft_kernel(FftParams q) {
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;    // e^{-2 pi i k / d}
  float2* tws = tw + kD;  // the same / d
  float2* fr = tws + kD;  // the frame
  // With several modes: the mode-summed intensity. With one mode and
  // q.prefetch: the measured frame, fetched ahead.
  float* plane = reinterpret_cast<float*>(fr + FftFrame<kD>::size);
  fft_load_twiddles<kD, kT>(tw, tws);

  const int p = q.p, m = q.m;
  constexpr int dd = kD * kD;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  double fsum = 0.0;
  int64_t fetched = -1;  // the frame whose data `plane` holds or awaits

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;  // block-uniform
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    const float* dat = q.data + f * dd;
    const float2* base = kBase ? q.base + f * m * dd : nullptr;

    if (m == 1) {
      if (q.prefetch && fetched != f) {  // the block's first frame
        fft_fetch_data<kD, kT>(plane, dat);
      }
      fsum += fft_forward_one_mode<kD, kT, kBase, false>(
          fr, tw, tws, obj, q.n, prb, p, base, dat,
          q.prefetch ? plane : nullptr, q.model);
      if (q.prefetch) {
        fetched = fft_next_frame(q.scan, f, frames, q.nz, q.n, p);
        if (fetched < frames) {
          fft_fetch_data<kD, kT>(plane, q.data + fetched * dd);
        }
      }
    } else {
      fsum += fft_forward_modes<kD, kT, kBase>(fr, plane, tw, tws, obj, q.n,
                                               prb, m, p, base, dat, q.model);
    }
  }

  block_sum_store_n<kT>(fsum, q.partial + blockIdx.x);
}

// The fused body: d = 128, one mode, 1024 threads; grad_fused.cu
// grad_fused_regs_kernel's forward half (dft_frame.cuh, "the frame's FFT
// with fewer trips through shared memory"). Thread t's column task is
// k1 = t / 128 on the column of frequency v = fft_regs_freq(t % 128); it
// sums the objective of the pixels (k1 + 8 j, v), j = 0..15, in that order,
// a frame's sum at a time, and keeps it in slot k1 * 128 + v for the
// block's closing sum, as grad_fused_regs_kernel does: the objective is the
// shared-memory body's and grad_fused's, bit for bit.
template <bool kBase, bool kPrefetch>
__global__ void __launch_bounds__(1024, 1)
    minf_fused_regs_kernel(FftParams q) {
  constexpr int kD = 128, kT = 1024;
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;     // e^{-2 pi i k / d}: the column passes
  float2* tws = tw + kD;   // the same / d
  float2* twr = tws + kD;  // tws in the forward row pass's order
  float2* twi = twr + kD;  // the inverse row pass's order: unused here
  float2* fr = twi + kD;   // the frame
  // With kPrefetch: the measured frame, fetched ahead (fft_staged_index).
  float* plane = reinterpret_cast<float*>(fr + FftFrame<kD>::size);
  fft_load_twiddles<kD, kT>(tw, tws);
  fft_regs_row_twiddles<kT>(tws, twr, twi);
  auto col_at = [](int c, int e) {
    return e * FftFrame<kD>::pitch + fft_col(c);
  };

  const int p = q.p, model = q.model;
  constexpr int dd = kD * kD;
  const int64_t pp = static_cast<int64_t>(p) * p;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  const int k1 = threadIdx.x / kD, v = fft_regs_freq(threadIdx.x % kD);
  const int c = fft_pos<kD>(v), slot = k1 * kD + v;
  double fsum = 0.0;
  int64_t fetched = -1;  // the frame whose data `plane` holds or awaits

  // Each frame's scan entry is read a frame ahead, so that its latency
  // hides behind the frame before.
  int64_t f = blockIdx.x;
  int sy = -1, sx = 0;
  if (f < frames) sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
  while (f < frames) {
    const int64_t next = f + gridDim.x;
    int next_y = -1, next_x = 0;
    if (next < frames) next_y = q.scan[2 * next], next_x = q.scan[2 * next + 1];
    if (frame_valid(sy, sx, q.nz, q.n, p)) {  // block-uniform
      const int th = static_cast<int>(f / q.s);
      const float2* obj =
          q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
      const float* dat = q.data + f * dd;
      const float2* base = kBase ? q.base + f * dd : nullptr;
      if (kPrefetch && fetched != f) {  // the block's first frame
        fft_fetch_data_swizzled<kT>(plane, dat);
      }

      fft_rows_forward_regs(fr, obj, q.n, q.prb + th * pp, p, twr);
      __syncthreads();
      fft_lines_forward_stage1<kD, kT>(fr, col_at, kD, p, tw);
      if (kPrefetch) cp_async_wait_all();
      __syncthreads();
      double sum = 0.0;
      fft_col_forward(fr, c, k1, [&](int j, float2 z) {
        const int i = (k1 + 8 * j) * kD + v;
        if constexpr (kBase) {  // fft_add_base, the base streamed (__ldcs)
          const float2 b = __ldcs(base + i);
          z.x += b.x;
          z.y += b.y;
        }
        float factor;
        sum += pixel_objective(
            model, fft_intensity(z),
            kPrefetch ? plane[fft_staged_index(i)] : __ldcs(dat + i),
            &factor);
      });
      fsum += sum;
      __syncthreads();  // the next frame overwrites the frame and the plane
      if (kPrefetch) {
        fetched = next >= frames || frame_valid(next_y, next_x, q.nz, q.n, p)
                      ? next
                      : fft_next_frame(q.scan, next, frames, q.nz, q.n, p);
        if (fetched < frames) {
          fft_fetch_data_swizzled<kT>(plane, q.data + fetched * dd);
        }
      }
    }
    f = next, sy = next_y, sx = next_x;
  }

  block_sum_store_n<kT>(fsum, q.partial + blockIdx.x, slot);
}

// The fused body's instantiation for a base or none, with the data prefetch
// or without.
template <class Fn>
int fft_regs_dispatch(bool base, bool prefetch, Fn fn) {
  if (base) {
    return prefetch ? fn(minf_fused_regs_kernel<true, true>)
                    : fn(minf_fused_regs_kernel<true, false>);
  }
  return prefetch ? fn(minf_fused_regs_kernel<false, true>)
                  : fn(minf_fused_regs_kernel<false, false>);
}

template <bool kBase>
struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return minf_fused_fft_kernel<kD, kT, kBase>;
  }
};

}  // namespace

extern "C" {

// Launches the GEMM variant on `stream` with `grid` blocks; returns
// cudaGetLastError() (0 on success). `scratch` holds grid * stride floats
// with stride >= 2*p*d + d*d and even, `partial` grid doubles. A null
// `base` means no base; otherwise it is the contiguous complex64 base
// farplane (t, s, m, d, d).
int tk_minf_fused(const void* psi, const void* prb, const void* data,
                  const void* scan, void* scratch, void* partial,
                  const void* base, int t, int s, int nz, int n, int m, int p,
                  int d, int model, int grid, int64_t stride, void* stream) {
  Params q{static_cast<const float2*>(psi), static_cast<const float2*>(prb),
           static_cast<const float*>(data), static_cast<const int*>(scan),
           static_cast<float*>(scratch), static_cast<double*>(partial),
           static_cast<const float2*>(base), stride, t, s, nz, n, m, p, d,
           model};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (base != nullptr) {
    minf_fused_kernel<true><<<grid, kThreads, smem, st>>>(q);
  } else {
    minf_fused_kernel<false><<<grid, kThreads, smem, st>>>(q);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the GEMM variant at detector side `d` (with or
// without a base); returns the CUDA error code.
int tk_minf_fused_blocks_per_sm(int d, int has_base, int* out) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  if (has_base) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, minf_fused_kernel<true>, kThreads, smem));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, minf_fused_kernel<false>, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) on `stream` with `grid` blocks; returns the first CUDA error (0 on
// success). `partial` holds grid doubles; there is no scratch. `base` as in
// tk_minf_fused. `prefetch` != 0 (one mode only, `data` 16-byte aligned)
// fetches each measured frame a frame ahead.
int tk_minf_fused_fft(const void* psi, const void* prb, const void* data,
                      const void* scan, void* partial, const void* base,
                      int t, int s, int nz, int n, int m, int p, int d,
                      int model, int prefetch, int grid, int threads,
                      void* stream) {
  if (prefetch && m != 1) return static_cast<int>(cudaErrorInvalidValue);
  FftParams q{static_cast<const float2*>(psi),
              static_cast<const float2*>(prb),
              static_cast<const float*>(data), static_cast<const int*>(scan),
              static_cast<double*>(partial),
              static_cast<const float2*>(base), t, s, nz, n, m, p, model,
              prefetch};
  const int planes = m > 1 || prefetch ? 1 : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return base != nullptr
             ? fft_launch<FftKernels<true>>(q, d, threads, planes, grid, st)
             : fft_launch<FftKernels<false>>(q, d, threads, planes, grid, st);
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes, with `planes` (0 or 1) float planes beside the frame; returns
// the CUDA error code.
int tk_minf_fused_fft_blocks_per_sm(int d, int has_base, int planes,
                                    int threads, int* out, int* smem_bytes) {
  return has_base
             ? fft_occupancy<FftKernels<true>>(d, threads, planes, out,
                                               smem_bytes)
             : fft_occupancy<FftKernels<false>>(d, threads, planes, out,
                                                smem_bytes);
}

// Launches the fused body of the FFT variant (d = 128, one mode, 1024
// threads: anything else is cudaErrorInvalidValue) with the arguments of
// tk_minf_fused_fft; the same objective partials, bit for bit.
int tk_minf_fused_fft_regs(const void* psi, const void* prb, const void* data,
                           const void* scan, void* partial, const void* base,
                           int t, int s, int nz, int n, int m, int p, int d,
                           int model, int prefetch, int grid, int threads,
                           void* stream) {
  if (d != 128 || m != 1 || threads != 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FftParams q{static_cast<const float2*>(psi),
              static_cast<const float2*>(prb),
              static_cast<const float*>(data), static_cast<const int*>(scan),
              static_cast<double*>(partial),
              static_cast<const float2*>(base), t, s, nz, n, m, p, model,
              prefetch};
  const size_t smem = fft_regs_smem_bytes(prefetch ? 1 : 0);
  return fft_regs_dispatch(base != nullptr, prefetch, [&](auto kernel) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(q);
    return static_cast<int>(cudaGetLastError());
  });
}

// Resident blocks per SM of the fused body and its dynamic shared memory in
// bytes, as tk_minf_fused_fft_blocks_per_sm.
int tk_minf_fused_fft_regs_blocks_per_sm(int d, int has_base, int planes,
                                         int threads, int* out,
                                         int* smem_bytes) {
  if (d != 128 || threads != 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fft_regs_smem_bytes(planes);
  *smem_bytes = static_cast<int>(smem);
  return fft_regs_dispatch(has_base, planes > 0, [&](auto kernel) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, threads, smem));
  });
}

}  // extern "C"
