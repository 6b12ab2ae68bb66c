// grad_fused: the object gradient and the objective of far-field
// ptychography in one kernel pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py grad_fused
// (_grad_kernel). For every (angle, position, mode) frame it computes
//   1. near = psi[y:y+p, x:x+p] * prb[m]                       (p x p)
//   2. far  = F near F^T (+ base[t, s, m]), F[u, y] =
//      e^{-2 pi i u y / d} / sqrt(d) (d x p) -- the unitary DFT of the
//      patch zero-padded at the top left; in split-operator mode the frozen
//      base farplane is added here, before the likelihood (the TPU
//      kernel's base epilogue, pallas_fused.py:1239-1249);
//   3. the likelihood factor and objective from the mode-summed
//      intensity (dft_frame.cuh pixel_objective);
//   4. adj = F^H (factor * far) conj(F), cropped to the p x p patch;
//   5. conj(prb[m]) * adj, summed over modes and added into the object
//      gradient at the position's window.
// Outputs grad = G^H(factor * (G psi + base)) (no factor 2) and per-block
// objective partials. Positions whose scan row is < 0 (masked dummies)
// contribute nothing; so do out-of-bounds positions (invalid input: the
// kernel never reads or writes outside the object).
//
// Two passes, as adj.cu's: the frame kernel in this file does steps 1-4
// for a chunk of frames and stores each cropped inverse frame (t, s, m, p,
// p order, without the probe) into a scratch; scatter_conj_probe.cu's tile
// kernel then does step 5 on the scratch, each object pixel summing its
// positions in increasing scan order (the TPU kernel's "deterministic
// overlap scatter-add", pallas_fused.py:28), continuing from the running
// sums of the chunk before. The wrapper (ops/fused.py) takes the frames in
// chunks of consecutive frames (angle-major, as the frame loop numbers
// them) whose scratch stays within a fixed budget, and launches the frame
// kernel on each chunk with the grid of one launch on all frames: block b
// takes frames b, b + grid, ... of the chunk, so it visits the frames of
// one launch in the same order, and each thread carries its objective sum
// from one chunk's launch to the next in `carry`. So the gradient and the
// objective are the same bits whatever the chunk, and the objective is
// minf_fused's, bit for bit.
//
// Two kernels form the frames; the wrapper picks one from the shapes alone,
// and within the FFT variant one of two bodies, also from the shapes alone.
//
// The FFT variant's fused body (grad_fused_regs_kernel; detector side 128,
// one mode: every cell of the benchmark). The same arithmetic in the same
// order as the shared-memory body below, stage for stage, in fewer trips
// through shared memory (dft_frame.cuh, "the frame's FFT with fewer
// trips"): the gather goes straight from device memory into the forward
// row pass's registers, the forward column pass's second stage, the
// likelihood and the inverse column pass's first stage are one step on a
// thread's 16 points, and the crop is stored from the inverse row pass's
// registers. A frame makes 12 one-way sweeps of its 128 KiB through shared
// memory (the shared-memory body about 20) and 4 block barriers (about 12);
// the exchanges inside a row pass are __syncwarp, each warp owning four
// rows. What bounds it now (PERF.md, patched builds on an H100): the row
// passes, about 40% of its time, and of them the device-memory traffic --
// the gather's 256 KiB a frame of object and probe from the L2 and the
// crop's 128 KiB store -- which one block per SM (213 KiB of shared memory)
// cannot overlap with another frame's column passes; then the likelihood's
// square roots and division on the special-function units; the 12 sweeps
// (about 6.6 us a frame at the SM's shared-memory bandwidth) and the FFT
// arithmetic (2.3 MFLOP a frame) come after. The streamed traffic -- the
// measured frame, the base, the crop -- is tagged to leave the L2 first, so
// that the object and the probe, which every frame reads, stay in it.
// The gradient and the objective are the shared-memory body's bits: each
// thread sums its 16 pixels of the objective in the order that body's
// thread of the same slot does, and carries the sum in that slot; the
// weighted pixel is rounded before the inverse butterflies as that body's
// stored one is. The measured frame is still fetched a frame ahead with
// cp.async (swizzled, so the fused step's reads fall on 32 banks).
//
// The FFT variant's shared-memory body (grad_fused_fft_kernel; detector
// side 16, 32, 64 or 128; every size but 128 with one mode, and forced
// there only by a caller that times or compares the two bodies:
// ops/fused.py variant='fft_smem').
// One frame, one block, the whole complex frame in dynamic shared memory
// (140,288 bytes at 128^2, so one block per SM), transformed in place by
// dft_frame.cuh fft2_frame. Nothing farplane-sized and no per-block scratch
// in device memory beside the frame scratch. What bounds it: (a) the sweeps
// over the frame in shared memory -- gather, four FFT stages, the
// likelihood pass, four inverse stages, the crop's store: about ten reads
// and writes of 128 KiB a frame; (b) the one read of the measured frame
// from device memory (64 KiB a frame), whose latency one block per SM hides
// badly; (c) the crop's write (8 bytes a patch pixel and mode), which a
// chunk small enough for the 50 MB L2 keeps out of device memory, since
// the tile kernel reads it right after and the next chunk overwrites the
// same lines. The FFT arithmetic (2.3 MFLOP a frame) is far below these.
// The one-pass kernel this design replaced scattered with fp32 atomics
// instead (about 0.69 ms of 4.7 at the headline, PERF.md); it stays as the
// atomic kernel below, forced only by a caller that times the two. What
// the design does about them: each FFT stage is one in-place sweep with the
// butterflies in registers and conflict-free shared accesses (see
// dft_frame.cuh); the zero padding is never written and the rows it fills
// are never transformed; the measured frame is read once, coalesced, in the
// pass that needs it -- with one mode it is already in shared memory by
// then: the next frame's 64 KiB are fetched with cp.async into the room
// beside the frame while this frame's inverse transform, crop store and the
// next gather and forward transform run. With several modes the intensity is
// summed over the modes into a float plane in shared memory, which then
// holds the likelihood factor, and each mode's farplane is computed a second
// time for the adjoint: an FFT costs less than a round trip through device
// memory would.
//
// The GEMM variant (grad_fused_kernel; every other size). The four DFT
// products are 2*d*p*(d+p) complex multiply-adds per frame and mode --
// 1.1e12 fp32 FLOPs per evaluation at 16384 frames of 128^2, 29 times what
// the FFT needs -- all on the SIMT fp32 units (dft_frame.cuh cgemm). The
// two p x d / d x d intermediates of a frame live in per-block scratch
// sized by the grid, never by the number of positions; no farplane is ever
// materialised.
//
// The atomic kernel (grad_fused_atomic_fft_kernel; FFT sizes, no base) is
// the one-pass FFT kernel this design replaced: the same frames, then
// conj-probe multiply and scatter-add with fp32 atomics (dft_frame.cuh
// scatter_patch) into a zeroed gradient, deterministic only up to the
// order the atomics land. Only a caller that forces it (ops/fused.py,
// variant='atomic') launches it, to time the two designs in turns.
//
// The base adds one farplane read (8 bytes a pixel) per evaluation. Without
// a base each kernel is the instantiation kBase = false.
//
// Contract (both variants): with the tile kernel after them the gradient
// is bitwise repeatable, the same bits whatever the chunk; the objective
// is summed per thread and per block in double in a fixed order, then over
// the blocks in a fixed order by the caller, so it is bitwise reproducible,
// the same bits whatever the chunk.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const float* data;   // (t, s, d, d)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* near;        // (g1 - g0, m, p, p): the range's cropped frames
  float2* scratch;     // gridDim.x * (m*p*d + m*d*d)
  double* partial;     // gridDim.x objective partials
  const float2* base;  // (t, s, m, d, d), read only when kBase
  int t, s, nz, n, m, p, d, model;
  Range r;
};

// Two resident blocks per SM: caps registers at 128 per thread.
template <bool kBase>
__global__ void __launch_bounds__(kThreads, 2)
    grad_fused_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;

  const int p = q.p, d = q.d, m = q.m;
  load_twiddles(tw, d);

  const int64_t pd = static_cast<int64_t>(p) * d;
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t pp = static_cast<int64_t>(p) * p;
  float2* s1 = q.scratch + blockIdx.x * (m * pd + m * dd);  // m x (p x d)
  float2* s2 = s1 + m * pd;                                 // m x (d x d)
  double fsum = range_carry_in(q.r, kThreads);

  for (int64_t f = range_start(q.r); f < q.r.g1; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    const float* dat = q.data + f * dd;

    for (int mm = 0; mm < m; ++mm) {
      float2* a2 = s2 + mm * dd;
      const int64_t b0 = (f * m + mm) * dd;
      // Stages 1-2: a2 = the farplane of this mode (+ the base frame).
      forward_frame_mode(obj, q.n, prb + static_cast<int64_t>(mm) * p * p,
                         p, d, tw, s1 + mm * pd,
                         [&](int u, int v, float2 z) {
                           if constexpr (kBase) {
                             const float2 b = base_at(q.base, b0 + u * d + v);
                             z.x += b.x;
                             z.y += b.y;
                           }
                           a2[u * d + v] = z;
                         },
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
      float2* nr = q.near + ((f - q.r.g0) * m + mm) * pp;
      // Stages 3-4: the adjoint DFT of the weighted farplane, cropped,
      // into the range's frames.
      adjoint_frame_mode(
          [&](int u, int v) { return a2[u * d + v]; }, p, d, tw, s1 + mm * pd,
          [&](int y, int x, float2 z) { nr[y * p + x] = z; }, sm);
    }
  }

  range_carry_out<kThreads>(q.r, fsum, q.partial);
}

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const float* data;   // (t, s, d, d)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* near;        // (g1 - g0, m, p, p): the range's cropped frames
  float* grad;         // (t, nz, n) complex as interleaved re/im floats;
                       // the atomic kernel's output
  double* partial;     // gridDim.x objective partials
  const float2* base;  // (t, s, m, d, d), read only when kBase
  int t, s, nz, n, m, p, model;
  int prefetch;  // one mode only: fetch the next measured frame ahead
  Range r;
};

// One block per SM at 128^2 (the frame fills the shared memory): registers
// are capped at 65536 / kT. kAtomic: scatter the conj-probe product into
// q.grad with atomics (the replaced design) instead of storing the crop.
template <int kD, int kT, bool kBase, bool kAtomic>
__device__ __forceinline__ void grad_fused_fft_body(const FftParams& q) {
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;       // e^{-2 pi i k / d}
  float2* tws = tw + kD;     // the same / d
  float2* fr = tws + kD;     // the frame
  // With several modes: the mode-summed intensity, then the factor. With
  // one mode and q.prefetch: the measured frame, fetched ahead.
  float* plane = reinterpret_cast<float*>(fr + FftFrame<kD>::size);
  fft_load_twiddles<kD, kT>(tw, tws);

  const int p = q.p, m = q.m;
  constexpr int dd = kD * kD;
  const int64_t pp = static_cast<int64_t>(p) * p;
  double fsum = range_carry_in(q.r, kT);
  int64_t fetched = -1;  // the frame whose data `plane` holds or awaits

  for (int64_t f = range_start(q.r); f < q.r.g1; f += gridDim.x) {
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
      fsum += fft_forward_one_mode<kD, kT, kBase, true>(
          fr, tw, tws, obj, q.n, prb, p, base, dat,
          q.prefetch ? plane : nullptr, q.model);
      if (q.prefetch) {
        fetched = fft_next_frame(q.scan, f, q.r.g1, q.nz, q.n, p);
        if (fetched < q.r.g1) {
          fft_fetch_data<kD, kT>(plane, q.data + fetched * dd);
        }
      }
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      if constexpr (kAtomic) {
        scatter_patch<kD, kT>(fr, q.grad, th, q.nz, q.n, sy, sx, prb, p);
      } else {
        store_crop<kD, kT>(fr, q.near + (f - q.r.g0) * pp, p);
      }
      continue;
    }

    fsum += fft_forward_modes<kD, kT, kBase>(fr, plane, tw, tws, obj, q.n,
                                             prb, m, p, base, dat, q.model);
    for (int mm = 0; mm < m; ++mm) {
      const float2* pr = prb + static_cast<int64_t>(mm) * p * p;
      fft_weighted_mode<kD, kT, kBase>(
          fr, plane, tw, tws, obj, q.n, pr, p,
          kBase ? base + static_cast<int64_t>(mm) * dd : nullptr);
      fft2_frame<kD, kT, true>(fr, p, tw, tws);
      if constexpr (kAtomic) {
        scatter_patch<kD, kT>(fr, q.grad, th, q.nz, q.n, sy, sx, pr, p);
      } else {
        store_crop<kD, kT>(fr, q.near + ((f - q.r.g0) * m + mm) * pp, p);
      }
    }
  }

  range_carry_out<kT>(q.r, fsum, q.partial);
}

template <int kD, int kT, bool kBase>
__global__ void __launch_bounds__(kT, 1) grad_fused_fft_kernel(FftParams q) {
  grad_fused_fft_body<kD, kT, kBase, false>(q);
}

template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1)
    grad_fused_atomic_fft_kernel(FftParams q) {
  grad_fused_fft_body<kD, kT, false, true>(q);
}

// The fused body: d = 128, one mode, 1024 threads (dft_frame.cuh, "the
// frame's FFT with fewer trips through shared memory"). Thread t's fused
// column task is k1 = t / 128 on the column of frequency v =
// fft_regs_freq(t % 128); it sums the objective of the pixels (k1 + 8 j, v),
// j = 0..15, in that order -- the pixels, and the order, that thread
// k1 * 128 + v of the shared-memory body sums -- and carries the sum in that
// slot, so the two bodies' objectives (and minf_fused's) are the same bits.
template <bool kBase, bool kPrefetch>
__global__ void __launch_bounds__(1024, 1)
    grad_fused_regs_kernel(FftParams q) {
  constexpr int kD = 128, kT = 1024;
  extern __shared__ __align__(16) float2 shared[];
  float2* tw = shared;     // e^{-2 pi i k / d}: the column passes
  float2* tws = tw + kD;   // the same / d: the row passes
  float2* twr = tws + kD;  // tws in the forward row pass's order
  float2* twi = twr + kD;  // tws in the inverse row pass's order
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
  const int64_t pp = static_cast<int64_t>(p) * p, g1 = q.r.g1;
  const int k1 = threadIdx.x / kD, v = fft_regs_freq(threadIdx.x % kD);
  const int c = fft_pos<kD>(v), slot = k1 * kD + v;
  double fsum = range_carry_in(q.r, kT, slot);
  int64_t fetched = -1;  // the frame whose data `plane` holds or awaits

  // Each frame's scan entry is read a frame ahead, so that its latency
  // hides behind the frame before.
  int64_t f = range_start(q.r);
  int sy = -1, sx = 0;
  if (f < g1) sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
  while (f < g1) {
    const int64_t next = f + gridDim.x;
    int next_y = -1, next_x = 0;
    if (next < g1) next_y = q.scan[2 * next], next_x = q.scan[2 * next + 1];
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
      fft_col_fused(fr, tw, c, k1, [&](int j, float2 z) {
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
        // __fmul_rn: never contracted into the inverse butterflies' adds,
        // so the weighted pixel rounds as the shared-memory body's stored
        // one.
        return make_float2(__fmul_rn(z.x, factor), __fmul_rn(z.y, factor));
      });
      fsum += sum;
      __syncthreads();
      if (kPrefetch) {
        fetched = next >= g1 || frame_valid(next_y, next_x, q.nz, q.n, p)
                      ? next
                      : fft_next_frame(q.scan, next, g1, q.nz, q.n, p);
        if (fetched < g1) {
          fft_fetch_data_swizzled<kT>(plane, q.data + fetched * dd);
        }
      }
      fft_lines_inverse_stage2<kD, kT>(fr, col_at, kD, p);
      __syncthreads();
      fft_rows_inverse_regs(fr, p, twi, q.near + (f - q.r.g0) * pp);
    }
    f = next, sy = next_y, sx = next_x;
  }

  range_carry_out<kT>(q.r, fsum, q.partial, slot);
}

// The fused body's instantiation for a base or none, with the data prefetch
// or without.
template <class Fn>
int fft_regs_dispatch(bool base, bool prefetch, Fn fn) {
  if (base) {
    return prefetch ? fn(grad_fused_regs_kernel<true, true>)
                    : fn(grad_fused_regs_kernel<true, false>);
  }
  return prefetch ? fn(grad_fused_regs_kernel<false, true>)
                  : fn(grad_fused_regs_kernel<false, false>);
}

template <bool kBase>
struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return grad_fused_fft_kernel<kD, kT, kBase>;
  }
};

struct AtomicKernels {
  template <int kD, int kT>
  static auto get() {
    return grad_fused_atomic_fft_kernel<kD, kT>;
  }
};

}  // namespace

extern "C" {

// Launches the GEMM variant on `stream` with `grid` blocks on the frames
// [g0, g1) of the t * s; returns cudaGetLastError() (0 on success). The
// cropped inverse frames go to `near` ((g1 - g0) x m x p x p complex
// floats; masked frames are not written), `scratch` holds grid *
// (m*p*d + m*d*d) complex floats, `carry` grid * 256 doubles (read unless
// `first`, written unless `last`), `partial` grid doubles (written when
// `last`). A null `base` means no base; otherwise it is the contiguous
// complex64 base farplane (t, s, m, d, d).
int tk_grad_fused(const void* psi, const void* prb, const void* data,
                  const void* scan, void* near, void* scratch, void* partial,
                  void* carry, const void* base, int t, int s, int nz, int n,
                  int m, int p, int d, int model, int64_t g0, int64_t g1,
                  int first, int last, int grid, void* stream) {
  Params q{static_cast<const float2*>(psi), static_cast<const float2*>(prb),
           static_cast<const float*>(data), static_cast<const int*>(scan),
           static_cast<float2*>(near), static_cast<float2*>(scratch),
           static_cast<double*>(partial), static_cast<const float2*>(base),
           t, s, nz, n, m, p, d, model,
           Range{g0, g1, static_cast<double*>(carry), first, last}};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (base != nullptr) {
    grad_fused_kernel<true><<<grid, kThreads, smem, st>>>(q);
  } else {
    grad_fused_kernel<false><<<grid, kThreads, smem, st>>>(q);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the GEMM variant at detector side `d` (with or
// without a base); returns the CUDA error code.
int tk_grad_fused_blocks_per_sm(int d, int has_base, int* out) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  if (has_base) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, grad_fused_kernel<true>, kThreads, smem));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, grad_fused_kernel<false>, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) on `stream` with `grid` blocks on the frames [g0, g1) of the t * s;
// returns the first CUDA error (0 on success). `near`, `carry` (grid * threads
// doubles), `partial`, `first` and `last` as in tk_grad_fused; there is no
// other scratch. `base` as in tk_grad_fused. `prefetch` != 0 (one mode only,
// `data` 16-byte aligned) fetches each measured frame a frame ahead.
int tk_grad_fused_fft(const void* psi, const void* prb, const void* data,
                      const void* scan, void* near, void* partial,
                      void* carry, const void* base, int t, int s, int nz,
                      int n, int m, int p, int d, int model, int prefetch,
                      int64_t g0, int64_t g1, int first, int last, int grid,
                      int threads, void* stream) {
  if (prefetch && m != 1) return static_cast<int>(cudaErrorInvalidValue);
  FftParams q{static_cast<const float2*>(psi),
              static_cast<const float2*>(prb),
              static_cast<const float*>(data), static_cast<const int*>(scan),
              static_cast<float2*>(near), nullptr,
              static_cast<double*>(partial),
              static_cast<const float2*>(base), t, s, nz, n, m, p, model,
              prefetch,
              Range{g0, g1, static_cast<double*>(carry), first, last}};
  const int planes = m > 1 || prefetch ? 1 : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return base != nullptr
             ? fft_launch<FftKernels<true>>(q, d, threads, planes, grid, st)
             : fft_launch<FftKernels<false>>(q, d, threads, planes, grid, st);
}

// Launches the fused body of the FFT variant (d = 128, one mode, 1024
// threads: anything else is cudaErrorInvalidValue) with the arguments of
// tk_grad_fused_fft; the same cropped frames and objective, bit for bit.
int tk_grad_fused_fft_regs(const void* psi, const void* prb,
                           const void* data, const void* scan, void* near,
                           void* partial, void* carry, const void* base,
                           int t, int s, int nz, int n, int m, int p, int d,
                           int model, int prefetch, int64_t g0, int64_t g1,
                           int first, int last, int grid, int threads,
                           void* stream) {
  if (d != 128 || m != 1 || threads != 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FftParams q{static_cast<const float2*>(psi),
              static_cast<const float2*>(prb),
              static_cast<const float*>(data), static_cast<const int*>(scan),
              static_cast<float2*>(near), nullptr,
              static_cast<double*>(partial),
              static_cast<const float2*>(base), t, s, nz, n, m, p, model,
              prefetch,
              Range{g0, g1, static_cast<double*>(carry), first, last}};
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
// bytes, as tk_grad_fused_fft_blocks_per_sm.
int tk_grad_fused_fft_regs_blocks_per_sm(int d, int has_base, int planes,
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

// Launches the atomic kernel, the FFT variant's design before it stored
// frames, on all t * s frames: the whole gradient into `grad` (t, nz, n),
// which must be zeroed, and the objective partials; no base. Returns the
// first CUDA error (0 on success).
int tk_grad_fused_atomic_fft(const void* psi, const void* prb,
                             const void* data, const void* scan, void* grad,
                             void* partial, int t, int s, int nz, int n,
                             int m, int p, int d, int model, int prefetch,
                             int grid, int threads, void* stream) {
  if (prefetch && m != 1) return static_cast<int>(cudaErrorInvalidValue);
  FftParams q{static_cast<const float2*>(psi),
              static_cast<const float2*>(prb),
              static_cast<const float*>(data), static_cast<const int*>(scan),
              nullptr, static_cast<float*>(grad),
              static_cast<double*>(partial), nullptr, t, s, nz, n, m, p,
              model, prefetch,
              Range{0, static_cast<int64_t>(t) * s, nullptr, 1, 1}};
  return fft_launch<AtomicKernels>(q, d, threads, m > 1 || prefetch ? 1 : 0,
                                   grid, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes, with `planes` (0 or 1) float planes beside the frame (one with
// several modes or with the prefetch); returns the CUDA error code.
int tk_grad_fused_fft_blocks_per_sm(int d, int has_base, int planes,
                                    int threads, int* out, int* smem_bytes) {
  return has_base
             ? fft_occupancy<FftKernels<true>>(d, threads, planes, out,
                                               smem_bytes)
             : fft_occupancy<FftKernels<false>>(d, threads, planes, out,
                                                smem_bytes);
}

}  // extern "C"
