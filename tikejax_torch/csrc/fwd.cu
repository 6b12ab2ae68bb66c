// fwd: the far-field ptychography forward operator in one kernel pass, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py fwd (_fwd_kernel).
// For every (angle, position, mode) frame it computes
//   far[t, s, m] = F (psi[y:y+p, x:x+p] * prb[m]) F^T  (+ base[t, s, m]),
// the unitary DFT of the patch zero-padded at the top left to d x d
// (F[u, y] = e^{-2 pi i u y / d} / sqrt(d)), and stores it straight into
// the (t, s, m, d, d) complex64 output, interleaved re/im as PyTorch keeps
// complex64. With a base (the split-operator refinement's frozen farplane)
// the base frame is added before the store. A position whose scan row is
// < 0 (a masked dummy), or whose window leaves the object (invalid input),
// stores a zero frame (plus the base).
//
// Two kernels compute it; the wrapper picks one from the shapes alone, as
// for grad_fused (ops/fused.py dft_variant).
//
// The FFT variant (fwd_fft_kernel; detector side 16, 32, 64 or 128). One
// frame per block, the complex frame in dynamic shared memory (142,336
// bytes at 128^2 with the twiddle tables: one block per SM), and for each
// mode the forward half that grad_fused, minf_fused and grad_prb_fused share
// (dft_frame.cuh): fft_gather_patch, fft2_frame and fft_add_base. So the
// farplane stored here is, bit for bit, the one those kernels form inside:
// a base frozen with it, or an Anderson candidate made with it, rounds as
// the kernels that read it. The epilogue reads the frame at fft_far_index
// and stores natural order straight to the output, two neighbouring pixels
// a 16-byte streaming store (the farplane is written once), 32 threads on
// 512 contiguous bytes. Masked and out-of-bounds frames still store every
// mode: zeros, or the base. No scratch in device memory. What bounds it: the
// farplane write (8 bytes a pixel, 2.1 GB at 16384 frames of 128^2: 0.64 ms
// at 3.35 TB/s; with a base one read more) and, in the same range, the
// sweeps over the frame in shared memory (gather, four FFT stages, the
// epilogue) with one block of 1024 threads per SM, which hides the stores'
// and the gather's latency badly. The FFT arithmetic (1.1 MFLOP a frame) is
// far below both.
//
// The GEMM variant (fwd_kernel; every other size): two DFT products per
// frame and mode, d*p*(d+p) complex multiply-adds -- 5.5e11 fp32 FLOPs at
// 16384 frames of 128^2 -- on the SIMT fp32 units (dft_frame.cuh cgemm),
// which take far longer than the farplane write. The only per-block scratch
// is one p x d intermediate (128 KB at 128^2); the output is written once,
// by the thread that computed each pixel, 16 neighbouring threads on 16
// neighbouring pixels.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* psi;  // (t, nz, n)
  const float2* prb;  // (t, m, p, p)
  const int* scan;    // (t, s, 2) int (y, x)
  float2* out;        // (t, s, m, d, d)
  float2* scratch;    // gridDim.x * (p*d)
  const float2* base;  // (t, s, m, d, d), read only when kBase
  int t, s, nz, n, m, p, d;
};

template <bool kBase>
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(Params q) {
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
    float2* of = q.out + f * m * dd;
    if (!frame_valid(sy, sx, q.nz, q.n, p)) {  // uniform over the block
      for (int64_t i = threadIdx.x; i < m * dd; i += kThreads) {
        of[i] = kBase ? base_at(q.base, f * m * dd + i) : make_float2(0.f, 0.f);
      }
      continue;
    }
    const float2* obj = q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    for (int mm = 0; mm < m; ++mm) {
      const int64_t o0 = (f * m + mm) * dd;
      forward_frame_mode(obj, q.n, prb + static_cast<int64_t>(mm) * p * p,
                         p, d, tw, a1,
                         [&](int u, int v, float2 z) {
                           const int64_t i = o0 + u * d + v;
                           if constexpr (kBase) {
                             const float2 b = base_at(q.base, i);
                             z.x += b.x;
                             z.y += b.y;
                           }
                           q.out[i] = z;
                         },
                         sm);
    }
  }
}

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* out;         // (t, s, m, d, d), 16-byte aligned
  const float2* base;  // (t, s, m, d, d), read only when kBase
  int t, s, nz, n, m, p;
};

// One block per SM at 128^2 (the frame fills the shared memory): registers
// are capped at 65536 / kT.
template <int kD, int kT, bool kBase>
__global__ void __launch_bounds__(kT, 1) fwd_fft_kernel(FftParams q) {
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
    // Two neighbouring pixels a store, streamed past the caches.
    float4* out = reinterpret_cast<float4*>(q.out + f * m * dd);
    const float2* base = kBase ? q.base + f * m * dd : nullptr;
    if (!frame_valid(sy, sx, q.nz, q.n, p)) {  // block-uniform
      for (int i = threadIdx.x; i < m * (dd / 2); i += kT) {
        const float2 z0 = kBase ? base_at(base, 2 * i) : make_float2(0.f, 0.f);
        const float2 z1 =
            kBase ? base_at(base, 2 * i + 1) : make_float2(0.f, 0.f);
        __stcs(out + i, make_float4(z0.x, z0.y, z1.x, z1.y));
      }
      continue;
    }
    const float2* obj =
        q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    for (int mm = 0; mm < m; ++mm) {
      fft_gather_patch<kD, kT>(fr, obj, q.n,
                               prb + static_cast<int64_t>(mm) * p * p, p);
      fft2_frame<kD, kT, false>(fr, p, tw, tws);
      const float2* b = kBase ? base + mm * dd : nullptr;
      float4* o = out + mm * (dd / 2);
      for (int i = threadIdx.x; i < dd / 2; i += kT) {
        const int u = (2 * i) / kD, v = (2 * i) % kD;
        const float2 z0 =
            fft_add_base<kBase>(fr[fft_far_index<kD>(u, v)], b, 2 * i);
        const float2 z1 =
            fft_add_base<kBase>(fr[fft_far_index<kD>(u, v + 1)], b, 2 * i + 1);
        __stcs(o + i, make_float4(z0.x, z0.y, z1.x, z1.y));
      }
      __syncthreads();  // the next gather overwrites the frame
    }
  }
}

template <bool kBase>
struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return fwd_fft_kernel<kD, kT, kBase>;
  }
};

}  // namespace

extern "C" {

// Launches the GEMM variant on `stream` with `grid` blocks; returns
// cudaGetLastError() (0 on success). `scratch` holds grid * p * d complex
// floats. A null `base` means no base; otherwise it is the contiguous
// complex64 base farplane (t, s, m, d, d). `out` must not overlap the base.
int tk_fwd(const void* psi, const void* prb, const void* scan, void* out,
           void* scratch, const void* base, int t, int s, int nz, int n,
           int m, int p, int d, int grid, void* stream) {
  Params q{static_cast<const float2*>(psi), static_cast<const float2*>(prb),
           static_cast<const int*>(scan), static_cast<float2*>(out),
           static_cast<float2*>(scratch), static_cast<const float2*>(base),
           t, s, nz, n, m, p, d};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (base != nullptr) {
    fwd_kernel<true><<<grid, kThreads, smem, st>>>(q);
  } else {
    fwd_kernel<false><<<grid, kThreads, smem, st>>>(q);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the GEMM variant at detector side `d` (with or
// without a base); returns the CUDA error code.
int tk_fwd_blocks_per_sm(int d, int has_base, int* out) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  if (has_base) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, fwd_kernel<true>, kThreads, smem));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fwd_kernel<false>, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) on `stream` with `grid` blocks; returns the first CUDA error (0 on
// success). `out` is 16-byte aligned; `base` as in tk_fwd (read 8 bytes at a
// time). There is no scratch.
int tk_fwd_fft(const void* psi, const void* prb, const void* scan, void* out,
               const void* base, int t, int s, int nz, int n, int m, int p,
               int d, int grid, int threads, void* stream) {
  FftParams q{static_cast<const float2*>(psi),
              static_cast<const float2*>(prb), static_cast<const int*>(scan),
              static_cast<float2*>(out), static_cast<const float2*>(base), t,
              s, nz, n, m, p};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return base != nullptr
             ? fft_launch<FftKernels<true>>(q, d, threads, 0, grid, st)
             : fft_launch<FftKernels<false>>(q, d, threads, 0, grid, st);
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes (`planes` is unused: the kernel has none); returns the CUDA
// error code.
int tk_fwd_fft_blocks_per_sm(int d, int has_base, int planes, int threads,
                             int* out, int* smem_bytes) {
  (void)planes;
  return has_base ? fft_occupancy<FftKernels<true>>(d, threads, 0, out,
                                                    smem_bytes)
                  : fft_occupancy<FftKernels<false>>(d, threads, 0, out,
                                                     smem_bytes);
}

}  // extern "C"
