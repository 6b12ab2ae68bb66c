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
// What bounds it: two DFT products per frame and mode,
// d*p*(d+p) complex multiply-adds -- 5.5e11 fp32 FLOPs at 16384 frames of
// 128^2 -- on the SIMT fp32 units (dft_frame.cuh cgemm), against one
// farplane write (2.1 GB there; plus one read with a base), which takes
// ~1 ms of the ~20 ms the FLOPs need. The only per-block scratch is one
// p x d intermediate (128 KB at 128^2); the output is written once, by the
// thread that computed each pixel, 16 neighbouring threads on 16
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

}  // namespace

extern "C" {

// Launches the kernel on `stream` with `grid` blocks; returns
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

// Resident blocks per SM at detector side `d` (with or without a base);
// returns the CUDA error code.
int tk_fwd_blocks_per_sm(int d, int has_base, int* out) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  if (has_base) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, fwd_kernel<true>, kThreads, smem));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fwd_kernel<false>, kThreads, smem));
}

}  // extern "C"
