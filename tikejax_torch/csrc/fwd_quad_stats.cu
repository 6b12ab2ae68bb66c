// fwd_quad_stats: the line-search statistics of the materialized CG body in
// one kernel pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py fwd_quad_stats
// (_fwd_quad_kernel). It is fwd.cu's forward frame with another epilogue:
// for every (angle, position, mode) frame it computes the direction's
// farplane
//   fd = F (dir[y:y+p, x:x+p] * prb[m]) F^T,  F[u, y] = e^{-2 pi i u y / d}
//        / sqrt(d)
// (the unitary DFT of the zero-padded patch) and, instead of storing it,
// reduces it at once against the frame of the held farplane fp = G psi into
// the per-pixel coefficients of |fp + gamma fd|^2 summed over the modes:
//   a = sum_m |fp|^2,  b = sum_m Re(conj(fp) fd),  c = sum_m |fd|^2,
// each (t, s, d, d) float32. The same entry serves the object direction
// (dir = d_psi, the probe as given) and the probe direction (dir = psi, the
// probe direction in place of the probe), since G is linear in each. A
// position whose scan row is < 0 (a masked dummy), or whose window leaves
// the object (invalid input), has a zero direction frame and its a is
// masked too, so it stores a = b = c = 0.
//
// What bounds it: two DFT products per frame and mode, d*p*(d+p) complex
// multiply-adds (5.5e11 fp32 FLOPs at 16384 frames of 128^2), on the SIMT
// fp32 units (dft_frame.cuh cgemm), against one read of fp and three
// statistic planes written (2.1 + 3.2 GB there: 1.6 ms at 3.35 TB/s). The
// direction farplane never reaches device memory; the only per-block
// scratch is one p x d intermediate. Each statistic pixel is written by the
// thread that computed it, accumulated over the modes in order (cgemm's
// closing barrier orders the modes).
//
// Contract: no reduction over frames, a fixed order over the modes: bitwise
// reproducible.

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* dir;  // (t, nz, n): the object, or the object direction
  const float2* prb;  // (t, m, p, p): the probe, or the probe direction
  const int* scan;    // (t, s, 2) int (y, x)
  const float2* fp;   // (t, s, m, d, d): the held farplane G psi (+ base)
  float* a;           // (t, s, d, d)
  float* b;           // (t, s, d, d)
  float* c;           // (t, s, d, d)
  float2* scratch;    // gridDim.x * (p*d)
  int t, s, nz, n, m, p, d;
};

__global__ void __launch_bounds__(kThreads, 2) fwd_quad_stats_kernel(Params q) {
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
    float* af = q.a + f * dd;
    float* bf = q.b + f * dd;
    float* cf = q.c + f * dd;
    if (!frame_valid(sy, sx, q.nz, q.n, p)) {  // uniform over the block
      for (int64_t i = threadIdx.x; i < dd; i += kThreads) {
        af[i] = 0.f;
        bf[i] = 0.f;
        cf[i] = 0.f;
      }
      continue;
    }
    const float2* obj = q.dir + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    for (int mm = 0; mm < m; ++mm) {
      const float2* fpm = q.fp + (f * m + mm) * dd;
      forward_frame_mode(obj, q.n, prb + static_cast<int64_t>(mm) * p * p,
                         p, d, tw, a1,
                         [&](int u, int v, float2 z) {
                           const int i = u * d + v;
                           const float2 w = fpm[i];
                           const float av = w.x * w.x + w.y * w.y;
                           const float bv = w.x * z.x + w.y * z.y;
                           const float cv = z.x * z.x + z.y * z.y;
                           if (mm == 0) {
                             af[i] = av;
                             bf[i] = bv;
                             cf[i] = cv;
                           } else {
                             af[i] += av;
                             bf[i] += bv;
                             cf[i] += cv;
                           }
                         },
                         sm);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with `grid` blocks; returns
// cudaGetLastError() (0 on success). `scratch` holds grid * p * d complex
// floats; `a`, `b`, `c` need no initialisation.
int tk_fwd_quad_stats(const void* dir, const void* prb, const void* scan,
                      const void* fp, void* a, void* b, void* c,
                      void* scratch, int t, int s, int nz, int n, int m,
                      int p, int d, int grid, void* stream) {
  Params q{static_cast<const float2*>(dir), static_cast<const float2*>(prb),
           static_cast<const int*>(scan), static_cast<const float2*>(fp),
           static_cast<float*>(a), static_cast<float*>(b),
           static_cast<float*>(c), static_cast<float2*>(scratch),
           t, s, nz, n, m, p, d};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  fwd_quad_stats_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at detector side `d` (`has_base` is unused);
// returns the CUDA error code.
int tk_fwd_quad_stats_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fwd_quad_stats_kernel, kThreads, smem));
}

}  // extern "C"
