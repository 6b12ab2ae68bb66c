// fwd_quad_stats: the line-search statistics of the materialized CG body in
// one kernel pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py fwd_quad_stats
// (_fwd_quad_kernel). For every (angle, position, mode) frame it computes the
// direction's farplane
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
// masked too, so it stores a = b = c = 0 and reads nothing.
//
// Two kernels compute it; the wrapper picks one from the shapes alone, as
// for grad_fused (ops/fused.py dft_variant).
//
// The FFT variant (fwd_quad_stats_fft_kernel; detector side 16, 32, 64 or
// 128). One frame per block, the complex frame in dynamic shared memory
// (142,336 bytes at 128^2 with the twiddle tables: one block per SM), and
// for each mode the forward half that fwd, grad_fused, minf_fused and
// grad_prb_fused share (dft_frame.cuh fft_gather_patch, fft2_frame): fd is,
// bit for bit, the farplane fwd stores. The epilogue gives thread j the
// pixel pairs (2i, 2i + 1), i = j, j + kT, ...: it loads the pair of fp with
// one 16-byte streaming load (fp is read once), reads fd at fft_far_index
// and writes a, b and c as 8-byte pairs. The three statistics are spelled
// out (a = fft_intensity(fp), c = fft_intensity(fd), b the same fmaf
// pattern on fp and fd), so no kernel contracts them differently: with
// fp = fwd(x) and dir = x, a == b == c bit for bit. With several modes the
// thread that owns a pixel owns it in every mode: mode 0 stores, each later
// mode reads its own pixels back through L2, adds and stores again (the last
// mode streams), so the planes are written once per mode -- three float
// planes do not fit in shared memory beside a 128^2 frame. No scratch in
// device memory. What bounds it: the one read of fp and the three planes
// written (8 + 12 bytes a pixel, 2.1 + 3.2 GB at 16384 frames of 128^2: 1.6
// ms at 3.35 TB/s) against the sweeps over the frame in shared memory
// (gather, four forward stages, the epilogue), which overlap the bytes only
// in part with one block of 1024 threads per SM. The FFT arithmetic (1.1
// MFLOP a frame) is far below both.
//
// The GEMM variant (fwd_quad_stats_kernel; every other size): fwd.cu's
// DFT-GEMM frame with the same epilogue, d*p*(d+p) complex multiply-adds
// per frame and mode (5.5e11 fp32 FLOPs at 16384 frames of 128^2) on the
// SIMT fp32 units (dft_frame.cuh cgemm), which take far longer than the
// bytes. The only per-block scratch is one p x d intermediate. Each
// statistic pixel is written by the thread that computed it, accumulated
// over the modes in order (cgemm's closing barrier orders the modes).
//
// Contract (both variants): no reduction over frames, a fixed order over
// the modes: bitwise reproducible. The two variants differ in the low bits
// (another transform).

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

// -- the FFT variant -----------------------------------------------------

struct FftParams {
  const float2* dir;  // (t, nz, n)
  const float2* prb;  // (t, m, p, p)
  const int* scan;    // (t, s, 2) int (y, x)
  const float2* fp;   // (t, s, m, d, d), 16-byte aligned
  float* a;           // (t, s, d, d)
  float* b;           // (t, s, d, d)
  float* c;           // (t, s, d, d)
  int t, s, nz, n, m, p;
};

// One block per SM at 128^2 (the frame fills the shared memory): registers
// are capped at 65536 / kT. Thread j owns the pixel pairs (2i, 2i + 1),
// i = j, j + kT, ..., of fp and of the three planes, in every mode.
template <int kD, int kT>
__global__ void __launch_bounds__(kT, 1)
    fwd_quad_stats_fft_kernel(FftParams q) {
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
    // The frame's pixel pairs in the three planes: one offset, not three
    // live pointers (the 1024-thread kernel has 64 registers).
    float2* const ap = reinterpret_cast<float2*>(q.a);
    float2* const bp = reinterpret_cast<float2*>(q.b);
    float2* const cp = reinterpret_cast<float2*>(q.c);
    const int64_t o = f * (dd / 2);
    if (!frame_valid(sy, sx, q.nz, q.n, p)) {  // block-uniform
      const float2 zero = make_float2(0.f, 0.f);
      for (int i = threadIdx.x; i < dd / 2; i += kT) {
        __stcs(ap + o + i, zero);
        __stcs(bp + o + i, zero);
        __stcs(cp + o + i, zero);
      }
      continue;
    }
    const float2* obj =
        q.dir + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    const float4* src = reinterpret_cast<const float4*>(q.fp + f * m * dd);
    for (int mm = 0; mm < m; ++mm) {
      fft_gather_patch<kD, kT>(fr, obj, q.n,
                               prb + static_cast<int64_t>(mm) * p * p, p);
      fft2_frame<kD, kT, false>(fr, p, tw, tws);
      const float4* fpm = src + mm * (dd / 2);
      for (int i = threadIdx.x; i < dd / 2; i += kT) {
        const float4 w = __ldcs(fpm + i);
        const int u = (2 * i) / kD, v = (2 * i) % kD;
        const float2 w0 = make_float2(w.x, w.y), w1 = make_float2(w.z, w.w);
        const float2 z0 = fr[fft_far_index<kD>(u, v)];
        const float2 z1 = fr[fft_far_index<kD>(u, v + 1)];
        float2 av = make_float2(fft_intensity(w0), fft_intensity(w1));
        float2 bv = make_float2(fmaf(w0.x, z0.x, w0.y * z0.y),
                                fmaf(w1.x, z1.x, w1.y * z1.y));
        float2 cv = make_float2(fft_intensity(z0), fft_intensity(z1));
        if (mm > 0) {  // this thread's own pixels of the last mode, via L2
          const float2 a0 = __ldcg(ap + o + i), b0 = __ldcg(bp + o + i),
                       c0 = __ldcg(cp + o + i);
          av = make_float2(a0.x + av.x, a0.y + av.y);
          bv = make_float2(b0.x + bv.x, b0.y + bv.y);
          cv = make_float2(c0.x + cv.x, c0.y + cv.y);
        }
        if (mm == m - 1) {  // final: streamed past the caches
          __stcs(ap + o + i, av);
          __stcs(bp + o + i, bv);
          __stcs(cp + o + i, cv);
        } else {
          __stcg(ap + o + i, av);
          __stcg(bp + o + i, bv);
          __stcg(cp + o + i, cv);
        }
      }
      __syncthreads();  // the next gather overwrites the frame
    }
  }
}

struct FftKernels {
  template <int kD, int kT>
  static auto get() {
    return fwd_quad_stats_fft_kernel<kD, kT>;
  }
};

}  // namespace

extern "C" {

// Launches the GEMM variant on `stream` with `grid` blocks; returns
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

// Resident blocks per SM of the GEMM variant at detector side `d`
// (`has_base` is unused); returns the CUDA error code.
int tk_fwd_quad_stats_blocks_per_sm(int d, int has_base, int* out) {
  (void)has_base;
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fwd_quad_stats_kernel, kThreads, smem));
}

// Launches the FFT variant (d = 16, 32, 64 or 128; `threads` 1024 at d = 128,
// else 512) on `stream` with `grid` blocks; returns the first CUDA error (0 on
// success). `fp` is 16-byte aligned; `a`, `b`, `c` need no initialisation.
// There is no scratch.
int tk_fwd_quad_stats_fft(const void* dir, const void* prb, const void* scan,
                          const void* fp, void* a, void* b, void* c, int t,
                          int s, int nz, int n, int m, int p, int d,
                          int grid, int threads, void* stream) {
  FftParams q{static_cast<const float2*>(dir),
              static_cast<const float2*>(prb), static_cast<const int*>(scan),
              static_cast<const float2*>(fp), static_cast<float*>(a),
              static_cast<float*>(b), static_cast<float*>(c), t, s, nz, n, m,
              p};
  return fft_launch<FftKernels>(q, d, threads, 0, grid,
                                static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the FFT variant and its dynamic shared memory
// in bytes (`has_base` and `planes` are unused: the kernel has neither);
// returns the CUDA error code.
int tk_fwd_quad_stats_fft_blocks_per_sm(int d, int has_base, int planes,
                                        int threads, int* out,
                                        int* smem_bytes) {
  (void)has_base;
  (void)planes;
  return fft_occupancy<FftKernels>(d, threads, 0, out, smem_bytes);
}

}  // extern "C"
