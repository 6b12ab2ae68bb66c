// grad_fused: the object gradient and the objective of far-field
// ptychography in one kernel pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_fused.py grad_fused
// (_grad_kernel). For every (angle, position, mode) frame it computes
//   1. near = psi[y:y+p, x:x+p] * prb[m]                       (p x p)
//   2. far  = F near F^T, F[u, y] = e^{-2 pi i u y / d} / sqrt(d)  (d x p)
//      -- the unitary DFT of the patch zero-padded at the top left;
//   3. the likelihood factor and objective from the mode-summed
//      intensity (gaussian: 1 - sqrt(max(D,0)) / sqrt(I + 1e-12),
//      poisson: 1 - max(D,0) / (I + 1e-8));
//   4. adj = F^H (factor * far) conj(F);
//   5. conj(prb[m]) * adj, summed over modes and scatter-added into the
//      object gradient.
// Outputs grad = G^H(factor * G psi) (no factor 2) and per-block objective
// partials. Positions whose scan row is < 0 (masked dummies) contribute
// nothing; so do out-of-bounds positions (invalid input: the kernel never
// reads or writes outside the object).
//
// What bounds it: the four DFT products are 2*d*p*(d+p) complex
// multiply-adds per frame and mode -- 1.1e12 fp32 FLOPs per evaluation at
// 16384 frames of 128^2 -- all on the SIMT fp32 units here. The design keeps
// them in shared-memory tiled complex GEMMs (64x64 output tiles, 4x4
// complex outputs per thread, 8 multiply-adds per shared-memory load) and
// never materialises a farplane: the two p x d / d x d intermediates of a
// frame live in per-block scratch sized by the grid, never by the number
// of positions. F is never stored: it is a d-entry twiddle table in shared
// memory, indexed by (u*y) mod d.
//
// Contract: the gradient scatter uses atomicAdd on the fp32 re/im planes,
// so it is deterministic only up to summation order; the objective is
// summed per thread and per block in double in a fixed order, then over the
// blocks in a fixed order by the caller, so it is bitwise reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTile = 64;      // output tile side
constexpr int kDepth = 16;     // inner-dimension slice per shared-memory stage
constexpr int kSub = kTile / 16;  // complex outputs per thread along a side

struct Params {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const float* data;   // (t, s, d, d)
  const int* scan;     // (t, s, 2) int (y, x)
  float* grad;         // (t, nz, n) complex as interleaved re/im floats
  float2* scratch;     // gridDim.x * (m*p*d + m*d*d)
  double* partial;     // gridDim.x objective partials
  int t, s, nz, n, m, p, d, model;
};

struct Tiles {
  float2 a[kDepth][kTile + 1];  // +1: conflict-free transposed stores
  float2 b[kDepth][kTile];
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// C (R x C) = A (R x K) . B (K x C) for the whole block. A and B elements
// come from the loaders la(r, k) / lb(k, c); each finished element goes to
// epi(r, c, value). Ends with a barrier, so the next stage may read what
// epi wrote.
template <class LoadA, class LoadB, class Epi>
__device__ void cgemm(int R, int C, int K, LoadA la, LoadB lb, Epi epi,
                      Tiles& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int r0 = 0; r0 < R; r0 += kTile) {
    for (int c0 = 0; c0 < C; c0 += kTile) {
      float2 acc[kSub][kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = make_float2(0.f, 0.f);
      for (int k0 = 0; k0 < K; k0 += kDepth) {
        for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
          const int kk = e % kDepth, rr = e / kDepth;
          const int r = r0 + rr, k = k0 + kk;
          sm.a[kk][rr] = (r < R && k < K) ? la(r, k) : make_float2(0.f, 0.f);
        }
        for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
          const int cc = e % kTile, kk = e / kTile;
          const int c = c0 + cc, k = k0 + kk;
          sm.b[kk][cc] = (c < C && k < K) ? lb(k, c) : make_float2(0.f, 0.f);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
          float2 av[kSub], bv[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kSub; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < kSub; ++j) {
              acc[i][j].x = fmaf(av[i].x, bv[j].x, acc[i][j].x);
              acc[i][j].x = fmaf(-av[i].y, bv[j].y, acc[i][j].x);
              acc[i][j].y = fmaf(av[i].x, bv[j].y, acc[i][j].y);
              acc[i][j].y = fmaf(av[i].y, bv[j].x, acc[i][j].y);
            }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
          if (r < R && c < C) epi(r, c, acc[i][j]);
        }
    }
  }
  __syncthreads();
}

// Two resident blocks per SM: caps registers at 128 per thread.
__global__ void __launch_bounds__(kThreads, 2)
    grad_fused_kernel(Params q) {
  extern __shared__ float2 tw[];  // tw[k] = e^{-2 pi i k / d} / sqrt(d)
  __shared__ Tiles sm;
  __shared__ double red[kThreads];

  const int p = q.p, d = q.d, m = q.m;
  const double scale = rsqrt(static_cast<double>(d));
  for (int k = threadIdx.x; k < d; k += kThreads) {
    double sn, cs;
    sincospi(-2.0 * k / d, &sn, &cs);
    tw[k] = make_float2(static_cast<float>(cs * scale),
                        static_cast<float>(sn * scale));
  }
  __syncthreads();

  const int64_t pd = static_cast<int64_t>(p) * d;
  const int64_t dd = static_cast<int64_t>(d) * d;
  float2* s1 = q.scratch + blockIdx.x * (m * pd + m * dd);  // m x (p x d)
  float2* s2 = s1 + m * pd;                                 // m x (d x d)
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  double fsum = 0.0;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (sy < 0 || sy > q.nz - p || sx < 0 || sx > q.n - p) continue;
    const float2* obj = q.psi + (static_cast<int64_t>(th) * q.nz + sy) * q.n + sx;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * p * p;
    const float* dat = q.data + f * dd;

    for (int mm = 0; mm < m; ++mm) {
      const float2* pr = prb + static_cast<int64_t>(mm) * p * p;
      float2* a1 = s1 + mm * pd;
      float2* a2 = s2 + mm * dd;
      // Stage 1: a1[y][v] = sum_x near[y][x] F[v][x].
      cgemm(p, d, p,
            [&](int y, int x) {
              return cmul(obj[static_cast<int64_t>(y) * q.n + x], pr[y * p + x]);
            },
            [&](int x, int v) { return tw[(v * x) % d]; },
            [&](int y, int v, float2 z) { a1[y * d + v] = z; }, sm);
      // Stage 2: a2[u][v] = sum_y F[u][y] a1[y][v]  (the farplane).
      cgemm(d, d, p, [&](int u, int y) { return tw[(u * y) % d]; },
            [&](int y, int v) { return a1[y * d + v]; },
            [&](int u, int v, float2 z) { a2[u * d + v] = z; }, sm);
    }

    // Likelihood factor and objective from the mode-summed intensity.
    for (int64_t i = threadIdx.x; i < dd; i += kThreads) {
      float inten = 0.f;
      for (int mm = 0; mm < m; ++mm) {
        const float2 z = s2[mm * dd + i];
        inten += z.x * z.x + z.y * z.y;
      }
      const float dv = fmaxf(dat[i], 0.f);
      float factor, obj_i;
      if (q.model == 0) {  // gaussian
        const float amp = sqrtf(inten + 1e-12f), sq = sqrtf(dv);
        factor = 1.f - sq / amp;
        obj_i = (amp - sq) * (amp - sq);
      } else {  // poisson
        factor = 1.f - dv / (inten + 1e-8f);
        obj_i = inten - dv * logf(inten + 1e-8f);
      }
      fsum += obj_i;
      for (int mm = 0; mm < m; ++mm) {
        float2& z = s2[mm * dd + i];
        z = make_float2(z.x * factor, z.y * factor);
      }
    }
    __syncthreads();

    for (int mm = 0; mm < m; ++mm) {
      const float2* pr = prb + static_cast<int64_t>(mm) * p * p;
      float2* a1 = s1 + mm * pd;
      const float2* a2 = s2 + mm * dd;
      // Stage 3: a1[y][v] = sum_u conj(F[u][y]) a2[u][v].
      cgemm(p, d, d, [&](int y, int u) { return conjf2(tw[(u * y) % d]); },
            [&](int u, int v) { return a2[u * d + v]; },
            [&](int y, int v, float2 z) { a1[y * d + v] = z; }, sm);
      // Stage 4: adj[y][x] = sum_v a1[y][v] conj(F[v][x]); scatter
      // conj(prb) * adj into the gradient.
      cgemm(p, p, d, [&](int y, int v) { return a1[y * d + v]; },
            [&](int v, int x) { return conjf2(tw[(v * x) % d]); },
            [&](int y, int x, float2 z) {
              const float2 g = cmul(conjf2(pr[y * p + x]), z);
              float* dst = q.grad + 2 * ((static_cast<int64_t>(th) * q.nz + sy + y) * q.n + sx + x);
              atomicAdd(dst, g.x);
              atomicAdd(dst + 1, g.y);
            },
            sm);
    }
  }

  red[threadIdx.x] = fsum;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) q.partial[blockIdx.x] = red[0];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with `grid` blocks; returns
// cudaGetLastError() (0 on success). `grad` must be zeroed, `scratch` hold
// grid * (m*p*d + m*d*d) complex floats, `partial` grid doubles.
int tk_grad_fused(const void* psi, const void* prb, const void* data,
                  const void* scan, void* grad, void* scratch, void* partial,
                  int t, int s, int nz, int n, int m, int p, int d, int model,
                  int grid, void* stream) {
  Params q{static_cast<const float2*>(psi), static_cast<const float2*>(prb),
           static_cast<const float*>(data), static_cast<const int*>(scan),
           static_cast<float*>(grad), static_cast<float2*>(scratch),
           static_cast<double*>(partial), t, s, nz, n, m, p, d, model};
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  grad_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at detector side `d`; returns the CUDA error code.
int tk_grad_fused_blocks_per_sm(int d, int* out) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float2);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, grad_fused_kernel, kThreads, smem));
}

const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
