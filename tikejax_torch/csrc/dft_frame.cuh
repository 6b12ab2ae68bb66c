// Device code shared by the far-field ptychography kernels for NVIDIA
// Hopper (sm_90a): the DFT kernels (grad_fused.cu, fwd.cu, minf_fused.cu,
// grad_prb_fused.cu, adj.cu, adj_probe.cu, adj_residual.cu,
// fwd_quad_stats.cu) and, for the complex helpers, the position test, the
// object scatter and the block-partial sum, the hybrid tier's
// gather_probe_mul.cu, scatter_conj_probe.cu and adj_probe_reduce.cu.
//
// The unitary DFT of a p x p patch zero-padded at the top left to d x d is
//   far = F near F^T,  F[u, y] = e^{-2 pi i u y / d} / sqrt(d)   (d x p),
// computed as two complex matrix products per frame and mode by cgemm, a
// shared-memory tiled complex GEMM (64x64 output tiles, 16-deep slices,
// 4x4 complex outputs per thread, 8 multiply-adds per shared-memory load,
// all on the fp32 SIMT units). F is never stored: it is a d-entry twiddle
// table in shared memory, indexed by (u*y) mod d. A frame's p x d
// intermediate lives in per-block scratch sized by the grid, never by the
// number of positions, so no kernel allocates anything farplane-sized.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tk {

constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kTile = 64;         // output tile side
constexpr int kDepth = 16;        // inner-dimension slice per shared stage
constexpr int kSub = kTile / 16;  // complex outputs per thread along a side

struct Tiles {
  float2 a[kDepth][kTile + 1];  // +1: conflict-free transposed stores
  float2 b[kDepth][kTile];
};

// Element i of a frozen base farplane (t, s, m, d, d), complex64, read
// through the read-only data cache: the kernels never write the base. On
// an H100 (700 W) this made the with-base fwd 6% faster than a plain load,
// and grad_fused and minf_fused 1-2% faster.
__device__ __forceinline__ float2 base_at(const float2* base, int64_t i) {
  return __ldg(base + i);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// tw[k] = e^{-2 pi i k / d} / sqrt(d), computed in double; ends with a
// barrier.
__device__ inline void load_twiddles(float2* tw, int d) {
  const double scale = rsqrt(static_cast<double>(d));
  for (int k = threadIdx.x; k < d; k += kThreads) {
    double sn, cs;
    sincospi(-2.0 * k / d, &sn, &cs);
    tw[k] = make_float2(static_cast<float>(cs * scale),
                        static_cast<float>(sn * scale));
  }
  __syncthreads();
}

// A position contributes only when its scan row is >= 0 (a row < 0 marks a
// masked dummy) and its window lies inside the object (anything else is
// invalid input, which no kernel reads or writes outside the arrays for).
__device__ __forceinline__ bool frame_valid(int sy, int sx, int nz, int n,
                                            int p) {
  return sy >= 0 && sy <= nz - p && sx >= 0 && sx <= n - p;
}

// out[th, row, col] += g for an object (t, nz, n) held as interleaved re/im
// floats: the overlap scatter of every object adjoint. fp32 atomics, so a
// sum over overlapping patches is deterministic only up to its order.
__device__ __forceinline__ void scatter_add_pixel(float* out, int th, int nz,
                                                  int n, int row, int col,
                                                  float2 g) {
  float* dst = out + 2 * ((static_cast<int64_t>(th) * nz + row) * n + col);
  atomicAdd(dst, g.x);
  atomicAdd(dst + 1, g.y);
}

// C (R x C) = A (R x K) . B (K x C) for the whole block. A and B elements
// come from the loaders la(r, k) / lb(k, c); each finished element goes to
// epi(r, c, value), exactly once, from one thread. Ends with a barrier, so
// the next stage may read what epi wrote.
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

// The forward DFT of one mode of one frame: a1 (p x d scratch) =
// (obj . pr) F^T, then far = F a1, each far[u][v] handed to epi(u, v, z).
// obj points at the patch's top-left pixel in an object of row stride n.
template <class Epi>
__device__ void forward_frame_mode(const float2* obj, int n,
                                   const float2* pr, int p, int d,
                                   const float2* tw, float2* a1, Epi epi,
                                   Tiles& sm) {
  cgemm(p, d, p,
        [&](int y, int x) {
          return cmul(obj[static_cast<int64_t>(y) * n + x], pr[y * p + x]);
        },
        [&](int x, int v) { return tw[(v * x) % d]; },
        [&](int y, int v, float2 z) { a1[y * d + v] = z; }, sm);
  cgemm(d, d, p, [&](int u, int y) { return tw[(u * y) % d]; },
        [&](int y, int v) { return a1[y * d + v]; }, epi, sm);
}

// The adjoint DFT of one mode of one frame: a1 (p x d scratch) =
// F^H far, then adj = a1 conj(F) (the crop of the inverse DFT to the top-left
// p x p patch), each adj[y][x] handed to epi(y, x, z). far(u, v) loads the
// d x d farplane frame.
template <class Far, class Epi>
__device__ void adjoint_frame_mode(Far far, int p, int d, const float2* tw,
                                   float2* a1, Epi epi, Tiles& sm) {
  // a1[y][v] = sum_u conj(F[u][y]) far[u][v]
  cgemm(p, d, d, [&](int y, int u) { return conjf2(tw[(u * y) % d]); }, far,
        [&](int y, int v, float2 z) { a1[y * d + v] = z; }, sm);
  // adj[y][x] = sum_v a1[y][v] conj(F[v][x])
  cgemm(p, p, d, [&](int y, int v) { return a1[y * d + v]; },
        [&](int v, int x) { return conjf2(tw[(v * x) % d]); }, epi, sm);
}

// out[i] = sum over b = 0..blocks-1, in that order, of acc[b * n + i],
// summed in double: the second pass of the probe reductions, whose blocks
// each accumulate their own frames into a block-owned partial. The fixed
// order makes the result bitwise reproducible.
template <class Complex>
__global__ void sum_block_partials(const Complex* acc, Complex* out,
                                   int64_t n, int blocks) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    double re = 0.0, im = 0.0;
    for (int b = 0; b < blocks; ++b) {
      const Complex v = acc[b * n + i];
      re += v.x;
      im += v.y;
    }
    out[i] = Complex{static_cast<float>(re), static_cast<float>(im)};
  }
}

// Objective of one detector pixel from its mode-summed intensity and the
// measured value; stores the likelihood factor (the residual's scale of
// the farplane) in *factor. gaussian: (sqrt(I + 1e-12) - sqrt(max(D,0)))^2,
// factor 1 - sqrt(max(D,0)) / sqrt(I + 1e-12); poisson: I - max(D,0)
// log(I + 1e-8), factor 1 - max(D,0) / (I + 1e-8).
__device__ __forceinline__ float pixel_objective(int model, float inten,
                                                 float data, float* factor) {
  const float dv = fmaxf(data, 0.f);
  if (model == 0) {  // gaussian
    const float amp = sqrtf(inten + 1e-12f), sq = sqrtf(dv);
    *factor = 1.f - sq / amp;
    return (amp - sq) * (amp - sq);
  }
  *factor = 1.f - dv / (inten + 1e-8f);  // poisson
  return inten - dv * logf(inten + 1e-8f);
}

// Sums v over the block's threads in double in a fixed order; thread 0
// stores the result in *out.
__device__ inline void block_sum_store(double v, double* out) {
  __shared__ double red[kThreads];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

}  // namespace tk

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
