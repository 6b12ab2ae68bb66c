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
//
// For a power-of-two detector side d = 16..128 the same transform is also
// here as an FFT of the whole frame in shared memory (fft2_frame, at the end
// of this file): 2.3 MFLOP a frame at 128^2 where the two matrix products
// are 67 MFLOP. grad_fused.cu, minf_fused.cu, grad_prb_fused.cu, fwd.cu,
// adj.cu, adj_probe.cu, adj_residual.cu and fwd_quad_stats.cu run it (and
// keep their cgemm kernel for every other size).
// ls_objectives.cu has no DFT: it takes the position test and the complex
// helpers from here.
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

// a * b with the multiply-adds written out: the compiler may not contract
// the products differently in two kernels that inline the same helper, so
// fwd's farplane and the fused kernels' internal one agree bit for bit.
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -(a.y * b.y)), fmaf(a.x, b.y, a.y * b.x));
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
// floats: the overlap scatter of the forced atomic kernels (scatter_patch,
// scatter_conj_probe.cu's atomic kernel). fp32 atomics, so a sum over
// overlapping patches is deterministic only up to its order.
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
  return fmaf(-dv, logf(inten + 1e-8f), inten);
}

// Sums the kT threads' v over the block in double in a fixed order, each
// thread's v in slot `slot` (a permutation of the threads); thread 0 stores
// the result in *out.
template <int kT>
__device__ inline void block_sum_store_n(double v, double* out, int slot) {
  __shared__ double red[kT];
  red[slot] = v;
  __syncthreads();
  for (int w = kT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

// The same with each thread's v in its own slot.
template <int kT>
__device__ inline void block_sum_store_n(double v, double* out) {
  block_sum_store_n<kT>(v, out, threadIdx.x);
}

// The same for the DFT-GEMM kernels' blocks of kThreads.
__device__ inline void block_sum_store(double v, double* out) {
  block_sum_store_n<kThreads>(v, out);
}

// ---------------------------------------------------------------------------
// The frame's FFT in shared memory, for d = 16, 32, 64 or 128.
//
// What bounds it: not arithmetic (5 N log2 N = 1.1 MFLOP for one 128^2
// transform) but sweeps over the frame in shared memory, so the design
// spends as few as it can: a 1-D transform of length d = N1 * N2 is two
// in-place stages, in each of which a thread holds N1 (or N2) points of one
// line in registers, runs a radix-2 butterfly network on them with
// compile-time twiddles, and writes them back where it read them; between
// the stages the points are multiplied by W_d^(n2 k1) from a d-entry table.
// One read and one write of the frame per stage, four stages per 2-D
// transform, one barrier after each.
//
// Nothing is reordered. The forward transform takes its input in natural
// order and leaves frequency k of a line at position
//   fft_pos(k) = N2 * (k mod N1) + k / N1;
// the inverse transform takes its input in that order and returns natural
// order. What sits between the two (the likelihood factor, a per-pixel
// multiply) reads the measured pixel (u, v) from device memory in natural,
// coalesced order and the frame at (fft_pos(u), fft_pos(v)).
//
// Bank conflicts. A float2 access is served half a warp at a time, 16 lanes
// on 16 eight-byte banks. The lanes of a warp always run ACROSS the lines of
// a pass (neighbouring rows in the row pass, neighbouring columns in the
// column pass), never along one, and the row pitch is odd, so every
// butterfly load and store is conflict-free: a transposed exchange is not
// needed. Each row also carries one pad element after every 16 (fft_col):
// without it the 8 neighbouring frequencies v = 8a .. 8a+7 that one 32-byte
// sector of the measured frame holds would all fall on one bank in the
// likelihood pass (fft_pos(v) = 16 (v mod 8) + a); with it they fall on 8.
// At 128^2 the frame takes 128 * 137 * 8 = 140,288 bytes.

template <int kD> struct FftSplit;
template <> struct FftSplit<16> { static constexpr int n1 = 4, n2 = 4; };
template <> struct FftSplit<32> { static constexpr int n1 = 4, n2 = 8; };
template <> struct FftSplit<64> { static constexpr int n1 = 8, n2 = 8; };
template <> struct FftSplit<128> { static constexpr int n1 = 8, n2 = 16; };

template <int kN> struct Log2 {
  static constexpr int value = 1 + Log2<kN / 2>::value;
};
template <> struct Log2<1> { static constexpr int value = 0; };

template <int kD> struct FftFrame {
  // One pad element every 16, and an odd pitch: rows fall on all banks.
  static constexpr int row = kD + kD / 16;
  static constexpr int pitch = row | 1;
  static constexpr int size = kD * pitch;  // float2 elements
};

// Column of a frame row where element c of the row is kept.
__device__ __forceinline__ int fft_col(int c) { return c + (c >> 4); }

// Position along a line where the forward transform leaves frequency k.
template <int kD>
__device__ __forceinline__ int fft_pos(int k) {
  constexpr int n1 = FftSplit<kD>::n1, n2 = FftSplit<kD>::n2;
  return n2 * (k & (n1 - 1)) + (k >> Log2<n1>::value);
}

// Index into the frame of the farplane pixel (u, v) after the forward
// transform (and before the inverse one).
template <int kD>
__device__ __forceinline__ int fft_far_index(int u, int v) {
  return fft_pos<kD>(u) * FftFrame<kD>::pitch + fft_col(fft_pos<kD>(v));
}

// Index into the frame of the near-field pixel (y, x).
template <int kD>
__device__ __forceinline__ int fft_near_index(int y, int x) {
  return y * FftFrame<kD>::pitch + fft_col(x);
}

// tw[k] = e^{-2 pi i k / d} and tws[k] = tw[k] / d (the unitary scale of the
// 2-D transform, applied once, in the row pass), computed in double; ends
// with a barrier.
template <int kD, int kT>
__device__ inline void fft_load_twiddles(float2* tw, float2* tws) {
  for (int k = threadIdx.x; k < kD; k += kT) {
    double sn, cs;
    sincospi(-2.0 * k / kD, &sn, &cs);
    tw[k] = make_float2(static_cast<float>(cs), static_cast<float>(sn));
    tws[k] = make_float2(static_cast<float>(cs / kD),
                         static_cast<float>(sn / kD));
  }
  __syncthreads();
}

// e^{-2 pi i k / 16}, k = 0..7; k is a compile-time value wherever this is
// called, so the switch folds to two constants.
__device__ __forceinline__ float2 fft_w16(int k) {
  switch (k) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(0.92387953251128674f, -0.38268343236508977f);
    case 2: return make_float2(0.70710678118654752f, -0.70710678118654752f);
    case 3: return make_float2(0.38268343236508977f, -0.92387953251128674f);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-0.38268343236508977f, -0.92387953251128674f);
    case 6: return make_float2(-0.70710678118654752f, -0.70710678118654752f);
    default: return make_float2(-0.92387953251128674f, -0.38268343236508977f);
  }
}

// t * e^{-+ 2 pi i k / 16} (the conjugate for the inverse transform).
template <bool kInverse>
__device__ __forceinline__ float2 fft_mul_w16(float2 t, int k) {
  if (k == 0) return t;
  if (k == 4) {
    return kInverse ? make_float2(-t.y, t.x) : make_float2(t.y, -t.x);
  }
  float2 w = fft_w16(k);
  if (kInverse) w.y = -w.y;
  return cmul(t, w);
}

template <int kBits>
__device__ __forceinline__ int fft_bitrev(int i) {
  int r = 0;
#pragma unroll
  for (int b = 0; b < kBits; ++b) r |= ((i >> b) & 1) << (kBits - 1 - b);
  return r;
}

// The DFT of kR = 2, 4, 8 or 16 points held in registers (radix-2,
// decimation in frequency): natural order in, v[i] = X[fft_bitrev(i)] out.
// Every index is a compile-time value once the loops are unrolled.
template <int kR, bool kInverse>
__device__ __forceinline__ void fft_regs(float2 (&v)[kR]) {
#pragma unroll
  for (int st = 0; st < Log2<kR>::value; ++st) {
    const int s = (kR / 2) >> st;
#pragma unroll
    for (int i = 0; i < kR / 2; ++i) {
      const int j = i & (s - 1);
      const int i0 = ((i - j) << 1) + j, i1 = i0 + s;
      const float2 a = v[i0], c = v[i1];
      v[i0] = make_float2(a.x + c.x, a.y + c.y);
      v[i1] = fft_mul_w16<kInverse>(make_float2(a.x - c.x, a.y - c.y),
                                    j * (8 / s));
    }
  }
}

// The first stage of the forward 1-D transforms of `nlines` lines of the
// frame, in place; element e of line l is fr[at(l, e)]. Elements e >= nin
// of a line are taken as zero and not read (the padding). The lanes of a
// warp take neighbouring lines. No barrier.
template <int kD, int kT, class At>
__device__ __forceinline__ void fft_lines_forward_stage1(float2* fr, At at,
                                                         int nlines, int nin,
                                                         const float2* tw) {
  constexpr int n1 = FftSplit<kD>::n1, n2 = FftSplit<kD>::n2;
  for (int task = threadIdx.x; task < nlines * n2; task += kT) {
    const int line = task % nlines, j2 = task / nlines;
    float2 v[n1];
#pragma unroll
    for (int j1 = 0; j1 < n1; ++j1) {
      const int e = n2 * j1 + j2;
      v[j1] = e < nin ? fr[at(line, e)] : make_float2(0.f, 0.f);
    }
    fft_regs<n1, false>(v);
#pragma unroll
    for (int i = 0; i < n1; ++i) {
      const int k1 = fft_bitrev<Log2<n1>::value>(i);
      fr[at(line, n2 * k1 + j2)] = cmul(v[i], tw[j2 * k1]);
    }
  }
}

// The second stage of the inverse 1-D transforms of `nlines` lines, in
// place: natural order out; only the elements e < nout of a line are
// written (the crop). The lanes of a warp take neighbouring lines. No
// barrier.
template <int kD, int kT, class At>
__device__ __forceinline__ void fft_lines_inverse_stage2(float2* fr, At at,
                                                         int nlines,
                                                         int nout) {
  constexpr int n1 = FftSplit<kD>::n1, n2 = FftSplit<kD>::n2;
  for (int task = threadIdx.x; task < nlines * n2; task += kT) {
    const int line = task % nlines, j2 = task / nlines;
    float2 v[n1];
#pragma unroll
    for (int k1 = 0; k1 < n1; ++k1) v[k1] = fr[at(line, n2 * k1 + j2)];
    fft_regs<n1, true>(v);
#pragma unroll
    for (int i = 0; i < n1; ++i) {
      const int e = n2 * fft_bitrev<Log2<n1>::value>(i) + j2;
      if (e < nout) fr[at(line, e)] = v[i];
    }
  }
}

// Forward 1-D transforms of `nlines` lines of the frame, in place; element
// e of line l is fr[at(l, e)]. Elements e >= nin of a line are taken as
// zero and not read (the padding). Natural order in, fft_pos order out.
// Needs a barrier before it; ends with one.
template <int kD, int kT, class At>
__device__ void fft_lines_forward(float2* fr, At at, int nlines, int nin,
                                  const float2* tw) {
  constexpr int n1 = FftSplit<kD>::n1, n2 = FftSplit<kD>::n2;
  fft_lines_forward_stage1<kD, kT>(fr, at, nlines, nin, tw);
  __syncthreads();
  for (int task = threadIdx.x; task < nlines * n1; task += kT) {
    const int line = task % nlines, k1 = task / nlines;
    float2 v[n2];
#pragma unroll
    for (int j2 = 0; j2 < n2; ++j2) v[j2] = fr[at(line, n2 * k1 + j2)];
    fft_regs<n2, false>(v);
#pragma unroll
    for (int i = 0; i < n2; ++i) {
      fr[at(line, n2 * k1 + fft_bitrev<Log2<n2>::value>(i))] = v[i];
    }
  }
  __syncthreads();
}

// Inverse 1-D transforms of `nlines` lines, in place: fft_pos order in,
// natural order out; only the elements e < nout of a line are written (the
// crop). Needs a barrier before it; ends with one.
template <int kD, int kT, class At>
__device__ void fft_lines_inverse(float2* fr, At at, int nlines, int nout,
                                  const float2* tw) {
  constexpr int n1 = FftSplit<kD>::n1, n2 = FftSplit<kD>::n2;
  for (int task = threadIdx.x; task < nlines * n1; task += kT) {
    const int line = task % nlines, k1 = task / nlines;
    float2 v[n2];
#pragma unroll
    for (int k2 = 0; k2 < n2; ++k2) v[k2] = fr[at(line, n2 * k1 + k2)];
    fft_regs<n2, true>(v);
#pragma unroll
    for (int i = 0; i < n2; ++i) {
      const int j2 = fft_bitrev<Log2<n2>::value>(i);
      fr[at(line, n2 * k1 + j2)] = cmul(v[i], conjf2(tw[j2 * k1]));
    }
  }
  __syncthreads();
  fft_lines_inverse_stage2<kD, kT>(fr, at, nlines, nout);
  __syncthreads();
}

// The unitary 2-D transform of the frame `fr` (FftFrame<kD>::size float2 in
// shared memory), in place, by the whole block of kT threads.
//   forward (kInverse = false): the p x p patch at fft_near_index(y, x),
//     zero-padded to kD x kD without the zeros ever being written: only the
//     p rows that hold the patch are transformed along the row, and both
//     passes take the elements past p as zero. Farplane pixel (u, v) ends
//     at fft_far_index(u, v).
//   inverse (kInverse = true): farplane pixel (u, v) at fft_far_index(u, v);
//     the top-left p x p crop of the inverse transform ends at
//     fft_near_index(y, x); the column pass writes only rows < p and the
//     row pass runs on those rows alone.
// Needs a barrier before it; ends with one.
template <int kD, int kT, bool kInverse>
__device__ void fft2_frame(float2* fr, int p, const float2* tw,
                           const float2* tws) {
  auto row_at = [](int r, int e) {
    return r * FftFrame<kD>::pitch + fft_col(e);
  };
  auto col_at = [](int c, int e) {
    return e * FftFrame<kD>::pitch + fft_col(c);
  };
  if constexpr (kInverse) {
    fft_lines_inverse<kD, kT>(fr, col_at, kD, p, tw);
    fft_lines_inverse<kD, kT>(fr, row_at, p, p, tws);
  } else {
    fft_lines_forward<kD, kT>(fr, row_at, p, p, tws);
    fft_lines_forward<kD, kT>(fr, col_at, kD, p, tw);
  }
}

// 16 bytes from device memory straight into shared memory, without a
// register in between (cp.async); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// An L2 policy that evicts first the lines it tags: for a stream read once
// (a measured frame), so that it does not push the object and the probe,
// which every frame reads, out of the L2.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// cp_async16 with an L2 policy.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          s),
      "l"(src), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for this thread's copies; a barrier must follow before another
// thread reads what they wrote.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Dynamic shared memory of an FFT kernel: the two twiddle tables, the
// frame and, for `planes` > 0, that many kD x kD float planes.
template <int kD>
constexpr size_t fft_smem_bytes(int planes) {
  return sizeof(float2) * (2 * kD + FftFrame<kD>::size)
         + sizeof(float) * static_cast<size_t>(planes) * kD * kD;
}

// grad[patch] += conj(prb[m]) * fr (the cropped inverse transform, at
// fft_near_index) with fp32 atomics: the object scatter of the one-pass
// kernels that grad_fused.cu, adj.cu and adj_residual.cu keep only for a
// caller that forces them, to time them against the two-pass design (the
// crop stored, then scatter_conj_probe.cu's tile kernel in scan order).
// Ends with a barrier, after which the frame may be overwritten.
template <int kD, int kT>
__device__ __forceinline__ void scatter_patch(const float2* fr, float* grad,
                                              int th, int nz, int n, int sy,
                                              int sx, const float2* pr,
                                              int p) {
  for (int i = threadIdx.x; i < p * p; i += kT) {
    const int y = i / p, x = i - y * p;
    const float2 g = cmul(conjf2(pr[i]), fr[fft_near_index<kD>(y, x)]);
    scatter_add_pixel(grad, th, nz, n, sy + y, sx + x, g);
  }
  __syncthreads();
}

// The patch's cropped inverse frame `fr` (at fft_near_index) into `nr`
// (p x p). Ends with a barrier, after which the frame may be overwritten.
template <int kD, int kT>
__device__ __forceinline__ void store_crop(const float2* fr, float2* nr,
                                           int p) {
  for (int i = threadIdx.x; i < p * p; i += kT) {
    const int y = i / p, x = i - y * p;
    nr[i] = fr[fft_near_index<kD>(y, x)];
  }
  __syncthreads();
}

// The frames [g0, g1) of one launch of grad_fused's or adj_residual's frame
// kernel (frame f = angle * s + position) and the objective's carry between
// launches. Block b takes the frames f = b (mod gridDim.x) of the range in
// increasing order, as one launch on all frames does; each thread's
// objective sum starts from carry[b * threads + thread] unless `first`, and
// is left there unless `last`, when the block stores its partial.
struct Range {
  int64_t g0, g1;
  double* carry;  // gridDim.x * threads per block
  int first, last;
};

// The first frame of the range that block b takes.
__device__ __forceinline__ int64_t range_start(const Range& r) {
  const int64_t grid = gridDim.x;
  return r.g0 + (static_cast<int64_t>(blockIdx.x) - r.g0 % grid + grid) % grid;
}

// `slot` (0 .. threads - 1) names the objective sum a thread carries; a
// kernel whose threads sum other pixels than thread t of another kernel does
// carries thread t's sum in slot t all the same, so that the two agree bit
// for bit.
__device__ __forceinline__ double range_carry_in(const Range& r, int threads,
                                                 int slot) {
  return r.first
             ? 0.0
             : r.carry[static_cast<int64_t>(blockIdx.x) * threads + slot];
}

__device__ __forceinline__ double range_carry_in(const Range& r,
                                                 int threads) {
  return range_carry_in(r, threads, threadIdx.x);
}

// Ends the block's share of the launch: the partial of a last launch, the
// carry otherwise.
template <int kT>
__device__ __forceinline__ void range_carry_out(const Range& r, double fsum,
                                                double* partial, int slot) {
  if (r.last) {
    block_sum_store_n<kT>(fsum, partial + blockIdx.x, slot);
  } else {
    r.carry[static_cast<int64_t>(blockIdx.x) * kT + slot] = fsum;
  }
}

template <int kT>
__device__ __forceinline__ void range_carry_out(const Range& r, double fsum,
                                                double* partial) {
  range_carry_out<kT>(r, fsum, partial, threadIdx.x);
}

// -- the forward half of a frame, shared by grad_fused, minf_fused,
// grad_prb_fused, fwd and fwd_quad_stats. The first three must compute a
// frame's farplane
// and objective with the same arithmetic: a line search compares the
// objective of a gradient pass with the objectives of its candidates
// (minf_fused), and at a 1e-6 residual the objective is of the size of its
// own fp32 rounding. Computed the same way the rounding cancels between the
// two; computed two ways it does not, and the search stalls (a joint run to
// 1e-6 then takes 9 candidates an iteration instead of 5 and stops short of
// its target). fwd stores the same farplane, so a base it freezes or an
// Anderson candidate it makes rounds as the kernels that read it:
// minf_fused(0, base = fwd(psi)) equals minf_fused(psi) bit for bit.
// fwd_quad_stats forms the same farplane of a direction, so its statistics
// of x on fwd(x) are a == b == c bit for bit.

// fr <- psi[y:y+p, x:x+p] * prb[m], the patch alone: the padding is never
// written (fft2_frame takes it as zero). Ends with a barrier.
template <int kD, int kT>
__device__ __forceinline__ void fft_gather_patch(float2* fr, const float2* obj,
                                                 int n, const float2* pr,
                                                 int p) {
  for (int i = threadIdx.x; i < p * p; i += kT) {
    const int y = i / p, x = i - y * p;
    fr[fft_near_index<kD>(y, x)] =
        cmul(obj[static_cast<int64_t>(y) * n + x], pr[i]);
  }
  __syncthreads();
}

// z + base[i] where kBase (the frozen base farplane's pixel), else z.
template <bool kBase>
__device__ __forceinline__ float2 fft_add_base(float2 z, const float2* base,
                                               int i) {
  if constexpr (kBase) {
    const float2 b = base_at(base, i);
    z.x += b.x;
    z.y += b.y;
  }
  return z;
}

__device__ __forceinline__ float fft_intensity(float2 z) {
  return fmaf(z.x, z.x, z.y * z.y);
}

// Starts the copy of a measured frame (kD x kD floats, 16-byte aligned)
// into `staged` in shared memory; fft_forward_one_mode waits for it.
template <int kD, int kT>
__device__ __forceinline__ void fft_fetch_data(float* staged,
                                               const float* src) {
  for (int i = threadIdx.x; i < kD * kD / 4; i += kT) {
    cp_async16(staged + 4 * i, src + 4 * i);
  }
  cp_async_commit();
}

// The block's next frame after f that contributes (frames when none):
// masked and out-of-bounds positions are skipped as the frame loops skip
// them, so nothing is fetched for them.
__device__ __forceinline__ int64_t fft_next_frame(const int* scan, int64_t f,
                                                  int64_t frames, int nz,
                                                  int n, int p) {
  int64_t next = f + gridDim.x;
  while (next < frames &&
         !frame_valid(scan[2 * next], scan[2 * next + 1], nz, n, p)) {
    next += gridDim.x;
  }
  return next;
}

// One mode: the patch's farplane (+ base) in fr and this thread's share of
// the frame's objective, returned; with kWeight the frame is left as
// factor * far, ready for the inverse transform. The measured frame comes
// from `staged` (shared memory, fetched ahead with fft_fetch_data) when that
// is not null, else from `dat` in device memory, read once, coalesced. Ends
// with a barrier.
template <int kD, int kT, bool kBase, bool kWeight>
__device__ double fft_forward_one_mode(float2* fr, const float2* tw,
                                       const float2* tws, const float2* obj,
                                       int n, const float2* pr, int p,
                                       const float2* base, const float* dat,
                                       const float* staged, int model) {
  fft_gather_patch<kD, kT>(fr, obj, n, pr, p);
  fft2_frame<kD, kT, false>(fr, p, tw, tws);
  if (staged != nullptr) {  // block-uniform
    cp_async_wait_all();
    __syncthreads();
  }
  double sum = 0.0;
  for (int i = threadIdx.x; i < kD * kD; i += kT) {
    const int at = fft_far_index<kD>(i / kD, i % kD);
    const float2 z = fft_add_base<kBase>(fr[at], base, i);
    float factor;
    sum += pixel_objective(model, fft_intensity(z),
                           staged != nullptr ? staged[i] : __ldcs(dat + i),
                           &factor);
    if constexpr (kWeight) fr[at] = make_float2(z.x * factor, z.y * factor);
  }
  __syncthreads();
  return sum;
}

// Several modes, first pass: the intensity summed over the modes into
// `plane` (kD x kD floats in shared memory; thread i owns plane[i],
// plane[i + kT], ... throughout), which then receives the likelihood
// factor; returns this thread's share of the frame's objective. `prb` is
// the angle's (m, p, p) probe, `base` the position's (m, kD, kD) base
// frames. No barrier is needed after it: each thread has read and written
// only its own entries of the plane since the last one.
template <int kD, int kT, bool kBase>
__device__ double fft_forward_modes(float2* fr, float* plane,
                                    const float2* tw, const float2* tws,
                                    const float2* obj, int n,
                                    const float2* prb, int m, int p,
                                    const float2* base, const float* dat,
                                    int model) {
  for (int mm = 0; mm < m; ++mm) {
    fft_gather_patch<kD, kT>(fr, obj, n,
                             prb + static_cast<int64_t>(mm) * p * p, p);
    fft2_frame<kD, kT, false>(fr, p, tw, tws);
    const float2* b = kBase ? base + static_cast<int64_t>(mm) * kD * kD
                            : nullptr;
    for (int i = threadIdx.x; i < kD * kD; i += kT) {
      const float a = fft_intensity(fft_add_base<kBase>(
          fr[fft_far_index<kD>(i / kD, i % kD)], b, i));
      plane[i] = mm == 0 ? a : plane[i] + a;
    }
    __syncthreads();  // the next gather overwrites the frame
  }
  double sum = 0.0;
  for (int i = threadIdx.x; i < kD * kD; i += kT) {
    float factor;
    sum += pixel_objective(model, plane[i], __ldcs(dat + i), &factor);
    plane[i] = factor;
  }
  return sum;
}

// Several modes, second pass: one mode's farplane (+ base) again, weighted
// by the factor in `plane`, left in fr ready for the inverse transform: an
// FFT costs less than keeping the modes' farplanes in device memory would.
// Ends with a barrier.
template <int kD, int kT, bool kBase>
__device__ void fft_weighted_mode(float2* fr, const float* plane,
                                  const float2* tw, const float2* tws,
                                  const float2* obj, int n, const float2* pr,
                                  int p, const float2* base) {
  fft_gather_patch<kD, kT>(fr, obj, n, pr, p);
  fft2_frame<kD, kT, false>(fr, p, tw, tws);
  for (int i = threadIdx.x; i < kD * kD; i += kT) {
    const int at = fft_far_index<kD>(i / kD, i % kD);
    const float2 z = fft_add_base<kBase>(fr[at], base, i);
    fr[at] = make_float2(z.x * plane[i], z.y * plane[i]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The frame's FFT with fewer trips through shared memory: d = 128, one mode,
// 1024 threads (grad_fused.cu grad_fused_regs_kernel).
//
// fft2_frame makes four stages a transform, each a read and a write of the
// frame, with a block barrier after each; between the two transforms a
// likelihood pass reads and writes the frame once more, and the gather
// before and the crop's store after add a write and a read: about 20
// one-way sweeps of the frame and 12 barriers a frame. Here the same
// arithmetic, stage for stage, runs in fewer trips:
//   - the forward row pass's first stage takes psi * prb from device memory
//     straight into registers (fft_rows_forward_regs), and the inverse row
//     pass's second stage stores the crop from registers (fft_rows_inverse_
//     regs): no gather sweep, no crop sweep;
//   - the forward column pass's second stage, the likelihood and the inverse
//     column pass's first stage are one step of one thread on the 16 points
//     of one column task (fft_col_fused): the thread holding frequencies
//     u = k1 + 8 j (j = 0..15) of column v after the forward butterflies
//     weights them and runs the inverse butterflies on them at once;
//   - each warp owns four rows of the frame through both row passes (rows
//     r0, r0 + 8, r0 + 64, r0 + 72, r0 = 16 (w / 8) + w % 8), so the
//     exchange between a row pass's two stages is a __syncwarp, and so is
//     the one between the inverse row pass and the next frame's forward one.
// Twelve one-way sweeps of the frame a frame (a write, then five reads and
// writes, then a read) and four block barriers: after the forward row pass,
// after the forward column pass's first stage, after the fused step, after
// the inverse column pass's second stage.
//
// Bank conflicts: the 8-point row stages run 16 lanes along one row (the
// gather's loads and the crop's stores coalesce; the frame accesses are 16
// consecutive elements), the 16-point row stages run rows r and r + 8 on a
// half-warp (9 r and 9 (r + 8) fall 8 banks apart, as 8 tasks of a row
// cover 8 banks). The two row twiddle tables are laid out in the order the
// lanes read them (fft_regs_row_twiddles). The fused column step's half-warp
// takes the columns of frequencies v = 8 b + a and 8 (b + 8) + a (a = 0..7),
// which fall on 16 banks (fft_col(fft_pos(v)) = 17 a + b mod 16) and whose
// measured pixels fill whole 32-byte sectors; the prefetched measured frame
// is kept swizzled (fft_staged_index) so that a warp's 32 reads fall on 32
// banks. What streams through once -- the measured frame, the crop -- is
// tagged to leave the L2 first (l2_evict_first, __stcs).
//
// minf_fused.cu minf_fused_regs_kernel runs the forward half alone: the
// forward row pass, the forward column pass's first stage, then a
// forward-only column step (fft_col_forward: the second stage and the
// likelihood on a thread's 16 points, nothing written back). Six one-way
// sweeps a frame and three block barriers.

// Frequency v of the column task of thread slot rho (0..127) in the fused
// column step.
__device__ __forceinline__ int fft_regs_freq(int rho) {
  return 8 * ((rho >> 4) + 8 * ((rho >> 3) & 1)) + (rho & 7);
}

// The first of the four rows this thread's warp owns.
__device__ __forceinline__ int fft_regs_row0() {
  const int w = threadIdx.x >> 5;
  return 16 * (w >> 3) + (w & 7);
}

// The row of this lane's 8-point row task `it` (0 or 1): 16 lanes a row.
__device__ __forceinline__ int fft_regs_row8(int it) {
  return fft_regs_row0() + 8 * it + 64 * ((threadIdx.x >> 4) & 1);
}

// The row of this lane's 16-point row task: 8 lanes a row (k1 = lane % 8).
__device__ __forceinline__ int fft_regs_row16() {
  return fft_regs_row0() + 8 * ((threadIdx.x >> 3) & 1) +
         64 * ((threadIdx.x >> 4) & 1);
}

// twr[16 k1 + j2] = tws[j2 k1] (the forward row pass's first stage, lanes
// along j2) and twi[8 j2 + k1] = tws[j2 k1] (the inverse row pass's first
// stage, lanes along k1): copies, the same bits. Needs a barrier before it
// (after fft_load_twiddles); ends with one.
template <int kT>
__device__ inline void fft_regs_row_twiddles(const float2* tws, float2* twr,
                                             float2* twi) {
  for (int k = threadIdx.x; k < 128; k += kT) {
    twr[k] = tws[(k & 15) * (k >> 4)];
    twi[k] = tws[(k >> 3) * (k & 7)];
  }
  __syncthreads();
}

// Index into the staged measured frame (fft_fetch_data_swizzled) of its
// pixel i = u * 128 + v: bit 4 flipped where bit 6 is set, which keeps
// 16-byte groups whole.
__device__ __forceinline__ int fft_staged_index(int i) {
  return i ^ ((i >> 2) & 16);
}

// fft_fetch_data at d = 128 with the pixels at fft_staged_index, the
// measured frame's lines evicted first from the L2.
template <int kT>
__device__ __forceinline__ void fft_fetch_data_swizzled(float* staged,
                                                        const float* src) {
  const uint64_t policy = l2_evict_first();
  for (int i = threadIdx.x; i < 128 * 128 / 4; i += kT) {
    cp_async16(staged + fft_staged_index(4 * i), src + 4 * i, policy);
  }
  cp_async_commit();
}

// The forward row pass of the patch's rows y < p: fr <- (psi[y:y+p, x:x+p] *
// prb) transformed along the rows, the product read from device memory into
// registers (fft_lines_forward's two stages on fft2_frame's rows, the same
// arithmetic). Each warp works on its own rows only, so nothing but a
// __syncwarp separates the stages; the caller's next pass needs a barrier.
__device__ __forceinline__ void fft_rows_forward_regs(float2* fr,
                                                      const float2* obj,
                                                      int n,
                                                      const float2* pr, int p,
                                                      const float2* twr) {
  constexpr int kP = FftFrame<128>::pitch;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int y = fft_regs_row8(it), j2 = lane & 15;
    if (y < p) {
      float2 v[8];
#pragma unroll
      for (int j1 = 0; j1 < 8; ++j1) {
        const int e = 16 * j1 + j2;
        v[j1] = e < p ? cmul(__ldg(obj + static_cast<int64_t>(y) * n + e),
                             __ldg(pr + y * p + e))
                      : make_float2(0.f, 0.f);
      }
      fft_regs<8, false>(v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k1 = fft_bitrev<3>(i);
        fr[y * kP + fft_col(16 * k1 + j2)] = cmul(v[i], twr[16 * k1 + j2]);
      }
    }
  }
  __syncwarp();
  const int y = fft_regs_row16(), k1 = lane & 7;
  if (y < p) {
    float2 v[16];
#pragma unroll
    for (int j2 = 0; j2 < 16; ++j2) v[j2] = fr[y * kP + fft_col(16 * k1 + j2)];
    fft_regs<16, false>(v);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fr[y * kP + fft_col(16 * k1 + fft_bitrev<4>(i))] = v[i];
    }
  }
}

// One column task of the fused step: the forward column pass's second stage
// on column c's positions 16 k1 .. 16 k1 + 15, then weigh(j, z) on each of
// its points -- z the farplane pixel of frequency u = k1 + 8 j, taken in
// the order j = 0..15 -- which returns the point the inverse transform
// takes, then the inverse column pass's first stage on them (the same
// arithmetic as fft_lines_forward's second and fft_lines_inverse's first
// stage). Needs a barrier before it and one after it.
template <class Weigh>
__device__ __forceinline__ void fft_col_fused(float2* fr, const float2* tw,
                                              int c, int k1, Weigh weigh) {
  constexpr int kP = FftFrame<128>::pitch;
  float2* col = fr + fft_col(c);
  float2 v[16];
#pragma unroll
  for (int j2 = 0; j2 < 16; ++j2) v[j2] = col[(16 * k1 + j2) * kP];
  fft_regs<16, false>(v);
  // v[i] sits at position 16 k1 + fft_bitrev(i): frequency k1 + 8
  // fft_bitrev(i); the inverse stage reads position 16 k1 + j into w[j].
  float2 w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = weigh(j, v[fft_bitrev<4>(j)]);
  fft_regs<16, true>(w);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j2 = fft_bitrev<4>(i);
    col[(16 * k1 + j2) * kP] = cmul(w[i], conjf2(tw[j2 * k1]));
  }
}

// One column task of the forward-only step (minf_fused.cu
// minf_fused_regs_kernel): fft_col_fused's first half. The forward column
// pass's second stage on column c's positions 16 k1 .. 16 k1 + 15, then
// visit(j, z) on each of its points -- z the farplane pixel of frequency
// u = k1 + 8 j, in the order j = 0..15 -- and nothing written back: the
// same arithmetic as fft_lines_forward's second stage. Needs a barrier
// before it, and one after it before the frame is overwritten.
template <class Visit>
__device__ __forceinline__ void fft_col_forward(const float2* fr, int c,
                                                int k1, Visit visit) {
  constexpr int kP = FftFrame<128>::pitch;
  const float2* col = fr + fft_col(c);
  float2 v[16];
#pragma unroll
  for (int j2 = 0; j2 < 16; ++j2) v[j2] = col[(16 * k1 + j2) * kP];
  fft_regs<16, false>(v);
#pragma unroll
  for (int j = 0; j < 16; ++j) visit(j, v[fft_bitrev<4>(j)]);
}

// The inverse row pass of rows y < p, its crop stored from registers into
// nr (p x p): fft_lines_inverse's two stages on fft2_frame's rows, the same
// arithmetic. Needs a barrier before it; each warp works on its own rows
// only, and it ends with a __syncwarp, after which the next frame's
// fft_rows_forward_regs may overwrite them.
__device__ __forceinline__ void fft_rows_inverse_regs(float2* fr, int p,
                                                      const float2* twi,
                                                      float2* nr) {
  constexpr int kP = FftFrame<128>::pitch;
  const int lane = threadIdx.x & 31;
  {
    const int y = fft_regs_row16(), k1 = lane & 7;
    if (y < p) {
      float2 v[16];
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        v[k2] = fr[y * kP + fft_col(16 * k1 + k2)];
      }
      fft_regs<16, true>(v);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j2 = fft_bitrev<4>(i);
        fr[y * kP + fft_col(16 * k1 + j2)] =
            cmul(v[i], conjf2(twi[8 * j2 + k1]));
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int y = fft_regs_row8(it), j2 = lane & 15;
    if (y < p) {
      float2 v[8];
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) {
        v[k1] = fr[y * kP + fft_col(16 * k1 + j2)];
      }
      fft_regs<8, true>(v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = 16 * fft_bitrev<3>(i) + j2;
        if (e < p) __stcs(nr + y * p + e, v[i]);  // streamed: evict first
      }
    }
  }
  __syncwarp();
}

// Dynamic shared memory of the fused body: four twiddle tables, the frame
// and, with the prefetch, the staged measured frame.
constexpr size_t fft_regs_smem_bytes(int planes) {
  return sizeof(float2) * (4 * 128 + FftFrame<128>::size)
         + sizeof(float) * static_cast<size_t>(planes) * 128 * 128;
}

// Calls fn(kernel<D, T>, dynamic shared bytes) for the instantiation of
// detector side `d` and `threads` threads a block (512 at 16, 32 and 64,
// 1024 at 128: ops/_launch.py fft_threads), with `planes` float planes beside
// the frame;
// cudaErrorInvalidValue for a side or a thread count without a kernel.
// `Kernels` provides `template <int D, int T> static auto get()`.
template <class Kernels, class Fn>
int fft_dispatch(int d, int threads, int planes, Fn fn) {
#define TK_FFT_CASE(D, T)                                      \
  if (d == D && threads == T) {                                \
    return fn(Kernels::template get<D, T>(), fft_smem_bytes<D>(planes)); \
  }
  TK_FFT_CASE(16, 512)
  TK_FFT_CASE(32, 512)
  TK_FFT_CASE(64, 512)
  TK_FFT_CASE(128, 1024)
#undef TK_FFT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the chosen instantiation with up to 227 KiB of dynamic shared
// memory; returns the first CUDA error (0 on success).
template <class Kernels, class Params>
int fft_launch(const Params& q, int d, int threads, int planes, int grid,
               cudaStream_t st) {
  return fft_dispatch<Kernels>(
      d, threads, planes, [&](auto kernel, size_t smem) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid, threads, smem, st>>>(q);
        return static_cast<int>(cudaGetLastError());
      });
}

// Resident blocks per SM of the chosen instantiation and its dynamic
// shared memory in bytes; returns the CUDA error code.
template <class Kernels>
int fft_occupancy(int d, int threads, int planes, int* out,
                  int* smem_bytes) {
  return fft_dispatch<Kernels>(
      d, threads, planes, [&](auto kernel, size_t smem) {
        *smem_bytes = static_cast<int>(smem);
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, kernel, threads, smem));
      });
}

}  // namespace tk

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
