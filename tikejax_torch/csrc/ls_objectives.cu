// ls_objectives: the objective at every candidate step of a backtracking
// line search in one pass over two farplanes and the data, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_linesearch.py ls_objectives
// (_ls_kernel). By linearity of G the intensity at psi + gamma d is, per
// pixel, I(gamma) = a + 2 gamma b + gamma^2 c with
//   a = sum_m |fp|^2,  b = sum_m Re(conj(fp) fd),  c = sum_m |fd|^2
// of the held farplanes fp = G psi (+ base) and fd = G d. For each of the K
// steps gamma_k it sums over every pixel
//   gaussian: (sqrt(max(I, 0)) - sqrt(max(D, 0)))^2   (no epsilon)
//   poisson:  max(I, 0) - max(D, 0) log(max(I, 0) + 1e-8)
// As in the TPU kernel no position is masked: a masked dummy's frames are
// zero, so it adds its data term at every step.
//
// What bounds it: one read of both farplanes and the data (8 + 8 + 4 bytes
// a pixel, 5.4 GB at 16384 frames of 128^2: 1.6 ms at 3.35 TB/s). The K
// square roots (or logarithms) a pixel run on the special-function units:
// 4.6 G at K = 17 there, about 1.1 ms at 16 a clock per SM, under the byte
// bound. IEEE sqrtf and logf, as the plain version computes them.
//
// The kernel is frame-major (ls_objectives_frame_kernel<kK>, kK the step
// bucket the wrapper picks: the least of 1, 2, 4, 8, 17 and 33 that is >= K,
// with a uniform guard k < K). A block walks whole frames (f = blockIdx.x,
// stride gridDim.x), so no pixel index is divided; inside a frame thread j reads the pixel pairs
// i = j, j + kT, ..., two pairs at once: 16-byte streaming loads of fp and
// fd per mode and an 8-byte load of the data, 80 bytes in flight a thread.
// Each thread sums its pixels of the frame in float, in kK registers; at the
// frame's end a fixed-order warp butterfly (__shfl_xor_sync) and, per step,
// the warps' sums added in double, in warp order, to the block's own double
// accumulator in shared memory. At kK <= 17 the registers are capped at 64
// (4 blocks of 256 threads, 32 warps an SM). Where the frame has an odd
// number of pixels, or a pointer is not aligned for the wide loads, the same
// kernel reads one pixel at a time.
//
// It replaced a pixel-major kernel (a 64-bit division per pixel, kMaxK
// double accumulators always live): 8.7 ms at one step against the 1.6 ms
// bound on an H100 80GB HBM3 at 700 W, whatever K.
//
// Contract: each block sums its share in a fixed order into a block-owned
// double partial per step, and a second kernel sums the partials over the
// blocks in a fixed order: bitwise reproducible. K and the steps are runtime
// arguments (1 <= K <= 33).

#include "dft_frame.cuh"

namespace {

using namespace tk;

constexpr int kMaxK = 33;

// out[k] = sum over blocks b = 0..blocks-1, in that order, of
// partial[b * K + k], in double.
__global__ void sum_step_partials(const double* partial, float* out, int k,
                                  int blocks) {
  const int j = threadIdx.x;
  if (j >= k) return;
  double v = 0.0;
  for (int b = 0; b < blocks; ++b) v += partial[static_cast<int64_t>(b) * k + j];
  out[j] = static_cast<float>(v);
}

constexpr int kFrameThreads = 256;
constexpr int kWarps = kFrameThreads / 32;

struct FrameParams {
  const float2* fp;     // (t, s, m, d, d)
  const float2* fd;     // (t, s, m, d, d)
  const float* data;    // (t, s, d, d)
  const float* gammas;  // (K,)
  double* partial;      // gridDim.x * K block partials
  int64_t frames;       // t * s
  int dd, m, k, model;
  int wide;  // pair loads: dd even, fp and fd 16-byte, data 8-byte aligned
};

// The statistics of one pixel pair (or, with one pixel, its first half).
struct PairStats {
  float a[2], b[2], c[2], dv[2];
};

// Adds the K step terms of the pixels of `st` into acc; a pixel whose
// statistics and data are zero adds zero.
template <int kK, int kPix>
__device__ __forceinline__ void add_steps(float (&acc)[kK],
                                          const PairStats* st,
                                          const float* t2, const float* g2,
                                          int k_used, int model) {
  if (model == 0) {  // gaussian
    float sq[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) sq[j] = sqrtf(st[j / 2].dv[j % 2]);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (k < k_used) {
        const float tk = t2[k], gk = g2[k];
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const PairStats& s = st[j / 2];
          const float inten = fmaxf(
              fmaf(gk, s.c[j % 2], fmaf(tk, s.b[j % 2], s.a[j % 2])), 0.f);
          const float r = sqrtf(inten) - sq[j];
          acc[k] = fmaf(r, r, acc[k]);
        }
      }
    }
  } else {  // poisson
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (k < k_used) {
        const float tk = t2[k], gk = g2[k];
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const PairStats& s = st[j / 2];
          const float inten = fmaxf(
              fmaf(gk, s.c[j % 2], fmaf(tk, s.b[j % 2], s.a[j % 2])), 0.f);
          acc[k] += fmaf(-s.dv[j % 2], logf(inten + 1e-8f), inten);
        }
      }
    }
  }
}

// 4 blocks of 256 threads an SM (64 registers a thread) up to 17 steps; 33
// steps need more registers for their accumulators.
template <int kK>
__global__ void __launch_bounds__(kFrameThreads, kK <= 17 ? 4 : 3)
    ls_objectives_frame_kernel(FrameParams q) {
  __shared__ float t2[kK], g2[kK];      // 2 gamma_k, gamma_k^2
  __shared__ float wsum[kK][kWarps];    // the warps' sums of one frame
  __shared__ double bacc[kK];           // the block's partial, per step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < q.k) {
    const float g = q.gammas[threadIdx.x];
    t2[threadIdx.x] = 2.f * g;
    g2[threadIdx.x] = g * g;
    bacc[threadIdx.x] = 0.0;
  }
  __syncthreads();

  const int dd = q.dd, m = q.m;
  for (int64_t f = blockIdx.x; f < q.frames; f += gridDim.x) {
    float acc[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) acc[k] = 0.f;
    const float2* fpf = q.fp + f * m * dd;
    const float2* fdf = q.fd + f * m * dd;
    const float* dat = q.data + f * dd;
    if (q.wide) {  // block-uniform
      const int half = dd / 2;
      const float4* fp4 = reinterpret_cast<const float4*>(fpf);
      const float4* fd4 = reinterpret_cast<const float4*>(fdf);
      const float2* dat2 = reinterpret_cast<const float2*>(dat);
      for (int i = threadIdx.x; i < half; i += 2 * kFrameThreads) {
        PairStats st[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ii = i + u * kFrameThreads;
          const bool in = ii < half;
          const float2 d2 = in ? __ldcs(dat2 + ii) : make_float2(0.f, 0.f);
          st[u].dv[0] = fmaxf(d2.x, 0.f);
          st[u].dv[1] = fmaxf(d2.y, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            st[u].a[h] = st[u].b[h] = st[u].c[h] = 0.f;
          }
        }
        for (int mm = 0; mm < m; ++mm) {
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 w[2], z[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ii = i + u * kFrameThreads;
            const int64_t j = static_cast<int64_t>(mm) * half + ii;
            w[u] = ii < half ? __ldcs(fp4 + j) : zero;
            z[u] = ii < half ? __ldcs(fd4 + j) : zero;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 w0 = make_float2(w[u].x, w[u].y);
            const float2 w1 = make_float2(w[u].z, w[u].w);
            const float2 z0 = make_float2(z[u].x, z[u].y);
            const float2 z1 = make_float2(z[u].z, z[u].w);
            st[u].a[0] += fft_intensity(w0);
            st[u].a[1] += fft_intensity(w1);
            st[u].b[0] += fmaf(w0.x, z0.x, w0.y * z0.y);
            st[u].b[1] += fmaf(w1.x, z1.x, w1.y * z1.y);
            st[u].c[0] += fft_intensity(z0);
            st[u].c[1] += fft_intensity(z1);
          }
        }
        add_steps<kK, 4>(acc, st, t2, g2, q.k, q.model);
      }
    } else {  // one pixel at a time
      for (int i = threadIdx.x; i < dd; i += kFrameThreads) {
        PairStats st[1];
        st[0].dv[0] = fmaxf(__ldcs(dat + i), 0.f);
        st[0].a[0] = st[0].b[0] = st[0].c[0] = 0.f;
        for (int mm = 0; mm < m; ++mm) {
          const int64_t j = static_cast<int64_t>(mm) * dd + i;
          const float2 w = __ldcs(fpf + j), z = __ldcs(fdf + j);
          st[0].a[0] += fft_intensity(w);
          st[0].b[0] += fmaf(w.x, z.x, w.y * z.y);
          st[0].c[0] += fft_intensity(z);
        }
        add_steps<kK, 1>(acc, st, t2, g2, q.k, q.model);
      }
    }
    // The frame's sums: a fixed-order butterfly in each warp (every lane
    // ends with the same float), then the warps in order, in double.
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (k < q.k) {
        float v = acc[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, o);
        }
        if (lane == 0) wsum[k][warp] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < q.k) {
      double v = bacc[threadIdx.x];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += wsum[threadIdx.x][w];
      bacc[threadIdx.x] = v;
    }
    __syncthreads();  // the next frame overwrites wsum
  }
  if (threadIdx.x < q.k) {
    q.partial[static_cast<int64_t>(blockIdx.x) * q.k + threadIdx.x] =
        bacc[threadIdx.x];
  }
}

// Calls fn(kernel) for the instantiation of step bucket `bucket` (1, 2, 4,
// 8, 17 or 33; the caller picks it, ops/linesearch.py step_bucket);
// cudaErrorInvalidValue for any other value.
template <class Fn>
int frame_dispatch(int bucket, Fn fn) {
  switch (bucket) {
    case 1: return fn(ls_objectives_frame_kernel<1>);
    case 2: return fn(ls_objectives_frame_kernel<2>);
    case 4: return fn(ls_objectives_frame_kernel<4>);
    case 8: return fn(ls_objectives_frame_kernel<8>);
    case 17: return fn(ls_objectives_frame_kernel<17>);
    case kMaxK: return fn(ls_objectives_frame_kernel<kMaxK>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the frame-major kernel of step bucket `bucket` (1 <= k <=
// bucket) and the block sum on `stream` with `grid` blocks; returns the
// first cudaGetLastError() that is not 0 (0 on success). `partial` holds
// grid * k doubles; `out` (k,) receives the objectives. `wide` (0 or 1): the
// frames have an even number of pixels, fp and fd are 16-byte and data
// 8-byte aligned.
int tk_ls_objectives_frame(const void* fp, const void* fd, const void* data,
                           const void* gammas, void* partial, void* out,
                           int64_t frames, int m, int d, int k, int bucket,
                           int model, int wide, int grid, void* stream) {
  if (k < 1 || k > bucket) return static_cast<int>(cudaErrorInvalidValue);
  const FrameParams q{static_cast<const float2*>(fp),
                      static_cast<const float2*>(fd),
                      static_cast<const float*>(data),
                      static_cast<const float*>(gammas),
                      static_cast<double*>(partial), frames, d * d, m, k,
                      model, wide};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = frame_dispatch(bucket, [&](auto kernel) {
    kernel<<<grid, kFrameThreads, 0, st>>>(q);
    return static_cast<int>(cudaGetLastError());
  });
  if (err) return err;
  sum_step_partials<<<1, 64, 0, st>>>(static_cast<const double*>(partial),
                                      static_cast<float*>(out), k, grid);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the frame-major kernel of step bucket
// `bucket`; returns the CUDA error code.
int tk_ls_objectives_frame_blocks_per_sm(int bucket, int* out) {
  return frame_dispatch(bucket, [&](auto kernel) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kFrameThreads, 0));
  });
}

}  // extern "C"
