// ls_objectives: the objective at every candidate step of a backtracking
// line search in one pass over two farplanes and the data, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel tikejax/ops/pallas_linesearch.py ls_objectives
// (_ls_kernel). By linearity of G the intensity at psi + gamma d is, per
// pixel, I(gamma) = a + 2 gamma b + gamma^2 c with
//   a = sum_m |fp|^2,  b = sum_m Re(conj(fp) fd),  c = sum_m |fd|^2
// of the held farplanes fp = G psi (+ base) and fd = G d. Every thread walks
// the pixels (grid-stride, neighbouring threads on neighbouring pixels),
// forms a, b, c and adds, for each of the K steps gamma_k,
//   gaussian: (sqrt(max(I, 0)) - sqrt(max(D, 0)))^2   (no epsilon)
//   poisson:  max(I, 0) - max(D, 0) log(max(I, 0) + 1e-8)
// into its own accumulator. As in the TPU kernel no position is masked:
// a masked dummy's frames are zero, so it adds its data term at every step.
//
// What bounds it: one read of both farplanes and the data (8 + 8 + 4 bytes
// a pixel, 5.4 GB at 16384 frames of 128^2: 1.6 ms at 3.35 TB/s); the
// K square roots (or logarithms) a pixel run on the special-function units,
// about 1 ms there at K = 17. The K accumulators live in registers (the
// loop over the steps is unrolled to kMaxK with a uniform guard), so the
// data are read once whatever K is.
//
// Contract: each thread sums in double; each block sums its threads in
// double in a fixed order into a block-owned partial per step, and a second
// kernel sums the partials over the blocks in a fixed order: bitwise
// reproducible. K and the steps are runtime arguments (K <= kMaxK).

#include "dft_frame.cuh"

namespace {

using namespace tk;

constexpr int kMaxK = 33;

struct Params {
  const float2* fp;     // (t, s, m, d, d)
  const float2* fd;     // (t, s, m, d, d)
  const float* data;    // (t, s, d, d)
  const float* gammas;  // (K,)
  double* partial;      // gridDim.x * K block partials
  int64_t pixels;       // t * s * d * d
  int64_t dd;           // d * d
  int m, k, model;
};

__global__ void __launch_bounds__(kThreads) ls_objectives_kernel(Params q) {
  __shared__ float gam[kMaxK];
  if (threadIdx.x < q.k) gam[threadIdx.x] = q.gammas[threadIdx.x];
  __syncthreads();

  double acc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) acc[k] = 0.0;

  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t px = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       px < q.pixels; px += step) {
    const int64_t f = px / q.dd, i = px - f * q.dd;
    float a = 0.f, b = 0.f, c = 0.f;
    for (int mm = 0; mm < q.m; ++mm) {
      const int64_t j = (f * q.m + mm) * q.dd + i;
      const float2 w = __ldg(q.fp + j), z = __ldg(q.fd + j);
      a += w.x * w.x + w.y * w.y;
      b += w.x * z.x + w.y * z.y;
      c += z.x * z.x + z.y * z.y;
    }
    const float dv = fmaxf(__ldg(q.data + px), 0.f);
    const float sq = sqrtf(dv);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < q.k) {
        const float g = gam[k];
        const float inten = fmaxf(a + 2.f * g * b + g * g * c, 0.f);
        float term;
        if (q.model == 0) {  // gaussian
          const float r = sqrtf(inten) - sq;
          term = r * r;
        } else {  // poisson
          term = inten - dv * logf(inten + 1e-8f);
        }
        acc[k] += term;
      }
    }
  }

  double* out = q.partial + static_cast<int64_t>(blockIdx.x) * q.k;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < q.k) block_sum_store(acc[k], out + k);
  }
}

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

}  // namespace

extern "C" {

// Launches the kernel and the block sum on `stream` with `grid` blocks;
// returns the first cudaGetLastError() that is not 0 (0 on success).
// `partial` holds grid * k doubles; `out` (k,) receives the objectives.
// Needs 1 <= k <= 33.
int tk_ls_objectives(const void* fp, const void* fd, const void* data,
                     const void* gammas, void* partial, void* out,
                     int64_t pixels, int m, int d, int k, int model,
                     int grid, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  Params q{static_cast<const float2*>(fp), static_cast<const float2*>(fd),
           static_cast<const float*>(data), static_cast<const float*>(gammas),
           static_cast<double*>(partial), pixels,
           static_cast<int64_t>(d) * d, m, k, model};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ls_objectives_kernel<<<grid, kThreads, 0, st>>>(q);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  sum_step_partials<<<1, 64, 0, st>>>(static_cast<const double*>(partial),
                                      static_cast<float*>(out), k, grid);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM (`d` and `has_base` are unused); returns the CUDA
// error code.
int tk_ls_objectives_blocks_per_sm(int d, int has_base, int* out) {
  (void)d;
  (void)has_base;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ls_objectives_kernel, kThreads, 0));
}

}  // extern "C"
