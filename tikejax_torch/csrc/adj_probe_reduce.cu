// adj_probe_reduce: the hybrid tier's adjoint with respect to the probe,
// after the inverse FFT (cuFFT, outside), for NVIDIA Hopper (sm_90a):
// gather the object patch of every position, conj-multiply it with the
// position's frames and sum over the positions, in one pass,
//   out[t, m, y, x] = sum_s conj(psi[t, sy + y, sx + x]) near[t, s, m, y, x].
//
// Replaces the TPU kernel tikejax/ops/pallas_kernels.py adj_probe_reduce
// (_adj_probe_kernel), whose sequential grid carries the sum in an output
// block resident in fast memory. Here nothing carries over between blocks,
// so the positions of an angle are cut into `groups` equal runs: block
// (chunk, group, angle) sums its run of positions for kPix * kThreads probe
// pixels per mode in registers and writes one partial; sum_block_partials
// (dft_frame.cuh) then adds the partials over the groups in a fixed order.
// A position whose scan row is < 0 (a masked dummy) or whose window leaves
// the object (invalid input) adds nothing, and neither its frames nor the
// object are read for it.
//
// The frames are read in place through their strides (in complex elements;
// the innermost stride is 1), as in scatter_conj_probe.cu.
//
// What bounds it: bytes. Every frame pixel is read once (8 bytes a pixel
// and mode, 2.1 GB at 16384 frames of 128^2: 0.64 ms at 3.35 TB/s); the
// object (2 MiB at 512^2) stays in L2, and each thread keeps kPix
// independent 8-byte loads in flight per position. The partials are
// groups * t * m * p^2 complex values (8 MiB at the headline).
//
// Contract: bitwise reproducible: the run of positions of a block, the
// order within it and the order over the groups depend on the shapes alone.

#include "dft_frame.cuh"

namespace {

using namespace tk;

constexpr int kPix = 4;  // probe pixels per thread

struct Params {
  const float2* nearp;  // (t, s, m, p, p) through the strides below
  const float2* psi;    // (t, nz, n)
  const int* scan;      // (t, s, 2) int (y, x)
  float2* acc;          // (groups, t, m, p, p) partials
  int t, s, nz, n, m, p, groups;
  int64_t st_t, st_s, st_m, st_row;  // strides of nearp, complex elements
};

__global__ void __launch_bounds__(kThreads) adj_probe_reduce_kernel(Params q) {
  const int p = q.p, m = q.m;
  const int pp = p * p;
  const int th = blockIdx.z, group = blockIdx.y;
  const int per = (q.s + q.groups - 1) / q.groups;
  const int s0 = group * per, s1 = min(q.s, s0 + per);

  int pix[kPix], row[kPix], col[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    pix[j] = (blockIdx.x * kPix + j) * kThreads + threadIdx.x;
    row[j] = pix[j] / p;
    col[j] = pix[j] - row[j] * p;
  }
  const int* scan = q.scan + 2 * static_cast<int64_t>(th) * q.s;
  const float2* obj = q.psi + static_cast<int64_t>(th) * q.nz * q.n;
  const float2* frames = q.nearp + th * q.st_t;

  for (int mm = 0; mm < m; ++mm) {
    float2 sum[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) sum[j] = make_float2(0.f, 0.f);
    for (int si = s0; si < s1; ++si) {
      const int sy = scan[2 * si], sx = scan[2 * si + 1];
      if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
      const float2* fr = frames + si * q.st_s + mm * q.st_m;
      const float2* patch = obj + static_cast<int64_t>(sy) * q.n + sx;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (pix[j] < pp) {
          const float2 v = cmul(
              conjf2(patch[static_cast<int64_t>(row[j]) * q.n + col[j]]),
              fr[row[j] * q.st_row + col[j]]);
          sum[j].x += v.x;
          sum[j].y += v.y;
        }
      }
    }
    float2* out = q.acc + ((static_cast<int64_t>(group) * q.t + th) * m + mm) * pp;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (pix[j] < pp) out[pix[j]] = sum[j];
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel and the sum over the groups on `stream`; returns the
// first cudaGetLastError() that is not 0 (0 on success). `acc` holds
// groups * t*m*p*p complex floats (the kernel writes all of them); `out`
// (t, m, p, p) receives the sum. The strides of `nearp` are in complex
// elements. `groups` is at most 65535, `t` too (grid dimensions y and z).
int tk_adj_probe_reduce(const void* nearp, const void* psi, const void* scan,
                        void* out, void* acc, int t, int s, int nz, int n,
                        int m, int p, int groups, int64_t st_t, int64_t st_s,
                        int64_t st_m, int64_t st_row, void* stream) {
  Params q{static_cast<const float2*>(nearp), static_cast<const float2*>(psi),
           static_cast<const int*>(scan), static_cast<float2*>(acc),
           t, s, nz, n, m, p, groups, st_t, st_s, st_m, st_row};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_block = kPix * kThreads;
  const dim3 grid((p * p + per_block - 1) / per_block, groups, t);
  adj_probe_reduce_kernel<<<grid, kThreads, 0, st>>>(q);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t total = static_cast<int64_t>(t) * m * p * p;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  sum_block_partials<float2><<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(acc), static_cast<float2*>(out), total,
      groups);
  return static_cast<int>(cudaGetLastError());
}

// Probe pixels one block covers per mode (kPix * kThreads).
int tk_adj_probe_reduce_pixels_per_block() { return kPix * kThreads; }

}  // extern "C"
