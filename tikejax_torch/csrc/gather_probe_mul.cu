// gather_probe_mul: the hybrid tier's forward nearplane, for NVIDIA Hopper
// (sm_90a): gather the object patch of every scan position and multiply it
// by every probe mode, in one pass,
//   near[t, s, m, y, x] = psi[t, sy + y, sx + x] * prb[t, m, y, x].
// The unitary FFT of the (zero-padded) frames follows outside, in cuFFT.
//
// Replaces the TPU kernel tikejax/ops/pallas_kernels.py gather_probe_mul
// (_gather_mul_kernel). That kernel's aligned power-of-two windows, object
// padding and sublane/lane rotates serve Mosaic's (8, 128) alignment and
// have no counterpart: a patch row here is a plain unaligned run of
// interleaved complex64. A position whose scan row is < 0 (a masked dummy)
// or whose window leaves the object (invalid input) gets zero frames, and
// the object is not read for it.
//
// What bounds it: bytes. The nearplane is written once (8 bytes a pixel and
// mode, 2.1 GB at 16384 frames of 128^2: 0.64 ms at 3.35 TB/s); the object
// (2 MiB at 512^2) stays in L2, and the arithmetic is one complex multiply
// a pixel.
//
// The kernel (gather_probe_mul_persistent_kernel) spends its device-memory
// traffic on the write alone. A block owns one mode and one
// chunk of the patch -- a unit (a pixel pair when p is even, a pixel when
// it is odd) for each of kUnits x 256 threads -- and walks a fixed share of
// the frames. Each thread works out its units' patch rows and columns once,
// so the frame loop has no division by p, and holds their probe values in
// registers for every frame of an angle (the probe is not re-read per
// frame). For each frame it issues all its object loads -- 16 bytes a pair
// where the patch corner is 16-byte aligned (n even, the object aligned and
// the corner offset even: block-uniform), else 8 bytes a pixel -- before
// its multiplies, and writes the products with 16-byte (8 at an odd p)
// streaming stores, so the 2.1 GB output does not evict the object from
// L2. A masked frame is written as zeros by the same stores. The next
// frame's position is fetched a frame ahead. With several modes each block
// takes one mode and the object patch is read once a mode (from L2).
//
// Offsets are 64-bit: the nearplane passes 2^31 floats at 4 modes x 16384 x
// 128^2. Contract: the product is dft_frame.cuh cmul(object, probe);
// bitwise reproducible (no reduction).

#include "dft_frame.cuh"

namespace {

using namespace tk;

struct Params {
  const float2* psi;   // (t, nz, n)
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float2* out;         // (t, s, m, p, p)
  int t, s, nz, n, m, p;
  int vec;             // psi 16-byte aligned and n even
};

constexpr int kUnits = 4;  // units a thread owns
constexpr int kChunk = kThreads * kUnits;

// kW neighbouring complex pixels at `src`: one 16-byte load for a pair when
// `vec` (src then 16-byte aligned), else 8 bytes a pixel.
template <int kW>
__device__ __forceinline__ void load_unit(const float2* src, bool vec,
                                          float2 (&v)[kW]) {
  if constexpr (kW == 2) {
    if (vec) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = make_float2(w.x, w.y);
      v[1] = make_float2(w.z, w.w);
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < kW; ++w) v[w] = __ldg(src + w);
}

// kW neighbouring complex pixels to `dst` (16-byte aligned for a pair) in
// one streaming store.
template <int kW>
__device__ __forceinline__ void store_unit(float2* dst,
                                           const float2 (&v)[kW]) {
  if constexpr (kW == 2) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(v[0].x, v[0].y, v[1].x, v[1].y));
  } else {
    __stcs(dst, v[0]);
  }
}

// kW = 2 (pixel pairs; p even) or 1 (pixels; p odd). blockIdx.y = mode *
// chunks + chunk; blockIdx.x walks the frames with stride gridDim.x. Thread
// j owns units chunk * kChunk + j + k * kThreads, k < kUnits, of the patch.
template <int kW>
__global__ void __launch_bounds__(kThreads, 4)
    gather_probe_mul_persistent_kernel(Params q) {
  const int p = q.p, n = q.n, m = q.m;
  const int64_t pp = static_cast<int64_t>(p) * p;
  const int units = static_cast<int>(pp / kW);
  const int chunks = gridDim.y / m;
  const int mm = blockIdx.y / chunks;
  const int first = (blockIdx.y - mm * chunks) * kChunk + threadIdx.x;

  // Each unit's pixel offset in the frame and in the object from the patch
  // corner; -1 past the patch.
  int near_at[kUnits], obj_at[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = first + k * kThreads;
    const int i = u * kW, y = i / p;
    near_at[k] = u < units ? i : -1;
    obj_at[k] = y * n + (i - y * p);
  }

  float2 pr[kUnits][kW];
  int th_held = -1;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  const int2* scan = reinterpret_cast<const int2*>(q.scan);
  int2 next = __ldg(scan + blockIdx.x);
  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int2 pos = next;  // (y, x)
    if (f + gridDim.x < frames) next = __ldg(scan + f + gridDim.x);
    float2* out = q.out + (f * m + mm) * pp;
    if (!frame_valid(pos.x, pos.y, q.nz, n, p)) {  // block-uniform
      float2 zero[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w) zero[w] = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        if (near_at[k] >= 0) store_unit<kW>(out + near_at[k], zero);
      }
      continue;
    }
    const int th = static_cast<int>(f / q.s);
    if (th != th_held) {  // block-uniform; once an angle
      const float2* prb = q.prb + (static_cast<int64_t>(th) * m + mm) * pp;
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        if (near_at[k] >= 0) load_unit<kW>(prb + near_at[k], false, pr[k]);
      }
      th_held = th;
    }
    const int64_t corner =
        (static_cast<int64_t>(th) * q.nz + pos.x) * n + pos.y;
    const float2* obj = q.psi + corner;
    const bool vec = q.vec && (corner & 1) == 0;  // block-uniform
    float2 a[kUnits][kW];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (near_at[k] >= 0) load_unit<kW>(obj + obj_at[k], vec, a[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (near_at[k] >= 0) {
#pragma unroll
        for (int w = 0; w < kW; ++w) a[k][w] = cmul(a[k][w], pr[k][w]);
        store_unit<kW>(out + near_at[k], a[k]);
      }
    }
  }
}

template <int kW>
int launch_persistent(const Params& q, cudaStream_t st) {
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;
  const int64_t units = static_cast<int64_t>(q.p) * q.p / kW;
  const int64_t ys = (units + kChunk - 1) / kChunk * q.m;
  if (ys > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_probe_mul_persistent_kernel<kW>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // One wave: as many frame groups as the card holds beside the mode and
  // chunk blocks, at most one per frame.
  int64_t groups = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms / ys;
  groups = groups < 1 ? 1 : (groups > frames ? frames : groups);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(ys));
  gather_probe_mul_persistent_kernel<kW><<<grid, kThreads, 0, st>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the persistent kernel on `stream` (pixel pairs when p is even,
// pixels when it is odd), its grid from the card's occupancy; returns the
// first CUDA error (0 on success). `vec`: psi is 16-byte aligned and n
// even.
int tk_gather_probe_mul(const void* psi, const void* prb, const void* scan,
                        void* out, int t, int s, int nz, int n, int m, int p,
                        int vec, void* stream) {
  Params q{static_cast<const float2*>(psi), static_cast<const float2*>(prb),
           static_cast<const int*>(scan), static_cast<float2*>(out),
           t, s, nz, n, m, p, vec};
  if (static_cast<int64_t>(t) * s == 0 || m == 0 || p == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p % 2 == 0 ? launch_persistent<2>(q, st)
                    : launch_persistent<1>(q, st);
}

}  // extern "C"
