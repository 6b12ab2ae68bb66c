// lbfgs: the L-BFGS search direction of the CG solver in two passes over
// memory, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's two-loop recursion
// (tikejax/solvers/cg.py lbfgs_direction) is jnp in a fori_loop, 2m + 1
// inner products and 2m axpys, each a pass over an object-sized array.
// Here the recursion runs on the host, in double, on inner products that
// one pass reads (the compact form of the two-loop; solvers/cg.py
// _Engine.lbfgs_direction), and one more pass writes the direction:
//
//   lbfgs_gram     the real inner products <a, b> = sum Re(a) Re(b) +
//                  Im(a) Im(b) of the new gradient g and the new pair
//                  s = gamma d_prev, y = g - g_prev (formed here from d_prev,
//                  g and g_prev) against every ring slot S_0..S_{m-1},
//                  Y_0..Y_{m-1} and against g, s, y: 3 (2m + 3) values.
//   lbfgs_combine  d = -(c_g g + sum_k a_k S_k + b_k Y_k), and in the same
//                  pass the accepted pair (s, y) stored into its ring slot.
//
// Both take complex64 (float2) or complex128 (double2) arrays. The ring is
// (m, planes, plane) elements, the others (planes, plane); the Gram reads
// only the first `owned` elements of every plane (the owned rows of an
// object slab under object tiling: the halo rows mirror the next slab's and
// must count once), the combination writes every element.
//
// What bounds them: bytes. At 512^2 complex64 (2 MiB an array) and m = 8
// the Gram reads (2m + 3) x 2 MiB = 38 MiB and the combination reads
// (2m + 1) x 2 MiB and writes 3 x 2 MiB (d and the stored pair) = 40 MiB:
// 11.9 and 12.5 us at 3.35 TB/s. Slots whose two coefficients are both 0
// (the invalid ones while the ring fills, or rho = 0) are not read.
//
// Determinism: every product is formed in double from the stored values;
// a block sums its chunk in a fixed order (each thread its elements in
// order, a warp butterfly, the warps in order) into a block-owned partial,
// and a second kernel sums the partials of each output over the chunks in
// a fixed order (lane-strided, then a warp butterfly). No atomics: two runs
// give the same bits. The combination sums c_g g and the slots in slot
// order in double and rounds once.

#include "dft_frame.cuh"

namespace {

constexpr int kMaxM = 32;  // the largest ring direction='lbfgs:<m>' takes
constexpr int kGramThreads = 256;
constexpr int kGramWarps = kGramThreads / 32;
constexpr int kSumThreads = 256;
constexpr int kCombineThreads = 256;

template <typename R>
struct Cplx;
template <>
struct Cplx<float> {
  using T = float2;
};
template <>
struct Cplx<double> {
  using T = double2;
};

struct GramParams {
  const void* S;      // (m, planes, plane) ring
  const void* Y;      // (m, planes, plane) ring
  const void* g;      // (planes, plane)
  const void* gp;     // g_prev
  const void* dp;     // d_prev
  double* partial;    // (outputs, chunks) block partials
  double gamma;       // s = gamma * d_prev, gamma rounded to the real type
  int64_t slot;       // elements of a ring slot: planes * plane
  int64_t plane;      // elements of a plane
  int64_t owned;      // elements of a plane that count: the first `owned`
  int chunk;          // elements a block sums
  int per_plane;      // chunks a plane: ceil(owned / chunk)
  int m;
};

template <typename T>
__device__ __forceinline__ double rdot(T a, T b) {
  return static_cast<double>(a.x) * static_cast<double>(b.x) +
         static_cast<double>(a.y) * static_cast<double>(b.y);
}

// The block's NL sums, in a fixed order, stored at out[l * stride].
template <int NL>
__device__ __forceinline__ void block_store(double (&v)[NL], double* out,
                                            int64_t stride) {
  __shared__ double red[NL][kGramWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[l] += __shfl_xor_sync(0xffffffffu, v[l], off);
    if (lane == 0) red[l][warp] = v[l];
  }
  __syncthreads();
  if (threadIdx.x < NL) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kGramWarps; ++w) s += red[threadIdx.x][w];
    out[threadIdx.x * stride] = s;
  }
}

// The first element of chunk blockIdx.y and its length.
__device__ __forceinline__ int64_t chunk_start(const GramParams& q,
                                               int64_t* len) {
  const int c = blockIdx.y;
  const int p = c / q.per_plane;
  const int64_t first = static_cast<int64_t>(c - p * q.per_plane) * q.chunk;
  const int64_t left = q.owned - first;
  *len = left < q.chunk ? left : q.chunk;
  return p * q.plane + first;
}

// Grid (2m + 3, chunks): block (j, c) sums <g, v_j>, <s, v_j>, <y, v_j> over
// chunk c, v = (S_0..S_{m-1}, Y_0..Y_{m-1}, g, s, y). The blocks of a chunk
// are neighbours in launch order, so g, g_prev and d_prev come from L2
// after the first of them.
template <typename R>
__global__ void __launch_bounds__(kGramThreads) gram_kernel(GramParams q) {
  using T = typename Cplx<R>::T;
  const int j = blockIdx.x, m = q.m;
  int64_t len;
  const int64_t base = chunk_start(q, &len);
  const T* g = static_cast<const T*>(q.g) + base;
  const T* gp = static_cast<const T*>(q.gp) + base;
  const T* dp = static_cast<const T*>(q.dp) + base;
  const T* r = j < m ? static_cast<const T*>(q.S) + j * q.slot + base
               : j < 2 * m
                   ? static_cast<const T*>(q.Y) + (j - m) * q.slot + base
                   : nullptr;
  const int formed = j - 2 * m;  // 0: g, 1: s, 2: y (where r is null)
  const R gam = static_cast<R>(q.gamma);
  double acc[3] = {0.0, 0.0, 0.0};
  for (int64_t i = threadIdx.x; i < len; i += kGramThreads) {
    const T gv = __ldg(g + i), gpv = __ldg(gp + i), dpv = __ldg(dp + i);
    T s, y;
    s.x = gam * dpv.x;
    s.y = gam * dpv.y;
    y.x = gv.x - gpv.x;
    y.y = gv.y - gpv.y;
    const T rv = r != nullptr ? __ldg(r + i)
                 : formed == 0 ? gv
                 : formed == 1 ? s
                               : y;
    acc[0] += rdot(gv, rv);
    acc[1] += rdot(s, rv);
    acc[2] += rdot(y, rv);
  }
  const int64_t chunks = gridDim.y;
  block_store<3>(acc, q.partial + j * chunks + blockIdx.y,
                 static_cast<int64_t>(gridDim.x) * chunks);
}

// out[o] = the sum over c of partial[o * chunks + c]: a warp an output,
// lane-strided sums in order, then a butterfly; lane 0 stores.
__global__ void __launch_bounds__(kSumThreads)
    sum_partials(const double* partial, double* out, int outputs,
                 int chunks) {
  const int o = (blockIdx.x * kSumThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (o >= outputs) return;  // warp-uniform
  const double* p = partial + static_cast<int64_t>(o) * chunks;
  double v = 0.0;
  for (int c = lane; c < chunks; c += 32) v += p[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) out[o] = v;
}

struct CombineParams {
  void* S;          // (m, n) ring
  void* Y;          // (m, n) ring
  const void* g;    // (n,)
  const void* gp;   // g_prev, read only where a pair is stored
  const void* dp;   // d_prev, read only where a pair is stored
  void* out;        // (n,) the direction
  double gamma;
  double cg;
  double a[kMaxM];  // coefficients of S_k, by slot
  double b[kMaxM];  // coefficients of Y_k, by slot
  int64_t n;        // elements of a slot
  int m;
  int slot;         // where (s, y) is stored; < 0: no pair
};

// The slots run in an unrolled loop over kMaxM with a uniform guard, so
// that every coefficient is read from the parameter bank at a fixed offset.
template <typename R>
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(CombineParams q) {
  using T = typename Cplx<R>::T;
  T* S = static_cast<T*>(q.S);
  T* Y = static_cast<T*>(q.Y);
  const T* g = static_cast<const T*>(q.g);
  const T* gp = static_cast<const T*>(q.gp);
  const T* dp = static_cast<const T*>(q.dp);
  T* out = static_cast<T*>(q.out);
  const R gam = static_cast<R>(q.gamma);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kCombineThreads;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kCombineThreads) +
                   threadIdx.x;
       e < q.n; e += stride) {
    const T gv = __ldg(g + e);
    double ax = q.cg * static_cast<double>(gv.x);
    double ay = q.cg * static_cast<double>(gv.y);
    T s = gv, y = gv;
    if (q.slot >= 0) {
      const T gpv = __ldg(gp + e), dpv = __ldg(dp + e);
      s.x = gam * dpv.x;
      s.y = gam * dpv.y;
      y.x = gv.x - gpv.x;
      y.y = gv.y - gpv.y;
      S[q.slot * q.n + e] = s;
      Y[q.slot * q.n + e] = y;
    }
#pragma unroll
    for (int k = 0; k < kMaxM; ++k) {
      if (k < q.m) {
        const double ak = q.a[k], bk = q.b[k];
        if (ak != 0.0) {
          const T v = k == q.slot ? s : S[k * q.n + e];
          ax += ak * static_cast<double>(v.x);
          ay += ak * static_cast<double>(v.y);
        }
        if (bk != 0.0) {
          const T v = k == q.slot ? y : Y[k * q.n + e];
          ax += bk * static_cast<double>(v.x);
          ay += bk * static_cast<double>(v.y);
        }
      }
    }
    T d;
    d.x = static_cast<R>(-ax);
    d.y = static_cast<R>(-ay);
    out[e] = d;
  }
}

template <typename R>
int launch_gram(GramParams q, double* out, cudaStream_t stream) {
  const int chunks = (int)(q.per_plane * (q.slot / q.plane));
  const int right = 2 * q.m + 3;
  const int outputs = 3 * right;
  gram_kernel<R><<<dim3(right, chunks), kGramThreads, 0, stream>>>(q);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int blocks = (outputs * 32 + kSumThreads - 1) / kSumThreads;
  sum_partials<<<blocks, kSumThreads, 0, stream>>>(q.partial, out, outputs,
                                                    chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The Gram pass: two launches (the blocks' partials, then their sums) into
// out, 3 (2m + 3) doubles ordered (left g, s, y) x (right S_0..S_{m-1},
// Y_0..Y_{m-1}, g, s, y). partial holds outputs x planes x
// ceil(owned / chunk) doubles. wide = 1 for complex128. Returns the first CUDA error (0 on
// success).
int tk_lbfgs_gram(const void* S, const void* Y, const void* g, const void* gp,
                  const void* dp, double gamma, void* partial, void* out,
                  int64_t slot, int64_t plane, int64_t owned, int chunk,
                  int m, int wide, void* stream) {
  if (m < 1 || m > kMaxM || chunk < 1 || plane < 1 || owned < 1 ||
      owned > plane || slot % plane != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GramParams q;
  q.S = S;
  q.Y = Y;
  q.g = g;
  q.gp = gp;
  q.dp = dp;
  q.partial = static_cast<double*>(partial);
  q.gamma = gamma;
  q.slot = slot;
  q.plane = plane;
  q.owned = owned;
  q.chunk = chunk;
  q.per_plane = static_cast<int>((owned + chunk - 1) / chunk);
  q.m = m;
  if (static_cast<int64_t>(q.per_plane) * (slot / plane) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
  return wide ? launch_gram<double>(q, o, st) : launch_gram<float>(q, o, st);
}

// The combination pass: one launch. a and b are m host doubles each (the
// coefficients of S_k and Y_k by slot); slot < 0 stores no pair.
int tk_lbfgs_combine(void* S, void* Y, const void* g, const void* gp,
                     const void* dp, void* out, double gamma, double cg,
                     const double* a, const double* b, int64_t n, int m,
                     int slot, int wide, int grid, void* stream) {
  if (m < 1 || m > kMaxM || slot >= m || grid < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CombineParams q;
  q.S = S;
  q.Y = Y;
  q.g = g;
  q.gp = gp;
  q.dp = dp;
  q.out = out;
  q.gamma = gamma;
  q.cg = cg;
  for (int k = 0; k < kMaxM; ++k) {
    q.a[k] = k < m ? a[k] : 0.0;
    q.b[k] = k < m ? b[k] : 0.0;
  }
  q.n = n;
  q.m = m;
  q.slot = slot;
  auto st = static_cast<cudaStream_t>(stream);
  if (wide) {
    combine_kernel<double><<<grid, kCombineThreads, 0, st>>>(q);
  } else {
    combine_kernel<float><<<grid, kCombineThreads, 0, st>>>(q);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
