// scatter_conj_probe: the hybrid tier's adjoint with respect to the object,
// after the inverse FFT (cuFFT, outside), for NVIDIA Hopper (sm_90a):
// conj-probe multiply, mode sum and overlap scatter-add in one pass,
//   out[t, sy + y, sx + x] += sum_m conj(prb[t, m, y, x]) near[t, s, m, y, x].
//
// Replaces the TPU kernel tikejax/ops/pallas_kernels.py scatter_conj_probe
// (_scatter_kernel), whose grid walks the positions of an angle in scan
// order and adds each window into an object held in fast memory; its
// zero-margined rotated read-modify-write of aligned windows serves
// Mosaic's alignment and has no counterpart. A position whose scan row is
// < 0 (a masked dummy) or whose window leaves the object (invalid input)
// adds nothing, and its frames are not read.
//
// The frames are read in place through their strides (in complex elements;
// the innermost stride is 1): the caller hands the top-left p x p crop of
// the d x d inverse-FFT frames as a strided view, and a contiguous copy of
// it would be one more pass over all frames. Offsets are 64-bit: the frames
// pass 2^31 floats at 4 modes x 16384 x 128^2.
//
// Two kernels compute it; every call launches the first, the second only
// when the caller forces it (ops/kernels.py, variant='atomic'), to time the
// two in turns.
//
// The tile kernel (scatter_conj_probe_tile_kernel) owns the object: a
// block owns one angle's tile of 8 x 32 pixels, one a thread, and sums into
// registers the contribution of every position whose window covers it,
// then stores each pixel of the tile once -- zero where no window covers it
// -- with no atomics. It finds those positions with no list in memory: the
// block walks its angle's scan in chunks of 256 positions, one a thread;
// each thread tests whether its position's window meets the tile, and a
// warp ballot and a prefix over the warps' counts in shared memory compact
// the hits, in scan order, into a list that every thread then works
// through before the next chunk (whose positions are loaded while it
// does). A chunk whose bounding box of corners (ops/kernels.py
// scatter_box_plan, made once per scan), widened by the window, misses the
// tile is skipped whole: the walk then costs a block the chunks near its
// tile, not its angle's whole scan, which on a larger object would cost
// more than the frames (tiles x positions: 16384 x 16384 at a 2048^2
// object). Skipping whole chunks leaves the hits in scan order: the same
// bits with or without the skip. The list holds each hit's corner and its frame and probe offsets
// less the corner, so a thread's addresses are one add from offsets it
// computes once a tile. A thread issues the probe and frame loads of kK
// listed positions and kM modes at once (12 pixel loads in flight: kK = 12
// at one mode, 6 at two, 3 at three or four), then forms each position's
// mode sum and adds the positions to its accumulator in list order. The
// window test is per thread and predicates the loads (no branch): a pixel
// outside a window loads nothing and adds nothing. A warp reads one tile
// row, 256 bytes of a frame row; the probe comes through the read-only
// cache.
//
// The atomic kernel (scatter_conj_probe_atomic_kernel) is the one it
// replaced: one block per frame, one pair of fp32 atomics a pixel
// (dft_frame.cuh scatter_add_pixel) into a zeroed object.
//
// What bounds it: bytes. Every frame pixel is read once (8 bytes a pixel
// and mode, 2.1 GB at 16384 frames of 128^2: 0.64 ms at 3.35 TB/s): a
// frame pixel lands in exactly one tile. Beside them the tile kernel reads
// the scan of the chunks near each tile (without the skip, the whole scan
// once a tile: tiles x positions x 8 bytes, from L2, 134 MB at 16384
// positions and 1024 tiles of a 512^2 object, 6.25% of the frame bytes, a
// share of tiles / (modes p^2) that grows with the object) and writes the
// object once (2 MiB). The probe is read beside
// every frame pixel, from L1/L2. On an H100 80GB HBM3 (700 W) the tile
// kernel reaches about 60% of that bound at the headline: the walk over the
// scan, the per-position arithmetic and the probe loads are issued beside
// the frame loads and do not all hide behind them (PERF.md times each
// part).
//
// Accuracy: a pixel sums its positions in double and is rounded to fp32
// once, when it is stored. At 128^2 a pixel of the headline sums about a
// thousand overlapping frames; summed in fp32 the running sum's rounding
// put adj at 3.9-5.6e-7 of scale against a complex128 oracle, past the
// 4e-7 of the fused_hp tier (PERF.md). Each contribution -- the mode sum
// of cmul(conj(prb), near), as the atomic kernel forms it -- stays fp32.
//
// Contract: the tile kernel is bitwise repeatable: each pixel sums its
// positions' contributions in increasing scan order (the TPU kernel's
// order). A launch on one chunk of positions may store its running sums in
// double into `part` instead of rounding them into `out`, and a launch
// with from_partial starts each pixel from the sum `part` holds: a launch
// on each chunk of positions in turn, each after the one before, adds
// exactly what one launch on all of them adds, in the same order and the
// same precision, so gives its bits (the frames of adj.cu, grad_fused.cu
// and adj_residual.cu come this way, chunk by chunk). A block whose tile no
// window of the chunk meets touches neither `part` nor `out`, unless it
// must round into `out`: a chunk of positions that meets a band of rows
// costs the other blocks only the walk over its scan. The atomic kernel is
// deterministic only up to the order in which the atomics land.

#include <type_traits>

#include "dft_frame.cuh"

namespace {

using namespace tk;

constexpr int kWarps = kThreads / 32;

struct Params {
  const float2* nearp; // (t, s, m, p, p) through the strides below
  const float2* prb;   // (t, m, p, p)
  const int* scan;     // (t, s, 2) int (y, x)
  float* out;          // (t, nz, n) complex as interleaved re/im floats;
                       // the tile kernel rounds into it where not null
  double* part;        // (t, nz, n) complex as interleaved re/im doubles:
                       // the tile kernel's running sums (may be null)
  // The tile kernel's chunk boxes: for each angle and each chunk of kThreads
  // consecutive positions of its whole scan, (ymin, xmin, ymax, xmax) of
  // the chunk's valid corners (an empty chunk's meets no tile), box_chunks
  // an angle; null walks every chunk.
  const int4* boxes;
  int t, s, nz, n, m, p;
  int64_t st_t, st_s, st_m, st_row;  // strides of nearp, complex elements
  int tiles_y, tiles_x;              // the tile kernel's tiles of an angle
  int from_partial;  // the tile kernel: continue from the sums in `part`
  int box_chunks;
  // Index of this launch's first position in its angle's whole scan: the
  // walk's chunks are the boxes' chunks, multiples of kThreads positions
  // of that scan, so a launch on part of a scan starts with a part chunk.
  int first;
};

// -- the tile kernel ----------------------------------------------------

// The tile: kTileH rows x kTileW columns of an angle's object, one pixel a
// thread (a warp reads a tile row, 256 bytes of a frame row). On an H100
// (700 W) it beat tiles of 16 x 16 and 32 x 32 (PERF.md).
constexpr int kTileH = 8, kTileW = 32;
static_assert(kTileH * kTileW == kThreads, "one pixel a thread");

// Pixel-mode loads a thread keeps in flight: kK listed positions x kM
// modes of them. On an H100 (700 W) 12 with two resident blocks an SM beat
// 8 and 16, and 8 with three (PERF.md).
constexpr int kLoads = 12;

// The complex pixel at `src` where `want`, else zero: a predicated load,
// not a branch, so the compiler can issue a batch's loads back to back.
// Frames stream through once (ld.global.cs, evict first); the probe is
// read again and again, through the read-only cache (ld.global.nc).
__device__ __forceinline__ float2 load_frame(const float2* src, bool want) {
  float2 v = make_float2(0.f, 0.f);
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "@p ld.global.cs.v2.f32 {%0, %1}, [%2];\n\t}"
      : "+f"(v.x), "+f"(v.y)
      : "l"(src), "r"(static_cast<unsigned>(want)));
  return v;
}

__device__ __forceinline__ float2 load_probe(const float2* src, bool want) {
  float2 v = make_float2(0.f, 0.f);
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "@p ld.global.nc.v2.f32 {%0, %1}, [%2];\n\t}"
      : "+f"(v.x), "+f"(v.y)
      : "l"(src), "r"(static_cast<unsigned>(want)));
  return v;
}

// Block b owns the unit (angle, tile) b. A position's modes are taken kM
// at a time (kM = 1, 2 or 4 by the number of modes), kK = kLoads / kM
// listed positions together; scan (8-byte aligned) is read as int2.
template <int kM>
__global__ void __launch_bounds__(kThreads, 2)
    scatter_conj_probe_tile_kernel(Params q) {
  constexpr int kK = kLoads / kM;
  // A listed hit: its corner (sy, sx), its probe offset sy p + sx, and its
  // frame's offset in nearp less sy st_row + sx, so that the frame pixel
  // of object pixel (Y, X) is at hit_frame + Y st_row + X.
  __shared__ int2 hit_pos[kThreads];
  __shared__ int hit_prb[kThreads];
  __shared__ long long hit_frame[kThreads];
  __shared__ int warp_hits[kWarps];

  const int p = q.p, m = q.m;
  const int64_t pp = static_cast<int64_t>(p) * p;
  const int tiles = q.tiles_y * q.tiles_x;
  const int th = blockIdx.x / tiles, tile = blockIdx.x - th * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int2 none = make_int2(-1, -1);

  const int ty = tile / q.tiles_x;
  const int y0 = ty * kTileH, x0 = (tile - ty * q.tiles_x) * kTileW;
  const int y1 = min(y0 + kTileH, q.nz), x1 = min(x0 + kTileW, q.n);
  const int row = y0 + threadIdx.x / kTileW, col = x0 + threadIdx.x % kTileW;
  const int prb_at = row * p + col;
  const int64_t frame_at = row * q.st_row + col;
  const bool inside = row < y1 && col < x1;
  const int64_t pixel = (static_cast<int64_t>(th) * q.nz + row) * q.n + col;
  float2* const dst =
      q.out == nullptr ? nullptr : reinterpret_cast<float2*>(q.out) + pixel;
  double2* const part =
      q.part == nullptr ? nullptr : reinterpret_cast<double2*>(q.part) + pixel;
  // The pixel's sum in double. Continuing from the sums that a launch on
  // the positions before these stored (the same adds, in the same order and
  // precision, as one launch on all), it is read at the first hit of the
  // block, so a block that no window meets reads nothing. `started` is
  // block-uniform.
  double2 acc = make_double2(0.0, 0.0);
  bool started = !q.from_partial;
  const int2* scan = reinterpret_cast<const int2*>(q.scan) +
                     static_cast<int64_t>(th) * q.s;
  const float2* prb = q.prb + static_cast<int64_t>(th) * m * pp;
  const float2* frames = q.nearp + th * q.st_t;

  // Chunk c holds this launch's positions c kThreads - lead + [0, kThreads)
  // (those in [0, s)); a chunk whose box, widened by the window, misses the
  // tile holds no position whose window meets it and is skipped whole, so
  // the hits stay in scan order. Block-uniform.
  const int lead = q.first % kThreads;
  const int chunks = (lead + q.s + kThreads - 1) / kThreads;
  const int4* box =
      q.boxes == nullptr
          ? nullptr
          : q.boxes + static_cast<int64_t>(th) * q.box_chunks +
                q.first / kThreads;
  auto next_chunk = [&](int c) {
    for (; c < chunks && box != nullptr; ++c) {
      const int4 b = __ldg(box + c);  // (ymin, xmin, ymax, xmax)
      if (b.x < y1 && b.z + p > y0 && b.y < x1 && b.w + p > x0) break;
    }
    return c;
  };
  auto position = [&](int c) {
    const int i = c * kThreads - lead + static_cast<int>(threadIdx.x);
    return c < chunks && i >= 0 && i < q.s ? __ldg(scan + i) : none;
  };

  int c = next_chunk(0);
  int2 ahead = position(c);
  while (c < chunks) {
    // Compact this chunk's positions whose window meets the tile, in scan
    // order (masked and invalid positions never meet it).
    const int i = c * kThreads - lead + static_cast<int>(threadIdx.x);
    const int2 pos = ahead;  // (y, x)
    const bool hit = frame_valid(pos.x, pos.y, q.nz, q.n, p) && pos.x < y1 &&
                     pos.x + p > y0 && pos.y < x1 && pos.y + p > x0;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = warp_hits[w];
      before += w < warp ? h : 0;
      total += h;
    }
    if (hit) {
      const int at = before + __popc(ballot & ((1u << lane) - 1u));
      hit_pos[at] = pos;
      hit_prb[at] = pos.x * p + pos.y;
      hit_frame[at] =
          static_cast<long long>(i) * q.st_s - pos.x * q.st_row - pos.y;
    }
    const int next = next_chunk(c + 1);
    ahead = position(next);
    __syncthreads();
    if (total > 0 && !started) {
      if (inside) acc = *part;
      started = true;
    }

    for (int j = 0; j < total; j += kK) {
      // The window test per thread: a pixel outside a window loads nothing
      // and adds nothing. Inside the window implies inside the object and
      // the tile, since the window lies in the object. A slot past the
      // list (block-uniform) reads hit j and adds nothing.
      bool in[kK];
      int po[kK];
      long long fo[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const bool live = j + k < total;
        const int at = live ? j + k : j;
        const int2 hp = hit_pos[at];
        po[k] = hit_prb[at];
        fo[k] = hit_frame[at];
        in[k] = live &&
                static_cast<unsigned>(col - hp.y) < static_cast<unsigned>(p) &&
                static_cast<unsigned>(row - hp.x) < static_cast<unsigned>(p);
      }
      float2 g[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) g[k] = make_float2(0.f, 0.f);
      for (int m0 = 0; m0 < m; m0 += kM) {
        float2 a[kK][kM], b[kK][kM];
#pragma unroll
        for (int k = 0; k < kK; ++k)
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            const int mm = m0 + mi;
            const bool want = (kM == 1 || mm < m) && in[k];
            a[k][mi] = load_probe(prb + mm * pp + (prb_at - po[k]), want);
            b[k][mi] =
                load_frame(frames + (fo[k] + mm * q.st_m + frame_at), want);
          }
        // Each position's modes in order, from zero.
#pragma unroll
        for (int k = 0; k < kK; ++k)
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            if (kM == 1 || m0 + mi < m) {
              const float2 v = cmul(conjf2(a[k][mi]), b[k][mi]);
              g[k].x += v.x;
              g[k].y += v.y;
            }
          }
      }
      // The positions in list order, so in scan order.
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (in[k]) {
          acc.x += static_cast<double>(g[k].x);
          acc.y += static_cast<double>(g[k].y);
        }
      }
    }
    __syncthreads();  // the list is rewritten by the next chunk
    c = next;
  }

  if (!started) {
    // No window of these positions meets the tile: the running sums stand
    // as they are, unless this launch rounds them into `out`.
    if (dst == nullptr) return;
    if (inside) acc = *part;
  }
  if (!inside) return;
  if (dst != nullptr) {
    *dst = make_float2(static_cast<float>(acc.x), static_cast<float>(acc.y));
  } else {
    *part = acc;
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// The instantiations: modes taken 1, 2 or 4 at a time; fn(Int<M>) gets the
// one asked for.
template <class Fn>
int mode_dispatch(int mode_chunk, Fn fn) {
  switch (mode_chunk) {
    case 1: return fn(Int<1>{});
    case 2: return fn(Int<2>{});
    case 4: return fn(Int<4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- the atomic kernel --------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    scatter_conj_probe_atomic_kernel(Params q) {
  const int p = q.p, m = q.m;
  const int pp = p * p;
  const int64_t frames = static_cast<int64_t>(q.t) * q.s;

  for (int64_t f = blockIdx.x; f < frames; f += gridDim.x) {
    const int th = static_cast<int>(f / q.s);
    const int64_t si = f - static_cast<int64_t>(th) * q.s;
    const int sy = q.scan[2 * f], sx = q.scan[2 * f + 1];
    if (!frame_valid(sy, sx, q.nz, q.n, p)) continue;
    const float2* fr = q.nearp + th * q.st_t + si * q.st_s;
    const float2* prb = q.prb + static_cast<int64_t>(th) * m * pp;
    for (int i = threadIdx.x; i < pp; i += kThreads) {
      const int y = i / p, x = i - y * p;
      const float2* px = fr + y * q.st_row + x;
      float2 g = make_float2(0.f, 0.f);
      for (int mm = 0; mm < m; ++mm) {
        const float2 v = cmul(conjf2(__ldg(prb + mm * pp + i)), px[mm * q.st_m]);
        g.x += v.x;
        g.y += v.y;
      }
      scatter_add_pixel(q.out, th, q.nz, q.n, sy + y, sx + x, g);
    }
  }
}

}  // namespace

extern "C" {

// Launches the tile kernel on `stream`, one block per (angle, tile),
// taking the modes `mode_chunk` (1, 2 or 4) at a time; tiles_y and tiles_x
// must cut nz and n into tiles of kTileH x kTileW. With `out` (complex64,
// t x nz x n) it rounds every pixel's sum into `out`, which needs no
// zeroing; with `out` null it stores the sums in double into `part`
// (complex128, t x nz x n). With from_partial 1 each pixel continues from
// the sum `part` holds. `scan` must be 8-byte aligned. The strides of
// `nearp` are in complex elements. `first` is the index of `scan`'s first
// position in its angle's whole scan; `boxes` (16-byte aligned int32, t x
// box_chunks x 4, box_chunks covering positions [0, first + s) of that
// scan, or null to walk every chunk) are the chunk boxes of the whole
// scan. Returns the first CUDA error (0 on success).
int tk_scatter_conj_probe(const void* nearp, const void* prb, const void* scan,
                          void* out, void* part, const void* boxes, int t,
                          int s, int nz, int n, int m, int p, int64_t st_t,
                          int64_t st_s, int64_t st_m, int64_t st_row,
                          int tiles_y, int tiles_x, int mode_chunk,
                          int from_partial, int box_chunks, int first,
                          void* stream) {
  Params q{static_cast<const float2*>(nearp),
           static_cast<const float2*>(prb),
           static_cast<const int*>(scan),
           static_cast<float*>(out),
           static_cast<double*>(part),
           static_cast<const int4*>(boxes),
           t, s, nz, n, m, p, st_t, st_s, st_m, st_row, tiles_y, tiles_x,
           from_partial, box_chunks, first};
  if (static_cast<int64_t>(t) * nz * n == 0) return 0;
  if ((out == nullptr && part == nullptr) ||
      (from_partial && part == nullptr) || first < 0 ||
      (boxes != nullptr &&
       (static_cast<int64_t>(first) + s + kThreads - 1) / kThreads >
           box_chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = static_cast<int64_t>(t) * tiles_y * tiles_x;
  if (tiles_y != (nz + kTileH - 1) / kTileH ||
      tiles_x != (n + kTileW - 1) / kTileW || grid > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mode_dispatch(mode_chunk, [&](auto km) {
    scatter_conj_probe_tile_kernel<decltype(km)::value>
        <<<static_cast<int>(grid), kThreads, 0, st>>>(q);
    return static_cast<int>(cudaGetLastError());
  });
}

// Resident blocks per SM of the tile kernel's instantiation for
// `mode_chunk` in *per_sm; returns the CUDA error code.
int tk_scatter_conj_probe_blocks_per_sm(int mode_chunk, int* per_sm) {
  return mode_dispatch(mode_chunk, [&](auto km) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, scatter_conj_probe_tile_kernel<decltype(km)::value>, kThreads,
        0));
  });
}

// Launches the atomic kernel on `stream`, one block per frame
// (grid-strided past 2^31 - 1 frames); returns cudaGetLastError() (0 on
// success). `out` must be zeroed.
int tk_scatter_conj_probe_atomic(const void* nearp, const void* prb,
                                 const void* scan, void* out, int t, int s,
                                 int nz, int n, int m, int p, int64_t st_t,
                                 int64_t st_s, int64_t st_m, int64_t st_row,
                                 void* stream) {
  Params q{static_cast<const float2*>(nearp),
           static_cast<const float2*>(prb),
           static_cast<const int*>(scan),
           static_cast<float*>(out),
           nullptr,
           nullptr,
           t, s, nz, n, m, p, st_t, st_s, st_m, st_row, 0, 0, 0, 0, 0};
  const int64_t frames = static_cast<int64_t>(t) * s;
  if (frames == 0) return 0;
  const int grid = static_cast<int>(frames < 2147483647 ? frames : 2147483647);
  scatter_conj_probe_atomic_kernel<<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
