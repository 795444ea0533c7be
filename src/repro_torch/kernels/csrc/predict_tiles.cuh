// The body the lane predict (taylor_predict_lanes.cu) and the chain
// predict (taylor_predict_chain.cu) share: a 1-D walk over the table's
// tiles.
//
// diffs [m1, R, C] (lane = row % lanes), w [m1, K, lanes] f32 -> out
// [K, R, C] with out[k] = Σ_i w[i, k, lane]·diffs[i]: the lane predict is
// K = 1 (its w [m1, lanes] is that layout). Every element runs
// rt::fma_chain in the order i = 0..m1-1, so each position is bitwise the
// lane predict called with that position's weights, on every path.
//
// Bound on the card: bytes (m1 planes read once, K written; 2·m1·K flops
// an element). The design it replaces (one block a row × 2,048-element
// chunk on a 2-D grid) reached 88 % of that bound in the lane predict
// but 67 % in the chain: each of the chain's 32,256 blocks at the
// DiT-XL/2 table loaded its weights into shared memory and synced before
// its first table load, so a block held nothing in flight for a round
// trip (on an H100 its K = 1 run took 0.243 ms where the lane predict
// took 0.179, tools/predict_ab.py); and rows on gridDim.y capped R at
// 65,535.
//
// Design (vector path). A tile is one row × kThreads 16-byte vectors of
// each plane; a 1-D tile index (no row cap) is walked with a stride of the
// grid, each block taking about kTilesPerBlock tiles (never fewer blocks
// than fill the SMs). A thread loads its vector of each plane of its
// block's next tile while it computes and stores the K positions of this
// one from registers; the weights go to shared memory once a block (when
// m1·K·lanes fit kWeightFloats, else they are read through L1), after its
// first loads are issued, so their round trip overlaps the table's.
// Measured on the H100 (tools/predict_ab.py, PERF.md), this matched or
// beat rings of tile slots in shared memory filled by per-thread cp.async
// or by one thread's 1-D bulk copies (cp.async.bulk on an mbarrier), the
// chain's positions staged in shared memory and written by bulk stores
// (a block barrier a position, where a 16-byte store does not wait), and
// a persistent grid of as many blocks as fit the SMs, whose fixed shares
// of tiles finish unevenly. A row whose bytes are not a multiple of 16
// (or an unaligned buffer) takes the element path: a grid-stride loop,
// one element a thread.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace rt {
namespace predict {
namespace {

constexpr int kMaxOrders = 8;
constexpr int kThreads = 128;               // one 16-byte vector of each
                                            // plane a thread a tile
constexpr int kChunkBytes = 16 * kThreads;  // a plane's part of a tile
constexpr int kTilesPerBlock = 4;           // tiles a block walks
constexpr int kWeightFloats = 1024;         // weights staged in shared memory
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

// --- the tile walk -------------------------------------------------------

struct Args {
  const void* diffs;
  const float* w;
  void* out;
  int m1, K, lanes;
  int64_t R, C;
  int64_t chunk;    // elements of one plane's part of a tile
  uint32_t nchunk;  // tiles a row
  int64_t tiles;    // R · nchunk, below 2^32: a tile's row and lane take
                    // 32-bit division on the path to its first load
  int staged;       // the weights fit kWeightFloats: read from shared memory
};

// kOne: K is 1 (the lane predict). Thread tid handles vector tid of each
// plane's part of a tile: every load and store coalesced.
template <class Tr, int M1, bool kOne>
__device__ __forceinline__ void tiles_body(const Args& a) {
  using S = typename Tr::storage;
  using V = Vec<Tr>;
  extern __shared__ float sw[];               // the staged weights
  const int tid = threadIdx.x;
  const int K = kOne ? 1 : a.K;
  const int64_t plane = a.R * a.C, step = gridDim.x;
  const S* diffs = static_cast<const S*>(a.diffs);
  S* out = static_cast<S*>(a.out);
  // a tile's row, first column and lane, and whether this thread's vector
  // is in it (a row's last tile may be short)
  struct Tile {
    int64_t row, c0;
    int lane;
    bool live;
  };
  auto tile = [&](int64_t t) {
    const uint32_t t32 = static_cast<uint32_t>(t);
    const uint32_t r = t32 / a.nchunk;
    Tile x;
    x.row = r;
    x.c0 = static_cast<int64_t>(t32 - r * a.nchunk) * a.chunk;
    x.lane = static_cast<int>(r % static_cast<uint32_t>(a.lanes));
    x.live = static_cast<int64_t>(tid) * V::N < a.C - x.c0;
    return x;
  };
  // this thread's vector of each plane of tile t, into registers
  auto load = [&](V* d, int64_t t) {
    const Tile x = tile(t);
    if (x.live) {
      const S* src = diffs + x.row * a.C + x.c0 + tid * V::N;
#pragma unroll
      for (int i = 0; i < M1; ++i) d[i].load(src + i * plane);
    }
  };

  V d[M1];
  if (blockIdx.x < a.tiles) load(d, blockIdx.x);
  // the weights, while the first tile loads
  const float* ws = a.w;
  if (a.staged) {
    for (int i = tid; i < M1 * K * a.lanes; i += blockDim.x)
      sw[i] = __ldg(a.w + i);
    __syncthreads();
    ws = sw;
  }
  for (int64_t t = blockIdx.x; t < a.tiles; t += step) {
    V nd[M1];                   // the block's next tile, in flight
    if (t + step < a.tiles) load(nd, t + step);
    const Tile x = tile(t);
    if (x.live) {
      S* dst = out + x.row * a.C + x.c0 + tid * V::N;
      float wl[M1];
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int i = 0; i < M1; ++i)
          wl[i] = ws[(static_cast<int64_t>(i) * K + k) * a.lanes + x.lane];
        V o;
#pragma unroll
        for (int e = 0; e < V::N; ++e)
          o.s[e] = Tr::store(fma_chain<M1>(
              wl, M1, [&](int i) { return Tr::load(d[i].s[e]); }));
        o.store(dst + k * plane);
      }
    }
#pragma unroll
    for (int i = 0; i < M1; ++i) d[i] = nd[i];
  }
}

// The element path: a grid-stride loop, one element a thread.
template <class Tr>
__device__ __forceinline__ void elems_body(const Args& a) {
  using S = typename Tr::storage;
  const S* diffs = static_cast<const S*>(a.diffs);
  S* out = static_cast<S*>(a.out);
  const int64_t plane = a.R * a.C;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < plane; e += step) {
    const int lane = static_cast<int>((e / a.C) % a.lanes);
    float x[kMaxOrders];
#pragma unroll
    for (int i = 0; i < kMaxOrders; ++i)
      x[i] = i < a.m1 ? Tr::load(diffs[i * plane + e]) : 0.f;
    for (int k = 0; k < a.K; ++k) {
      float wl[kMaxOrders];
#pragma unroll
      for (int i = 0; i < kMaxOrders; ++i)
        wl[i] = i < a.m1
                    ? __ldg(a.w + (static_cast<int64_t>(i) * a.K + k) *
                                      a.lanes + lane)
                    : 0.f;
      out[k * plane + e] = Tr::store(
          fma_chain<kMaxOrders>(wl, a.m1, [&](int i) { return x[i]; }));
    }
  }
}

__global__ void floor_kernel() {}

// --- the launch ----------------------------------------------------------

using Kernel = void (*)(Args);

inline int sm_count(int device, int* n) {
  static int cached[64] = {0};
  int& c = cached[device & 63];
  if (c == 0) {
    const int e = static_cast<int>(cudaDeviceGetAttribute(
        &c, cudaDevAttrMultiProcessorCount, device));
    if (e) {
      c = 0;
      return e;
    }
  }
  *n = c;
  return 0;
}

// Blocks of a tile kernel resident on one SM, read once a kernel.
inline int resident(Kernel fn, size_t smem, int* n) {
  static Kernel seen[64];
  static int count[64];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (seen[i] == fn) {
      *n = count[i];
      return 0;
    }
  int blocks = 0;
  const int e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, kThreads, smem));
  if (e) return e;
  *n = std::max(1, blocks);
  if (used < 64) {
    seen[used] = fn;
    count[used++] = *n;
  }
  return 0;
}

// Launch the predict on args a with elements of es bytes, or (floor) an
// empty kernel on the same grid, block and shared memory: the launch
// floor of this design. tiles: the tile kernel for a.m1; elems: the
// element path. Returns the cudaError_t (0 = launched).
inline int launch(Kernel tiles, Kernel elems, Args a, int es, bool vec,
                  bool floor, cudaStream_t stream, int device) {
  if (a.R < 1 || a.C < 1 || a.K < 1 || a.lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int e = sm_count(device, &sms);
  if (e) return e;
  if (!vec) {
    const int64_t blocks = (a.R * a.C + rt::kThreads - 1) / rt::kThreads;
    const unsigned grid = static_cast<unsigned>(
        std::min<int64_t>(blocks, static_cast<int64_t>(sms) * 8));
    if (floor) {
      floor_kernel<<<grid, rt::kThreads, 0, stream>>>();
    } else {
      elems<<<grid, rt::kThreads, 0, stream>>>(a);
    }
    return launched();
  }
  a.chunk = kChunkBytes / es;
  const int64_t nchunk = (a.C + a.chunk - 1) / a.chunk;
  a.tiles = a.R * nchunk;
  if (a.tiles > UINT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.nchunk = static_cast<uint32_t>(nchunk);
  a.staged = static_cast<int64_t>(a.m1) * a.K * a.lanes <= kWeightFloats;
  const size_t smem = kWeightFloats * sizeof(float);
  int per_sm = 0;
  e = resident(tiles, smem, &per_sm);
  if (e) return e;
  // about kTilesPerBlock tiles a block, never fewer blocks than fill the
  // SMs (or than there are tiles)
  const unsigned grid = static_cast<unsigned>(std::max<int64_t>(
      std::min<int64_t>(a.tiles, static_cast<int64_t>(sms) * per_sm),
      (a.tiles + kTilesPerBlock - 1) / kTilesPerBlock));
  if (floor) {
    floor_kernel<<<grid, kThreads, smem, stream>>>();
  } else {
    tiles<<<grid, kThreads, smem, stream>>>(a);
  }
  return launched();
}

}  // namespace
}  // namespace predict
}  // namespace rt
