// Per-lane fused Taylor chain prediction: the draft of a depth-K chain.
//
// Replaces the TPU kernel taylor_predict_chain_2d
// (src/repro/kernels/taylor_predict.py:117, pallas_call at :138).
//
// diffs [m+1, R, C] (R = G·lanes, lane = row % lanes), w [m+1, K, lanes]
// f32 -> out [K, R, C] with out[k] = Σ_i w[i, k, lane]·diffs[i]. Each
// element of each position runs rt::fma_chain, the FMA chain of the
// depth-1 kernel (taylor_predict_lanes.cu), so position k is bitwise that
// kernel called with w[:, k].
//
// Bound on the card: bytes. The m+1 planes are read once for all K
// positions and K planes are written (2·(m+1+K) bytes per bf16 element);
// 2·(m+1)·K flops per element stay far below the ops-per-byte balance.
// Design: the tile walk of predict_tiles.cuh. A thread keeps
// its m+1 vectors of a tile in registers and loops over the K positions
// (one weight column, the chain, one 16-byte store each) while the
// block's next tile loads; weights that do not fit the block's staging
// area are read through L1, so K is bounded by nothing but the output.
#include "predict_tiles.cuh"

namespace {

namespace p = rt::predict;

template <class Tr, int M1>
__global__ void __launch_bounds__(p::kThreads)
predict_chain_kernel(const p::Args a) {
  p::tiles_body<Tr, M1, false>(a);
}

template <class Tr>
__global__ void __launch_bounds__(rt::kThreads)
predict_chain_kernel_elems(const p::Args a) {
  p::elems_body<Tr>(a);
}

// the tile kernel for m+1 orders
template <class Tr>
p::Kernel tiles_kernel(int m1) {
  switch (m1) {
    case 1: return predict_chain_kernel<Tr, 1>;
    case 2: return predict_chain_kernel<Tr, 2>;
    case 3: return predict_chain_kernel<Tr, 3>;
    case 4: return predict_chain_kernel<Tr, 4>;
    case 5: return predict_chain_kernel<Tr, 5>;
    case 6: return predict_chain_kernel<Tr, 6>;
    case 7: return predict_chain_kernel<Tr, 7>;
    default: return predict_chain_kernel<Tr, 8>;
  }
}

template <class Tr>
int launch(const void* diffs, const void* w, void* out, int m1, int K,
           int64_t R, int64_t C, int lanes, int vec, bool floor,
           cudaStream_t stream, int device) {
  p::Args a{};
  a.diffs = diffs;
  a.w = static_cast<const float*>(w);
  a.out = out;
  a.m1 = m1;
  a.K = K;
  a.lanes = lanes;
  a.R = R;
  a.C = C;
  return p::launch(tiles_kernel<Tr>(m1), predict_chain_kernel_elems<Tr>, a,
                   sizeof(typename Tr::storage), vec != 0, floor, stream,
                   device);
}

int entry(const void* diffs, const void* w, void* out, int dtype, int m1,
          int K, long long R, long long C, int lanes, int vec, void* stream,
          int device, bool floor) {
  if (m1 < 1 || m1 > p::kMaxOrders || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return launch<rt::BF16>(diffs, w, out, m1, K, R, C, lanes, vec, floor, s,
                            device);
  if (dtype == rt::kF32)
    return launch<rt::F32>(diffs, w, out, m1, K, R, C, lanes, vec, floor, s,
                           device);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched; R·⌈C / tile⌉ must
// stay below 2^32 tiles, else cudaErrorInvalidValue). The caller
// guarantees 1 <= m1 <= 8, K >= 1, contiguous buffers and, with vec,
// C % (16 / element size) == 0 and 16-byte aligned pointers.
extern "C" int taylor_predict_chain(const void* diffs, const void* w,
                                    void* out, int dtype, int m1, int K,
                                    long long R, long long C, int lanes,
                                    int vec, void* stream, int device) {
  return entry(diffs, w, out, dtype, m1, K, R, C, lanes, vec, stream, device,
               false);
}

// The launch floor: an empty kernel on the grid, block and shared memory
// the same arguments give taylor_predict_chain. Reads and writes nothing.
extern "C" int taylor_predict_chain_floor(const void* diffs, const void* w,
                                          void* out, int dtype, int m1, int K,
                                          long long R, long long C, int lanes,
                                          int vec, void* stream, int device) {
  return entry(diffs, w, out, dtype, m1, K, R, C, lanes, vec, stream, device,
               true);
}
