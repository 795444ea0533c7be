// Per-lane fused Taylor prediction: the SpeCa draft.
//
// Replaces the TPU kernel taylor_predict_lanes_2d
// (src/repro/kernels/taylor_predict.py:70, pallas_call at :88).
//
// diffs [m+1, R, C] (R = G·lanes, lane = row % lanes), w [m+1, lanes] f32
// -> out [R, C] = Σ_i w[i, lane]·diffs[i], accumulated in f32 in the order
// i = 0..m as one FMA chain per element, then cast to the table dtype.
// Weights of orders that are not yet valid are exactly 0.0 and are
// multiplied all the same, like the reference.
//
// Bound on the card: bytes. It reads the m+1 planes once and writes one
// plane (2·(m+1+1) bytes per bf16 element) and does 2·(m+1) flops per
// element, far below the H100's ops-per-byte balance. Design: the tile
// walk of predict_tiles.cuh at K = 1.
#include "predict_tiles.cuh"

namespace {

namespace p = rt::predict;

template <class Tr, int M1>
__global__ void __launch_bounds__(p::kThreads)
predict_lanes_kernel(const p::Args a) {
  p::tiles_body<Tr, M1, true>(a);
}

template <class Tr>
__global__ void __launch_bounds__(rt::kThreads)
predict_lanes_kernel_elems(const p::Args a) {
  p::elems_body<Tr>(a);
}

// the tile kernel for m+1 orders
template <class Tr>
p::Kernel tiles_kernel(int m1) {
  switch (m1) {
    case 1: return predict_lanes_kernel<Tr, 1>;
    case 2: return predict_lanes_kernel<Tr, 2>;
    case 3: return predict_lanes_kernel<Tr, 3>;
    case 4: return predict_lanes_kernel<Tr, 4>;
    case 5: return predict_lanes_kernel<Tr, 5>;
    case 6: return predict_lanes_kernel<Tr, 6>;
    case 7: return predict_lanes_kernel<Tr, 7>;
    default: return predict_lanes_kernel<Tr, 8>;
  }
}

template <class Tr>
int launch(const void* diffs, const void* w, void* out, int m1,
           int64_t R, int64_t C, int lanes, int vec, bool floor,
           cudaStream_t stream, int device) {
  p::Args a{};
  a.diffs = diffs;
  a.w = static_cast<const float*>(w);
  a.out = out;
  a.m1 = m1;
  a.K = 1;
  a.lanes = lanes;
  a.R = R;
  a.C = C;
  return p::launch(tiles_kernel<Tr>(m1), predict_lanes_kernel_elems<Tr>, a,
                   sizeof(typename Tr::storage), vec != 0, floor, stream,
                   device);
}

int entry(const void* diffs, const void* w, void* out, int dtype, int m1,
          long long R, long long C, int lanes, int vec, void* stream,
          int device, bool floor) {
  if (m1 < 1 || m1 > p::kMaxOrders)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return launch<rt::BF16>(diffs, w, out, m1, R, C, lanes, vec, floor, s,
                            device);
  if (dtype == rt::kF32)
    return launch<rt::F32>(diffs, w, out, m1, R, C, lanes, vec, floor, s,
                           device);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched; R·⌈C / tile⌉ must
// stay below 2^32 tiles, else cudaErrorInvalidValue). The caller
// guarantees 1 <= m1 <= 8, contiguous buffers and, with vec,
// C % (16 / element size) == 0 and 16-byte aligned pointers.
extern "C" int taylor_predict_lanes(const void* diffs, const void* w,
                                    void* out, int dtype, int m1,
                                    long long R, long long C, int lanes,
                                    int vec, void* stream, int device) {
  return entry(diffs, w, out, dtype, m1, R, C, lanes, vec, stream, device,
               false);
}

// The launch floor: an empty kernel on the grid, block and shared memory
// the same arguments give taylor_predict_lanes. Reads and writes nothing.
extern "C" int taylor_predict_lanes_floor(const void* diffs, const void* w,
                                          void* out, int dtype, int m1,
                                          long long R, long long C, int lanes,
                                          int vec, void* stream, int device) {
  return entry(diffs, w, out, dtype, m1, R, C, lanes, vec, stream, device,
               true);
}
