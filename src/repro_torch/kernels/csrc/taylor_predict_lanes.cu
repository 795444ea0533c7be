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
// element, far below the H100's ops-per-byte balance. Design: one block
// row per table row (so the lane's weight column is loaded once into
// registers), 16-byte loads and stores per thread, the m+1 loads of a
// thread independent so they are in flight together. The ragged tail of C
// is masked per thread; a row whose C is not a multiple of the vector
// width takes the scalar path.
#include "common.cuh"

namespace {

constexpr int kMaxOrders = 8;

template <class Tr, bool kVec>
__global__ void __launch_bounds__(rt::kThreads)
predict_lanes_kernel(const typename Tr::storage* __restrict__ diffs,
                     const float* __restrict__ w,
                     typename Tr::storage* __restrict__ out, int m1,
                     int64_t R, int64_t C, int lanes) {
  const int64_t row = blockIdx.y;
  const int lane = static_cast<int>(row % lanes);
  float wl[kMaxOrders];
#pragma unroll
  for (int i = 0; i < kMaxOrders; ++i)
    wl[i] = i < m1 ? w[i * lanes + lane] : 0.f;
  const int64_t plane = R * C;
  const typename Tr::storage* src = diffs + row * C;
  typename Tr::storage* dst = out + row * C;
  if (kVec) {
    using V = rt::Vec<Tr>;
    const int64_t c =
        (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V::N;
    if (c >= C) return;
    V d[kMaxOrders];
#pragma unroll
    for (int i = 0; i < kMaxOrders; ++i)
      if (i < m1) d[i].load(src + i * plane + c);
    V o;
#pragma unroll
    for (int k = 0; k < V::N; ++k)
      o.s[k] = Tr::store(rt::fma_chain<kMaxOrders>(
          wl, m1, [&](int i) { return Tr::load(d[i].s[k]); }));
    o.store(dst + c);
  } else {
    const int64_t c =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (c >= C) return;
    dst[c] = Tr::store(rt::fma_chain<kMaxOrders>(
        wl, m1, [&](int i) { return Tr::load(src[i * plane + c]); }));
  }
}

template <class Tr, bool kVec>
void launch(const void* diffs, const float* w, void* out, int m1, int64_t R,
            int64_t C, int lanes, cudaStream_t stream) {
  const int64_t per_thread = kVec ? rt::Vec<Tr>::N : 1;
  const int64_t per_block = per_thread * rt::kThreads;
  dim3 grid(static_cast<unsigned>((C + per_block - 1) / per_block),
            static_cast<unsigned>(R));
  predict_lanes_kernel<Tr, kVec><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const typename Tr::storage*>(diffs), w,
      static_cast<typename Tr::storage*>(out), m1, R, C, lanes);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). The caller
// guarantees 1 <= m1 <= 8, R < 65536, contiguous buffers and, with vec,
// C % (16 / element size) == 0 and 16-byte aligned pointers.
extern "C" int taylor_predict_lanes(const void* diffs, const void* w,
                                    void* out, int dtype, int m1,
                                    long long R, long long C, int lanes,
                                    int vec, void* stream, int device) {
  if (m1 < 1 || m1 > kMaxOrders) return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  if (dtype == rt::kBF16) {
    if (vec) launch<rt::BF16, true>(diffs, wf, out, m1, R, C, lanes, s);
    else launch<rt::BF16, false>(diffs, wf, out, m1, R, C, lanes, s);
  } else if (dtype == rt::kF32) {
    if (vec) launch<rt::F32, true>(diffs, wf, out, m1, R, C, lanes, s);
    else launch<rt::F32, false>(diffs, wf, out, m1, R, C, lanes, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rt::launched();
}
