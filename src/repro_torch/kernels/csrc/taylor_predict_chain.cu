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
// Design: one block row per table row; the lane's (m+1)·K weights go to
// shared memory once per block (every thread then reads them as
// broadcasts). Each thread loads its m+1 16-byte vectors once and keeps
// them in registers, then loops over the K positions: one weight column,
// the chain, one 16-byte store each — K needs no register array, so it
// is bounded only by the shared memory the wrapper allows. The ragged
// tail of C is masked per thread; a row whose C is not a multiple of the
// vector width takes the scalar path.
#include "common.cuh"

namespace {

constexpr int kMaxOrders = 8;

template <class Tr, bool kVec>
__global__ void __launch_bounds__(rt::kThreads)
predict_chain_kernel(const typename Tr::storage* __restrict__ diffs,
                     const float* __restrict__ w,
                     typename Tr::storage* __restrict__ out, int m1, int K,
                     int64_t R, int64_t C, int lanes) {
  extern __shared__ float ws[];                     // [m1, K] of this lane
  const int64_t row = blockIdx.y;
  const int lane = static_cast<int>(row % lanes);
  for (int t = threadIdx.x; t < m1 * K; t += blockDim.x)
    ws[t] = w[static_cast<int64_t>(t) * lanes + lane];
  __syncthreads();
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
    for (int k = 0; k < K; ++k) {
      float wl[kMaxOrders];
#pragma unroll
      for (int i = 0; i < kMaxOrders; ++i)
        wl[i] = i < m1 ? ws[i * K + k] : 0.f;
      V o;
#pragma unroll
      for (int e = 0; e < V::N; ++e)
        o.s[e] = Tr::store(rt::fma_chain<kMaxOrders>(
            wl, m1, [&](int i) { return Tr::load(d[i].s[e]); }));
      o.store(dst + k * plane + c);
    }
  } else {
    const int64_t c =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (c >= C) return;
    float x[kMaxOrders];
#pragma unroll
    for (int i = 0; i < kMaxOrders; ++i)
      x[i] = i < m1 ? Tr::load(src[i * plane + c]) : 0.f;
    for (int k = 0; k < K; ++k) {
      float wl[kMaxOrders];
#pragma unroll
      for (int i = 0; i < kMaxOrders; ++i)
        wl[i] = i < m1 ? ws[i * K + k] : 0.f;
      dst[k * plane + c] = Tr::store(rt::fma_chain<kMaxOrders>(
          wl, m1, [&](int i) { return x[i]; }));
    }
  }
}

template <class Tr, bool kVec>
void launch(const void* diffs, const float* w, void* out, int m1, int K,
            int64_t R, int64_t C, int lanes, cudaStream_t stream) {
  const int64_t per_thread = kVec ? rt::Vec<Tr>::N : 1;
  const int64_t per_block = per_thread * rt::kThreads;
  dim3 grid(static_cast<unsigned>((C + per_block - 1) / per_block),
            static_cast<unsigned>(R));
  const size_t smem = sizeof(float) * m1 * K;
  predict_chain_kernel<Tr, kVec><<<grid, rt::kThreads, smem, stream>>>(
      static_cast<const typename Tr::storage*>(diffs), w,
      static_cast<typename Tr::storage*>(out), m1, K, R, C, lanes);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). The caller
// guarantees 1 <= m1 <= 8, K >= 1 with m1·K·4 bytes <= 48 KB, R < 65536,
// contiguous buffers and, with vec, C % (16 / element size) == 0 and
// 16-byte aligned pointers.
extern "C" int taylor_predict_chain(const void* diffs, const void* w,
                                    void* out, int dtype, int m1, int K,
                                    long long R, long long C, int lanes,
                                    int vec, void* stream, int device) {
  if (m1 < 1 || m1 > kMaxOrders || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  if (dtype == rt::kBF16) {
    if (vec) launch<rt::BF16, true>(diffs, wf, out, m1, K, R, C, lanes, s);
    else launch<rt::BF16, false>(diffs, wf, out, m1, K, R, C, lanes, s);
  } else if (dtype == rt::kF32) {
    if (vec) launch<rt::F32, true>(diffs, wf, out, m1, K, R, C, lanes, s);
    else launch<rt::F32, false>(diffs, wf, out, m1, K, R, C, lanes, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rt::launched();
}
