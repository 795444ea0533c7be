// Lane-masked recursive difference refresh: the SpeCa anchor refresh.
//
// Replaces the TPU kernel taylor_update_lanes_2d
// (src/repro/kernels/taylor_predict.py:215, pallas_call at :234).
//
// old [m+1, R, C] (R = G·lanes, lane = row % lanes), feats [R, C] in the
// table dtype, mask [lanes] (bool bytes) -> new [m+1, R, C]. A lane in the
// mask gets Δ⁰ = F and Δⁱ = Δⁱ⁻¹_new − Δⁱ⁻¹_old, each subtraction rounded
// to the table dtype (f32 subtract, then round to nearest even for bf16 —
// what PyTorch's bf16 subtraction does; __hsub would round once from the
// exact difference and could differ). A lane outside the mask copies its
// old rows bit for bit. The result is therefore bitwise equal to the
// plain PyTorch version in f32 and in bf16.
//
// Bound on the card: bytes. Each old plane is read once, the feature
// plane once for refreshed lanes, each new plane written once; the
// arithmetic is m subtractions per element. Design: one block row per
// table row (the lane's mask bit is one load per block), 16-byte loads
// and stores per thread, a copy-only path for lanes outside the mask
// that never touches the feature plane.
#include "common.cuh"

namespace {

template <class Tr, bool kVec>
__global__ void __launch_bounds__(rt::kThreads)
update_lanes_kernel(const typename Tr::storage* __restrict__ old,
                    const typename Tr::storage* __restrict__ feats,
                    const uint8_t* __restrict__ mask,
                    typename Tr::storage* __restrict__ out, int m1,
                    int64_t R, int64_t C, int lanes) {
  const int64_t row = blockIdx.y;
  const bool refresh = mask[row % lanes] != 0;
  const int64_t plane = R * C;
  const int64_t base = row * C;
  if (kVec) {
    using V = rt::Vec<Tr>;
    const int64_t c =
        (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V::N;
    if (c >= C) return;
    if (!refresh) {
      for (int i = 0; i < m1; ++i) {
        V o;
        o.load(old + i * plane + base + c);
        o.store(out + i * plane + base + c);
      }
      return;
    }
    V cur;
    cur.load(feats + base + c);
    for (int i = 0; i < m1; ++i) {
      cur.store(out + i * plane + base + c);
      if (i + 1 < m1) {
        V o;
        o.load(old + i * plane + base + c);
#pragma unroll
        for (int k = 0; k < V::N; ++k)
          cur.s[k] = Tr::store(Tr::load(cur.s[k]) - Tr::load(o.s[k]));
      }
    }
  } else {
    const int64_t c =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (c >= C) return;
    if (!refresh) {
      for (int i = 0; i < m1; ++i)
        out[i * plane + base + c] = old[i * plane + base + c];
      return;
    }
    typename Tr::storage cur = feats[base + c];
    for (int i = 0; i < m1; ++i) {
      out[i * plane + base + c] = cur;
      if (i + 1 < m1)
        cur = Tr::store(Tr::load(cur) - Tr::load(old[i * plane + base + c]));
    }
  }
}

template <class Tr, bool kVec>
void launch(const void* old, const void* feats, const uint8_t* mask,
            void* out, int m1, int64_t R, int64_t C, int lanes,
            cudaStream_t stream) {
  const int64_t per_thread = kVec ? rt::Vec<Tr>::N : 1;
  const int64_t per_block = per_thread * rt::kThreads;
  dim3 grid(static_cast<unsigned>((C + per_block - 1) / per_block),
            static_cast<unsigned>(R));
  update_lanes_kernel<Tr, kVec><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const typename Tr::storage*>(old),
      static_cast<const typename Tr::storage*>(feats), mask,
      static_cast<typename Tr::storage*>(out), m1, R, C, lanes);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). The caller
// guarantees m1 >= 1, R < 65536, contiguous buffers, feats in the table
// dtype and, with vec, C % (16 / element size) == 0 and 16-byte aligned
// pointers.
extern "C" int taylor_update_lanes(const void* old, const void* feats,
                                   const void* mask, void* out, int dtype,
                                   int m1, long long R, long long C,
                                   int lanes, int vec, void* stream,
                                   int device) {
  if (m1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto mk = static_cast<const uint8_t*>(mask);
  if (dtype == rt::kBF16) {
    if (vec) launch<rt::BF16, true>(old, feats, mk, out, m1, R, C, lanes, s);
    else launch<rt::BF16, false>(old, feats, mk, out, m1, R, C, lanes, s);
  } else if (dtype == rt::kF32) {
    if (vec) launch<rt::F32, true>(old, feats, mk, out, m1, R, C, lanes, s);
    else launch<rt::F32, false>(old, feats, mk, out, m1, R, C, lanes, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rt::launched();
}
