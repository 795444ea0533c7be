// Lane-masked ring shift: the spectral forecaster's anchor refresh.
//
// Replaces the TPU kernel spectral_update_lanes_2d
// (src/repro/kernels/spectral.py:51, pallas_call at :70).
//
// old [m+1, R, C] (R = G·lanes, lane = row % lanes), feats [R, C] in the
// table dtype, mask [lanes] (bool bytes) -> new [m+1, R, C]. A lane in the
// mask gets row 0 = feats and row i = old row i−1 (its oldest snapshot
// drops); a lane outside the mask copies its rows through. Exact copies,
// no arithmetic: bitwise equal to the plain PyTorch version in any dtype.
//
// Bound on the card: bytes. A refreshed row reads its features and old
// rows 0..m-1 (never old row m, which drops), a kept row reads its m+1
// old rows and never the features; every new row is written once. Design:
// the structure of taylor_update_lanes.cu — one block row per table row
// (the lane's mask bit is one load per block), 16-byte loads and stores
// per thread, element-wise copies when C is not a vector multiple.
#include <type_traits>

#include "common.cuh"

namespace {

template <class T, bool kVec>
__global__ void __launch_bounds__(rt::kThreads)
ring_update_kernel(const T* __restrict__ old, const T* __restrict__ feats,
                   const uint8_t* __restrict__ mask, T* __restrict__ out,
                   int m1, int64_t R, int64_t C, int lanes) {
  const int64_t row = blockIdx.y;
  const bool refresh = mask[row % lanes] != 0;
  const int64_t plane = R * C;
  const int64_t base = row * C;
  constexpr int kN = kVec ? 16 / sizeof(T) : 1;
  using U = typename std::conditional<kVec, uint4, T>::type;
  const int64_t c =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kN;
  if (c >= C) return;
  auto at = [&](const T* p, int i) {
    return *reinterpret_cast<const U*>(p + i * plane + base + c);
  };
  auto put = [&](int i, U v) {
    *reinterpret_cast<U*>(out + i * plane + base + c) = v;
  };
  if (!refresh) {
    for (int i = 0; i < m1; ++i) put(i, at(old, i));
    return;
  }
  put(0, *reinterpret_cast<const U*>(feats + base + c));
  for (int i = 1; i < m1; ++i) put(i, at(old, i - 1));
}

template <class T, bool kVec>
void launch(const void* old, const void* feats, const uint8_t* mask,
            void* out, int m1, int64_t R, int64_t C, int lanes,
            cudaStream_t stream) {
  const int64_t per_thread = kVec ? 16 / sizeof(T) : 1;
  const int64_t per_block = per_thread * rt::kThreads;
  dim3 grid(static_cast<unsigned>((C + per_block - 1) / per_block),
            static_cast<unsigned>(R));
  ring_update_kernel<T, kVec><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const T*>(old), static_cast<const T*>(feats), mask,
      static_cast<T*>(out), m1, R, C, lanes);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). The caller
// guarantees m1 >= 1, R < 65536, contiguous buffers, feats in the table
// dtype and, with vec, C % (16 / element size) == 0 and 16-byte aligned
// pointers.
extern "C" int spectral_update_lanes(const void* old, const void* feats,
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
    if (vec) launch<uint16_t, true>(old, feats, mk, out, m1, R, C, lanes, s);
    else launch<uint16_t, false>(old, feats, mk, out, m1, R, C, lanes, s);
  } else if (dtype == rt::kF32) {
    if (vec) launch<uint32_t, true>(old, feats, mk, out, m1, R, C, lanes, s);
    else launch<uint32_t, false>(old, feats, mk, out, m1, R, C, lanes, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rt::launched();
}
