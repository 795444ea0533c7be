// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes plain C entry points (loaded from Python with
// ctypes): each takes raw device pointers, the shapes, a dtype code, the
// CUDA stream and the device index, launches on that stream, and returns
// the launch's cudaError_t so the Python wrapper can raise on a refused
// launch. Nothing here allocates or synchronises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes shared with repro_torch/kernels/ops.py
enum DTypeCode : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

// f32 storage: raw 32-bit words.
struct F32 {
  using storage = uint32_t;
  __device__ __forceinline__ static float load(storage s) {
    return __uint_as_float(s);
  }
  __device__ __forceinline__ static storage store(float f) {
    return __float_as_uint(f);
  }
};

// bf16 storage: raw 16-bit words. Widening is exact (shift into the high
// half). Narrowing is round-to-nearest-even with NaN -> 0x7FC0, bit for
// bit the conversion PyTorch's c10::BFloat16 performs on CPU and GPU, so
// a bf16 result computed here equals the plain PyTorch version's.
struct BF16 {
  using storage = uint16_t;
  __device__ __forceinline__ static float load(storage s) {
    return __uint_as_float(static_cast<uint32_t>(s) << 16);
  }
  __device__ __forceinline__ static storage store(float f) {
    if (f != f) return 0x7FC0;
    uint32_t u = __float_as_uint(f);
    u += 0x7FFFu + ((u >> 16) & 1u);
    return static_cast<storage>(u >> 16);
  }
};

// One 16-byte vector of storage words (8 bf16 or 4 f32 values): the
// widest load a thread can issue, neighbouring threads on neighbouring
// addresses.
template <class Tr>
struct Vec {
  static constexpr int N = 16 / sizeof(typename Tr::storage);
  alignas(16) typename Tr::storage s[N];
  __device__ __forceinline__ void load(const typename Tr::storage* p) {
    *reinterpret_cast<uint4*>(s) = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void store(typename Tr::storage* p) const {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(s);
  }
};

// The draft's per-element sum Σ_i w[i]·x(i), accumulated in f32 as one
// FMA chain in the order i = 0..m1-1: acc = w0·x0, then acc = fma(wi, xi,
// acc). Every predict kernel evaluates its elements through this one
// function, so chain position k is bitwise the depth-1 predict called
// with position k's weights. w is a register array of kMax entries.
template <int kMax, class X>
__device__ __forceinline__ float fma_chain(const float* w, int m1, X x) {
  float acc = w[0] * x(0);
#pragma unroll
  for (int i = 1; i < kMax; ++i)
    if (i < m1) acc = fmaf(w[i], x(i), acc);
  return acc;
}

inline int prepare(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace rt

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
