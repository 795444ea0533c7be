// Fused per-lane verification: the SpeCa accept decision, and the plain
// per-row verification sums.
//
// Replaces the TPU kernel verify_sums (src/repro/kernels/verify_error.py:72)
// in both its forms: with tau (body _verify_tau_kernel at :44, pallas_call
// at :100) through the entry verify_accept, and without tau (body
// _verify_kernel at :26, pallas_call at :87; verify_error at :114 sits on
// top) through the entry verify_sums, which writes (Σ(p−r)², Σr²) per row
// as [W, 2] f32. Both share pass 1; only the finish differs, so the τ
// path's bits do not depend on the τ-less one.
//
// pred/ref [W, N] (both f32 or both bf16), tau [W] f32 ->
//   err[w]    = sqrt(Σ(p−r)²) / (sqrt(Σr²) + eps)
//   accept[w] = err[w] <= tau[w]          (NaN never accepts)
// with every sum taken in f32.
//
// The TPU kernel carries its sums across a sequential grid axis; CUDA
// blocks run in no order, so this is two passes without atomics. Pass 1:
// block (chunk, lane) reduces one chunk of one lane to two partial sums.
// Pass 2: one block per lane adds its chunks' partials in chunk order and
// finishes err and accept on the device. The summation order depends only
// on the shapes, so a rerun gives the same bits — accept decisions hang
// on it.
//
// Bound on the card: launch overhead at the serving shapes (a few MB);
// in bytes it reads both planes once (2 bytes per bf16 element each) for
// 5 flops per element (a subtraction and two multiply-adds).
#include "common.cuh"

namespace {

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
}

// Sums (a, b) over the block in a fixed order; the result is valid in
// thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[rt::kThreads / 32], sb[rt::kThreads / 32];
  warp_sum2(a, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < rt::kThreads / 32 ? sa[lane] : 0.f;
    b = lane < rt::kThreads / 32 ? sb[lane] : 0.f;
    warp_sum2(a, b);
  }
}

template <class Tr, bool kVec>
__global__ void __launch_bounds__(rt::kThreads)
verify_partials_kernel(const typename Tr::storage* __restrict__ pred,
                       const typename Tr::storage* __restrict__ ref,
                       float* __restrict__ partials, int64_t N,
                       int64_t chunk) {
  const int64_t lane = blockIdx.y;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  const typename Tr::storage* p = pred + lane * N;
  const typename Tr::storage* r = ref + lane * N;
  float num = 0.f, den = 0.f;
  if (kVec) {
    using V = rt::Vec<Tr>;
    for (int64_t c = start + static_cast<int64_t>(threadIdx.x) * V::N;
         c < end; c += static_cast<int64_t>(blockDim.x) * V::N) {
      V pv, rv;
      pv.load(p + c);
      rv.load(r + c);
#pragma unroll
      for (int k = 0; k < V::N; ++k) {
        const float rr = Tr::load(rv.s[k]);
        const float d = Tr::load(pv.s[k]) - rr;
        num += d * d;
        den += rr * rr;
      }
    }
  } else {
    for (int64_t c = start + threadIdx.x; c < end; c += blockDim.x) {
      const float rr = Tr::load(r[c]);
      const float d = Tr::load(p[c]) - rr;
      num += d * d;
      den += rr * rr;
    }
  }
  block_sum2(num, den);
  if (threadIdx.x == 0) {
    float* out = partials + (lane * gridDim.x + blockIdx.x) * 2;
    out[0] = num;
    out[1] = den;
  }
}

__global__ void __launch_bounds__(rt::kThreads)
verify_finish_kernel(const float* __restrict__ partials,
                     const float* __restrict__ tau, float* __restrict__ err,
                     uint8_t* __restrict__ accept, int nchunks, float eps) {
  const int lane = blockIdx.x;
  const float* part = partials + static_cast<int64_t>(lane) * nchunks * 2;
  float num = 0.f, den = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
    num += part[2 * c];
    den += part[2 * c + 1];
  }
  block_sum2(num, den);
  if (threadIdx.x == 0) {
    const float e = sqrtf(num) / (sqrtf(den) + eps);
    err[lane] = e;
    accept[lane] = e <= tau[lane] ? 1 : 0;
  }
}

// The τ-less finish: the same chunk-order sums, written as (num, den).
__global__ void __launch_bounds__(rt::kThreads)
verify_sums_finish_kernel(const float* __restrict__ partials,
                          float* __restrict__ sums, int nchunks) {
  const int lane = blockIdx.x;
  const float* part = partials + static_cast<int64_t>(lane) * nchunks * 2;
  float num = 0.f, den = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
    num += part[2 * c];
    den += part[2 * c + 1];
  }
  block_sum2(num, den);
  if (threadIdx.x == 0) {
    sums[2 * lane] = num;
    sums[2 * lane + 1] = den;
  }
}

template <class Tr, bool kVec>
void launch_partials(const void* pred, const void* ref, float* partials,
                     int W, int64_t N, int64_t chunk, int nchunks,
                     cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(W));
  verify_partials_kernel<Tr, kVec><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const typename Tr::storage*>(pred),
      static_cast<const typename Tr::storage*>(ref), partials, N, chunk);
}

int partials_any(const void* pred, const void* ref, float* part, int dtype,
                 int W, int64_t N, int64_t chunk, int nchunks, int vec,
                 cudaStream_t s) {
  if (dtype == rt::kBF16) {
    if (vec)
      launch_partials<rt::BF16, true>(pred, ref, part, W, N, chunk, nchunks, s);
    else
      launch_partials<rt::BF16, false>(pred, ref, part, W, N, chunk, nchunks,
                                       s);
  } else if (dtype == rt::kF32) {
    if (vec)
      launch_partials<rt::F32, true>(pred, ref, part, W, N, chunk, nchunks, s);
    else
      launch_partials<rt::F32, false>(pred, ref, part, W, N, chunk, nchunks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rt::launched();
}

}  // namespace

// Returns the cudaError_t of the launches (0 = launched). partials is
// scratch of W·nchunks·2 floats with nchunks = ceil(N / chunk); with vec,
// N and chunk are multiples of 16 / element size and the pointers are
// 16-byte aligned. accept is W bytes (a torch.bool buffer).
extern "C" int verify_accept(const void* pred, const void* ref,
                             const void* tau, void* partials, void* err,
                             void* accept, int dtype, int W, long long N,
                             long long chunk, int nchunks, float eps,
                             int vec, void* stream, int device) {
  if (W < 1 || N < 1 || chunk < 1 || nchunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int e = rt::prepare(device);
  if (e) return e;
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  e = partials_any(pred, ref, part, dtype, W, N, chunk, nchunks, vec, s);
  if (e) return e;
  verify_finish_kernel<<<W, rt::kThreads, 0, s>>>(
      part, static_cast<const float*>(tau), static_cast<float*>(err),
      static_cast<uint8_t*>(accept), nchunks, eps);
  return rt::launched();
}

// The τ-less sums: sums is [W, 2] f32 = (Σ(p−r)², Σr²) per row; the other
// arguments as for verify_accept.
extern "C" int verify_sums(const void* pred, const void* ref, void* partials,
                           void* sums, int dtype, int W, long long N,
                           long long chunk, int nchunks, int vec,
                           void* stream, int device) {
  if (W < 1 || N < 1 || chunk < 1 || nchunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int e = rt::prepare(device);
  if (e) return e;
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  e = partials_any(pred, ref, part, dtype, W, N, chunk, nchunks, vec, s);
  if (e) return e;
  verify_sums_finish_kernel<<<W, rt::kThreads, 0, s>>>(
      part, static_cast<float*>(sums), nchunks);
  return rt::launched();
}
