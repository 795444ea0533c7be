// Whole-table recursive difference refresh: the scalar-anchor refresh.
//
// Replaces the TPU kernel taylor_update_2d
// (src/repro/kernels/taylor_predict.py:258, body _update_kernel at :250),
// reached through repro.kernels.ops.taylor_update.
//
// old [m+1, n] in the table dtype, feats [n] (the table dtype or f32) ->
// new [m+1, n] with Δ⁰ = F and Δⁱ = Δⁱ⁻¹_new − Δⁱ⁻¹_old chained in f32
// from the features in their own dtype, each plane rounded to the table
// dtype once, at its store. That is the TPU kernel's arithmetic, not the
// lane refresh's (which rounds every Δ before the next subtraction): the
// two differ for bf16 tables, so this is a variant of its own at compile
// time, without the lane mask. f32 subtraction is exact IEEE and the bf16
// store rounds to nearest even (rt::BF16::store, which also maps NaN to
// c10's 0x7FC0), so the result is bitwise the plain PyTorch version's.
//
// Bound on the card: bytes. Old planes 0..m-1 are read once (plane m
// never feeds the new table), the features once, the m+1 new planes
// written once; the arithmetic is m subtractions per element. Design: a
// flat 1-D grid over n, 16-byte loads and stores of the table dtype per
// thread (an f32 feature vector of the same element count is two of them),
// the running Δ kept in f32 registers between planes; the ragged tail of n
// takes the scalar path.
#include "common.cuh"

namespace {

template <class Tr, class Tf, bool kVec>
__global__ void __launch_bounds__(rt::kThreads)
update_kernel(const typename Tr::storage* __restrict__ old,
              const typename Tf::storage* __restrict__ feats,
              typename Tr::storage* __restrict__ out, int m1, int64_t n) {
  if (kVec) {
    using V = rt::Vec<Tr>;
    constexpr int kN = V::N;
    const int64_t c =
        (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kN;
    if (c >= n) return;
    // kN feature values: one or two 16-byte vectors of the feature dtype
    using FV = rt::Vec<Tf>;
    constexpr int kF = kN / FV::N;
    float cur[kN];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      FV fv;
      fv.load(feats + c + f * FV::N);
#pragma unroll
      for (int k = 0; k < FV::N; ++k) cur[f * FV::N + k] = Tf::load(fv.s[k]);
    }
    for (int i = 0; i < m1; ++i) {
      V o;
#pragma unroll
      for (int k = 0; k < kN; ++k) o.s[k] = Tr::store(cur[k]);
      o.store(out + i * n + c);
      if (i + 1 < m1) {
        V d;
        d.load(old + i * n + c);
#pragma unroll
        for (int k = 0; k < kN; ++k) cur[k] -= Tr::load(d.s[k]);
      }
    }
  } else {
    const int64_t c =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (c >= n) return;
    float cur = Tf::load(feats[c]);
    for (int i = 0; i < m1; ++i) {
      out[i * n + c] = Tr::store(cur);
      if (i + 1 < m1) cur -= Tr::load(old[i * n + c]);
    }
  }
}

template <class Tr, class Tf, bool kVec>
void launch(const void* old, const void* feats, void* out, int m1, int64_t n,
            cudaStream_t stream) {
  const int64_t per_block = (kVec ? rt::Vec<Tr>::N : 1) * rt::kThreads;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block));
  update_kernel<Tr, Tf, kVec><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const typename Tr::storage*>(old),
      static_cast<const typename Tf::storage*>(feats),
      static_cast<typename Tr::storage*>(out), m1, n);
}

template <class Tr, class Tf>
void launch_any(const void* old, const void* feats, void* out, int m1,
                int64_t n, int vec, cudaStream_t stream) {
  if (vec) launch<Tr, Tf, true>(old, feats, out, m1, n, stream);
  else launch<Tr, Tf, false>(old, feats, out, m1, n, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). dtype is the
// table's code, feats_dtype the features' (equal to dtype, or f32 for a
// bf16 table). The caller guarantees m1 >= 1, contiguous buffers, a grid
// of at most 2^31 - 1 blocks and, with vec, n % (16 / table element size)
// == 0 and 16-byte aligned pointers.
extern "C" int taylor_update(const void* old, const void* feats, void* out,
                             int dtype, int feats_dtype, int m1,
                             long long n, int vec, void* stream,
                             int device) {
  if (m1 < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16 && feats_dtype == rt::kBF16) {
    launch_any<rt::BF16, rt::BF16>(old, feats, out, m1, n, vec, s);
  } else if (dtype == rt::kBF16 && feats_dtype == rt::kF32) {
    launch_any<rt::BF16, rt::F32>(old, feats, out, m1, n, vec, s);
  } else if (dtype == rt::kF32 && feats_dtype == rt::kF32) {
    launch_any<rt::F32, rt::F32>(old, feats, out, m1, n, vec, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rt::launched();
}
