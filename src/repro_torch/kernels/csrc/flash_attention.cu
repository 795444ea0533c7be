// Blocked online-softmax attention (flash attention) in f32, for f32
// inputs.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py:68, body _flash_kernel at :22)
// for f32 inputs, reached through repro.kernels.ops.flash_attention and
// repro.layers.attention.full_attention(..., use_flash=True); bf16 inputs
// take flash_attention_sm90.cu (the tensor cores).
//
// q/k/v [B, S, H, hd] (equal head counts, read through their strides; the
// last axis contiguous) -> out [B, S, H, hd] contiguous f32. Scores are (q·scale)·k in f32 with scale = 1/√hd, masked with
// −1e30 where key k is not visible from query q (k > q when causal,
// q − k >= window when window > 0, also without causal); running (m, l,
// acc) per query row in f32, acc rescaled by exp(m_old − m_new) per key
// tile, l == 0 -> 1 at the end, out = acc / l cast to the dtype.
//
// Why −1e30 and not −inf: a first tile that is wholly masked leaves
// m = −1e30 and gives its entries p = exp(0) = 1; the first visible key
// then wipes them with alpha = exp(−1e30 − m) = 0 exactly. With −inf the
// same tile gives NaN. The same wipe makes it safe to skip key tiles that
// the mask hides from every row of the block: the result does not change.
// So causal prefill visits ~half the tiles and a window only the tiles
// inside it.
//
// Bound on the card: f32 operations (4·hd per visible query–key pair) —
// the f32 function needs f32 products, so the CUDA cores (TF32 would not
// hold its tolerance).
// Design: one block of 256 threads per (64-query tile, b·h); the query
// tile (pre-scaled) and each 64-key tile are staged in shared memory as
// f32, transposed so a thread reads 4 rows and 4 keys as two float4 per
// depth step and keeps a 4×4 score tile in registers. The 16 threads that
// share 4 query rows reduce the row max and sum by shuffles and hold the
// same (m, l) and the 4 rows' output columns in registers. Probabilities
// go to shared memory and the V tile replaces the K tile for the P·V
// product. Ragged query and key tails are masked (keys past S read as 0
// and are never visible), so any S works.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kLd = kBQ + 4;       // row stride of the transposed tiles:
                                   // padded, and float4-aligned
static_assert(kBQ == kBK, "the transposed tiles share one stride");

struct Strides {
  long long b, s, h;
};

template <int HD>
constexpr size_t smem_bytes() {
  // Qt [HD][kLd], K tile Kt [HD][kLd] (then V tile [kBK][HD] in the same
  // space), Pt [kBK][kLd]
  return static_cast<size_t>(2 * HD * kLd + kBK * kLd) * sizeof(float);
}

template <class Tr, int HD>
__global__ void __launch_bounds__(rt::kThreads, 2)
flash_kernel(const typename Tr::storage* __restrict__ q,
             const typename Tr::storage* __restrict__ k,
             const typename Tr::storage* __restrict__ v,
             typename Tr::storage* __restrict__ out, Strides qs, Strides ks,
             Strides vs, int H, int S, int causal, int window, float scale) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  constexpr int NJ = (HD + 63) / 64;   // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // Qt[d*kLd + r]
  float* KV = Qt + HD * kLd;                      // Kt[d*kLd + c] / V[c*HD + d]
  float* Pt = KV + HD * kLd;                      // Pt[c*kLd + r]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const typename Tr::storage* qb = q + b * qs.b + h * qs.h;
  const typename Tr::storage* kb = k + b * ks.b + h * ks.h;
  const typename Tr::storage* vb = v + b * vs.b + h * vs.h;

  for (int idx = tid; idx < kBQ * HD; idx += rt::kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qt[d * kLd + r] = qi < S ? Tr::load(qb[qi * qs.s + d]) * scale : 0.f;
  }

  // the key tiles some row of this block can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], o[4][NJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NJ * 4; ++e) o[i][e] = 0.f;
  }

  for (int t = k_lo / kBK; t <= k_hi / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();               // the last tile's P·V is done with KV, Pt
    for (int idx = tid; idx < kBK * HD; idx += rt::kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int kj = k0 + c;
      KV[d * kLd + c] = kj < S ? Tr::load(kb[kj * ks.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(KV + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && (qi - kj) < window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 threads of a row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NJ * 4; ++e) o[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();               // every thread is done with the K tile

    for (int idx = tid; idx < kBK * HD; idx += rt::kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int kj = k0 + c;
      KV[c * HD + d] = kj < S ? Tr::load(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + c * kLd + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx * 4 + 64 * j;
        if (d < HD) {
          const float4 vv = *reinterpret_cast<const float4*>(KV + c * HD + d);
          const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[i][j * 4 + e] = fmaf(pr[i], vr[e], o[i][j * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];     // rows that see no key
    typename Tr::storage* ob =
        out + ((static_cast<int64_t>(b) * S + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx * 4 + 64 * j;
      if (d < HD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ob[d + e] = Tr::store(o[i][j * 4 + e] / li);
      }
    }
  }
}

template <class Tr, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, Strides qs, Strides ks, Strides vs, int causal,
           int window, float scale, cudaStream_t stream) {
  auto fn = flash_kernel<Tr, HD>;
  constexpr size_t bytes = smem_bytes<HD>();
  int e = static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
  if (e) return e;
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  fn<<<grid, rt::kThreads, bytes, stream>>>(
      static_cast<const typename Tr::storage*>(q),
      static_cast<const typename Tr::storage*>(k),
      static_cast<const typename Tr::storage*>(v),
      static_cast<typename Tr::storage*>(out), qs, ks, vs, H, S, causal,
      window, scale);
  return rt::launched();
}

template <class Tr>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int H, Strides qs, Strides ks, Strides vs,
              int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<Tr, 16>(q, k, v, out, B, S, H, qs, ks, vs, causal, window, scale, s);
    case 32: return launch<Tr, 32>(q, k, v, out, B, S, H, qs, ks, vs, causal, window, scale, s);
    case 64: return launch<Tr, 64>(q, k, v, out, B, S, H, qs, ks, vs, causal, window, scale, s);
    case 72: return launch<Tr, 72>(q, k, v, out, B, S, H, qs, ks, vs, causal, window, scale, s);
    case 128: return launch<Tr, 128>(q, k, v, out, B, S, H, qs, ks, vs, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). q/k/v are f32;
// strides are in elements (the last axis is contiguous); out is a
// contiguous [B, S, H, hd] f32 buffer. The caller guarantees hd in
// {16, 32, 64, 72, 128}, S >= 1 and B·H <= 65535.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H,
                               int hd, long long qsb, long long qss,
                               long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss,
                               long long vsh, int causal, int window,
                               float scale, void* stream, int device) {
  if (B < 1 || S < 1 || H < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  return launch_hd<rt::F32>(hd, q, k, v, out, B, S, H, qs, ks, vs, causal,
                            window, scale, s);
}
