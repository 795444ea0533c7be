// Fused per-lane verification: the SpeCa accept decision, and the plain
// per-row verification sums.
//
// Replaces the TPU kernel verify_sums (src/repro/kernels/verify_error.py:72)
// in both its forms: with tau (body _verify_tau_kernel at :44, pallas_call
// at :100) through the entry verify_accept, and without tau (body
// _verify_kernel at :26, pallas_call at :87) through the entry
// verify_sums, which writes (Σ(p−r)², Σr²) per row as [W, 2] f32; and the
// reference's verify_error (:114), which finishes err from those sums,
// through the entry verify_error. All three run the one kernel below;
// only its finish (the Finish mode) differs, so the τ path's bits do not
// depend on the τ-less ones, and verify_error's err is bitwise
// verify_accept's on the same planes.
//
// pred/ref [W, N] (both f32 or both bf16), tau [W] f32 ->
//   err[w]    = sqrt(Σ(p−r)²) / (sqrt(Σr²) + eps)
//   accept[w] = err[w] <= tau[w]          (NaN never accepts)
// with every sum taken in f32. No fast-math: sqrtf and the divide are the
// IEEE operations torch's own sqrt and divide are, so err is bitwise the
// two-step finish sqrt(sums[:, 0]) / (sqrt(sums[:, 1]) + eps) over the
// verify_sums entry's sums, in one launch instead of five.
//
// The entry verify_accept_mixed replaces the reference's guided verify,
// ops.verify_accept_mixed (src/repro/kernels/ops.py:320), which forms the
// planes of _mixed_planes (:286) in jnp and then runs the same Pallas
// verify_sums with tau. Lanes (2k, 2k+1) form pair slot k; a row whose
// paired[w] is set verifies the pair's guided residual u + s·(c − u)
// (c = row 2k, u = row 2k+1, s = gscale[2k]) for both pred and ref, formed
// in registers as __fadd_rn(u, __fmul_rn(s, __fsub_rn(c, u))): three IEEE
// roundings and no contraction, as the plain version's three eager f32
// ops. Other rows, and the tail lane of an odd W, verify their own stream
// exactly as verify_accept does (the same loads, order and finish), so
// with paired all false the entry is bitwise verify_accept. A paired row
// is bitwise verify_accept on the f32 planes the plain version forms: it
// is summed in an f32 plane's order (4-element groups where N % 4 == 0
// and the rows allow loads of 4 elements, else element by element), also
// in a bf16 launch, whose unpaired rows keep the bf16 order (8-element
// groups) — two orders in one launch, chosen per row. Both rows of a pair
// carry the same plane, so when both are paired the even row's blocks
// reduce the pair once and its finish writes both rows (each row's accept
// against its own tau); the odd row's blocks return at once. Bound:
// bytes, both planes read once (gscale, paired and tau are W words).
//
// Bound on the card: bytes. It reads both planes once (2 bytes per bf16
// element each) for 5 flops per element; at the serving shape (W 4 lanes
// × N 294,912 bf16) that is 4.7 MB, 1.4 µs at 3.35 TB/s — so one launch's
// latency and the grid's balance decide its time.
//
// One launch, with a ticket. The TPU kernel carries its sums across a
// sequential grid axis; CUDA blocks run in no order. Block (chunk, lane)
// reduces one chunk of one lane to two partial sums, writes them and
// takes a ticket from its lane's int32 counter (atom.add.acq_rel.gpu: it
// publishes the partial and, for the last, sees every other). The block
// that draws the last ticket of its lane reads that lane's partials from
// L2 and adds them in a fixed order (lane t of its first warp takes chunks
// t, t + 32, … in turn, then a fixed tree over the warp), finishes err
// and accept (or writes the sums), and puts the counter back to 0 for the
// next call on the stream. The counters are a small buffer
// that the wrapper allocates once per (device, stream), zeroed.
//
// Determinism. The summation order depends only on N: the chunk is a
// fixed 2,048 elements (kVerifyChunk in ops.py), never a function of W or
// of the SM count, and neither the in-block order nor the finish's order
// depends on which block finishes when. So a lane's err is bitwise the
// same at every lane width — the engine's trajectories at lanes=4 equal
// lanes=1's — and a rerun gives the same bits. The chunk is smaller than
// the two-pass design's 8,192: 576 blocks of 8 KB at the serving shape,
// over four a SM, where 144 blocks left twelve SMs reading twice the
// bytes of the rest. The new chunk moves err in its last bits against the
// two-pass kernel (the check is rtol 1e-5 against the plain version, with
// equal accept bits wherever |e − τ| > 1e-5).
#include "common.cuh"

namespace {

constexpr int kVThreads = 128;       // threads per (chunk, lane) block
constexpr int kUnroll = 4;           // 16-byte loads in flight per plane

// What the last block of a lane writes: err and accept, the sums, or err;
// kMixed is kAccept over the mixed guided/unguided planes.
enum Finish : int { kAccept = 0, kSums = 1, kError = 2, kMixed = 3 };

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
  __shared__ float sa[kVThreads / 32], sb[kVThreads / 32];
  warp_sum2(a, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kVThreads / 32 ? sa[lane] : 0.f;
    b = lane < kVThreads / 32 ? sb[lane] : 0.f;
    warp_sum2(a, b);
  }
}

// adds (p − r)² and r² of one element to this thread's sums; every path
// accumulates through this one function
__device__ __forceinline__ void accumulate(float p, float r, float& num,
                                           float& den) {
  const float d = p - r;
  num += d * d;
  den += r * r;
}

// this thread's Σ(p−r)² and Σr² over elements [start, end) of one row
template <class Tr, bool kVec>
__device__ __forceinline__ void chunk_sums(const typename Tr::storage* p,
                                           const typename Tr::storage* r,
                                           int64_t start, int64_t end,
                                           float& num, float& den) {
  if (kVec) {
    using V = rt::Vec<Tr>;
    constexpr int64_t kStep = static_cast<int64_t>(kVThreads) * V::N;
    for (int64_t c0 = start + static_cast<int64_t>(threadIdx.x) * V::N;
         c0 < end; c0 += kUnroll * kStep) {
      V pv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u * kStep < end) {
          pv[u].load(p + c0 + u * kStep);
          rv[u].load(r + c0 + u * kStep);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u * kStep < end) {
#pragma unroll
          for (int k = 0; k < V::N; ++k)
            accumulate(Tr::load(pv[u].s[k]), Tr::load(rv[u].s[k]), num, den);
        }
    }
  } else {
    for (int64_t c = start + threadIdx.x; c < end; c += kVThreads)
      accumulate(Tr::load(p[c]), Tr::load(r[c]), num, den);
  }
}

// Four storage words (4 f32 in 16 bytes, 4 bf16 in 8): the group an f32
// plane's vector path sums per load.
template <class Tr>
struct Quad {
  using S = typename Tr::storage;
  alignas(4 * sizeof(S)) S s[4];
  __device__ __forceinline__ void load(const S* p) {
    if constexpr (sizeof(S) == 4)
      *reinterpret_cast<uint4*>(s) = *reinterpret_cast<const uint4*>(p);
    else
      *reinterpret_cast<uint2*>(s) = *reinterpret_cast<const uint2*>(p);
  }
};

// u + s·(c − u) with three roundings and no contraction
__device__ __forceinline__ float guided(float c, float u, float s) {
  return __fadd_rn(u, __fmul_rn(s, __fsub_rn(c, u)));
}

// chunk_sums over a pair's guided residual: pc/pu and rc/ru are the pair's
// cond/uncond rows of pred and ref. The order is an f32 plane's in
// chunk_sums (kVec: 4-element groups, kStep = 4 per thread), whatever the
// storage type, so a paired row sums as verify_accept sums the plain f32
// plane.
template <class Tr, bool kVec>
__device__ __forceinline__ void pair_sums(const typename Tr::storage* pc,
                                          const typename Tr::storage* pu,
                                          const typename Tr::storage* rc,
                                          const typename Tr::storage* ru,
                                          float s, int64_t start, int64_t end,
                                          float& num, float& den) {
  if (kVec) {
    using V = Quad<Tr>;
    constexpr int64_t kStep = static_cast<int64_t>(kVThreads) * 4;
    for (int64_t c0 = start + static_cast<int64_t>(threadIdx.x) * 4;
         c0 < end; c0 += kUnroll * kStep) {
      V a[kUnroll], b[kUnroll], x[kUnroll], y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u * kStep < end) {
          a[u].load(pc + c0 + u * kStep);
          b[u].load(pu + c0 + u * kStep);
          x[u].load(rc + c0 + u * kStep);
          y[u].load(ru + c0 + u * kStep);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u * kStep < end) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            accumulate(guided(Tr::load(a[u].s[k]), Tr::load(b[u].s[k]), s),
                       guided(Tr::load(x[u].s[k]), Tr::load(y[u].s[k]), s),
                       num, den);
        }
    }
  } else {
    for (int64_t c = start + threadIdx.x; c < end; c += kVThreads)
      accumulate(guided(Tr::load(pc[c]), Tr::load(pu[c]), s),
                 guided(Tr::load(rc[c]), Tr::load(ru[c]), s), num, den);
  }
}

// Block (chunk, lane): the chunk's partial sums, then the lane's finish in
// the block that draws its last ticket: kAccept writes err [W] in `out`
// and accept; kSums the sums [W, 2] in `out` (accept, tau and eps unused);
// kError err [W] in `out` (accept and tau unused); kMixed as kAccept, a
// paired row over its pair's guided residual (gscale and paired [W] read
// only there; kPVec: the paired rows' 4-element groups).
template <class Tr, bool kVec, bool kPVec, int kFinish>
__global__ void __launch_bounds__(kVThreads)
verify_kernel(const typename Tr::storage* __restrict__ pred,
              const typename Tr::storage* __restrict__ ref,
              float2* __restrict__ partials, int* __restrict__ tickets,
              const float* __restrict__ tau,
              const float* __restrict__ gscale,
              const uint8_t* __restrict__ paired, float* __restrict__ out,
              uint8_t* __restrict__ accept, int64_t N, int64_t chunk,
              float eps) {
  __shared__ bool last;
  const int64_t lane = blockIdx.y;
  const int nchunks = gridDim.x;
  // a paired row (never the tail lane of an odd W) verifies its pair's
  // guided residual; when both rows are paired, the even row reduces the
  // pair for both
  bool pair = false, both = false;
  if (kFinish == kMixed) {
    pair = (lane | 1) < gridDim.y && paired[lane];
    both = pair && paired[lane ^ 1];
    if (both && (lane & 1)) return;
  }
  const int64_t start = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = start + chunk < N ? start + chunk : N;
  float num = 0.f, den = 0.f;
  if (pair) {
    const int64_t c = lane & ~int64_t{1};
    pair_sums<Tr, kPVec>(pred + c * N, pred + (c + 1) * N, ref + c * N,
                         ref + (c + 1) * N, gscale[c], start, end, num, den);
  } else {
    chunk_sums<Tr, kVec>(pred + lane * N, ref + lane * N, start, end, num,
                         den);
  }
  block_sum2(num, den);
  if (threadIdx.x == 0) {
    partials[lane * nchunks + blockIdx.x] = make_float2(num, den);
    // the ticket releases the partial and acquires the lane's others
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(tickets + lane)
                 : "memory");
    last = ticket == nchunks - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // warp 0 of the last block: chunks lane, lane + 32, … in turn, then a
  // fixed tree over the warp
  const float2* part = partials + lane * nchunks;
  num = den = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += 32) {
    const float2 v = __ldcg(part + c);     // from L2, not a stale L1 line
    num += v.x;
    den += v.y;
  }
  warp_sum2(num, den);
  if (threadIdx.x == 0) {
    if (kFinish == kSums) {
      out[2 * lane] = num;
      out[2 * lane + 1] = den;
    } else {
      const float e = sqrtf(num) / (sqrtf(den) + eps);
      out[lane] = e;
      if (kFinish == kAccept || kFinish == kMixed)
        accept[lane] = e <= tau[lane] ? 1 : 0;
      if (both) {                          // the odd row of the pair
        out[lane + 1] = e;
        accept[lane + 1] = e <= tau[lane + 1] ? 1 : 0;
      }
    }
    tickets[lane] = 0;                     // ready for the next call
  }
}

template <class Tr, bool kVec, bool kPVec, int kFinish>
void launch_t(const void* pred, const void* ref, void* partials,
              void* tickets, const void* tau, const void* gscale,
              const void* paired, void* out, void* accept, int W, int64_t N,
              int64_t chunk, int nchunks, float eps, cudaStream_t s) {
  dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(W));
  verify_kernel<Tr, kVec, kPVec, kFinish><<<grid, kVThreads, 0, s>>>(
      static_cast<const typename Tr::storage*>(pred),
      static_cast<const typename Tr::storage*>(ref),
      static_cast<float2*>(partials), static_cast<int*>(tickets),
      static_cast<const float*>(tau), static_cast<const float*>(gscale),
      static_cast<const uint8_t*>(paired), static_cast<float*>(out),
      static_cast<uint8_t*>(accept), N, chunk, eps);
}

// the instantiation for (vec, pvec); pvec only in the mixed finish
template <class Tr, int kFinish>
void launch_v(bool vec, bool pvec, const void* pred, const void* ref,
              void* partials, void* tickets, const void* tau,
              const void* gscale, const void* paired, void* out,
              void* accept, int W, int64_t N, int64_t chunk, int nchunks,
              float eps, cudaStream_t s) {
  constexpr bool kM = kFinish == kMixed;
  if (vec && kM && pvec)
    launch_t<Tr, true, kM, kFinish>(pred, ref, partials, tickets, tau,
                                    gscale, paired, out, accept, W, N, chunk,
                                    nchunks, eps, s);
  else if (vec)
    launch_t<Tr, true, false, kFinish>(pred, ref, partials, tickets, tau,
                                       gscale, paired, out, accept, W, N,
                                       chunk, nchunks, eps, s);
  else if (kM && pvec)
    launch_t<Tr, false, kM, kFinish>(pred, ref, partials, tickets, tau,
                                     gscale, paired, out, accept, W, N,
                                     chunk, nchunks, eps, s);
  else
    launch_t<Tr, false, false, kFinish>(pred, ref, partials, tickets, tau,
                                        gscale, paired, out, accept, W, N,
                                        chunk, nchunks, eps, s);
}

template <int kFinish>
int launch(const void* pred, const void* ref, void* partials, void* tickets,
           const void* tau, const void* gscale, const void* paired,
           void* out, void* accept, int dtype, int W, long long N,
           long long chunk, int nchunks, float eps, int vec, int pvec,
           void* stream, int device) {
  if (W < 1 || N < 1 || chunk < 1 || nchunks != (N + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = rt::prepare(device);
  if (e) return e;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    launch_v<rt::BF16, kFinish>(vec, pvec, pred, ref, partials, tickets, tau,
                                gscale, paired, out, accept, W, N, chunk,
                                nchunks, eps, s);
  else if (dtype == rt::kF32)
    launch_v<rt::F32, kFinish>(vec, pvec, pred, ref, partials, tickets, tau,
                               gscale, paired, out, accept, W, N, chunk,
                               nchunks, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return rt::launched();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). partials is
// scratch of W·nchunks float2 with nchunks = ceil(N / chunk); tickets is W
// int32 counters that are 0 before the call and 0 again after it (keep
// one buffer per stream). With vec, N and chunk are multiples of
// 16 / element size and the pointers are 16-byte aligned. accept is W
// bytes (a torch.bool buffer).
extern "C" int verify_accept(const void* pred, const void* ref,
                             const void* tau, void* partials, void* tickets,
                             void* err, void* accept, int dtype, int W,
                             long long N, long long chunk, int nchunks,
                             float eps, int vec, void* stream, int device) {
  return launch<kAccept>(pred, ref, partials, tickets, tau, nullptr, nullptr,
                         err, accept, dtype, W, N, chunk, nchunks, eps, vec,
                         0, stream, device);
}

// The mixed guided/unguided verify: gscale [W] f32 and paired [W] bytes (a
// torch.bool buffer) besides verify_accept's arguments. With pvec, N is a
// multiple of 4 and the pointers are aligned to 4 elements (the paired
// rows' groups).
extern "C" int verify_accept_mixed(const void* pred, const void* ref,
                                   const void* tau, const void* gscale,
                                   const void* paired, void* partials,
                                   void* tickets, void* err, void* accept,
                                   int dtype, int W, long long N,
                                   long long chunk, int nchunks, float eps,
                                   int vec, int pvec, void* stream,
                                   int device) {
  return launch<kMixed>(pred, ref, partials, tickets, tau, gscale, paired,
                        err, accept, dtype, W, N, chunk, nchunks, eps, vec,
                        pvec, stream, device);
}

// The τ-less sums: sums is [W, 2] f32 = (Σ(p−r)², Σr²) per row; the other
// arguments as for verify_accept.
extern "C" int verify_sums(const void* pred, const void* ref, void* partials,
                           void* tickets, void* sums, int dtype, int W,
                           long long N, long long chunk, int nchunks, int vec,
                           void* stream, int device) {
  return launch<kSums>(pred, ref, partials, tickets, nullptr, nullptr,
                       nullptr, sums, nullptr, dtype, W, N, chunk, nchunks,
                       0.f, vec, 0, stream, device);
}

// The τ-less error: err is [W] f32 = sqrt(Σ(p−r)²) / (sqrt(Σr²) + eps)
// per row, finished in the kernel as verify_accept finishes it; the other
// arguments as for verify_accept.
extern "C" int verify_error(const void* pred, const void* ref,
                            void* partials, void* tickets, void* err,
                            int dtype, int W, long long N, long long chunk,
                            int nchunks, float eps, int vec, void* stream,
                            int device) {
  return launch<kError>(pred, ref, partials, tickets, nullptr, nullptr,
                        nullptr, err, nullptr, dtype, W, N, chunk, nchunks,
                        eps, vec, 0, stream, device);
}
