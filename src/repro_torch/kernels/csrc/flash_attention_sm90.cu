// Flash attention on Hopper's tensor cores for bf16 q/k/v.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py:68, body _flash_kernel at :22) for
// bf16 inputs; f32 inputs keep flash_attention.cu, whose f32 products the
// f32 function needs (ops.flash_attention dispatches by dtype).
//
// The function is flash_attention.cu's: q/k/v [B, S, H, hd] read through
// their strides -> out [B, S, H, hd] contiguous bf16; f32 scores q·k/√hd,
// masked with −1e30 where key k is not visible from query q (k > q when
// causal, q − k >= window when window > 0, also without causal, k >= S),
// online softmax with f32 (m, l, acc), l == 0 -> 1, out = acc / l.
//
// Bound on the card: the dense bf16 tensor cores (4·hd operations per
// visible query–key pair). The design:
//
// - Grid and roles. One block per (128-query tile, b·h), heaviest causal
//   tiles first. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg) and one thread issues every TMA load. Warpgroups 1 and 2
//   are consumers of 64 query rows each.
// - TMA. One 4-D tensor map per operand, built from the [B, S, H, hd]
//   strides (dims hd, S, H, B), box = 64 head-dim columns (one swizzle
//   row of 128 bytes; 32 and 64 bytes at hd 16 and 32) by 128 queries or
//   128 keys, so hd 72 and 128 take two column blocks. Out-of-bounds zero
//   fill covers the ragged S tail and pads hd 72 to 80 for the k16 depth
//   of wgmma. Q is loaded once; K and V tiles go through a ring of
//   kStages stages, each with a full barrier per operand and one empty
//   barrier that all consumer threads arrive on.
// - q·kᵀ: wgmma m64n128k16 with Q and K both K-major in shared memory,
//   f32 accumulation of exact bf16 products (the reference's f32 scores
//   of bf16 values, up to the order of the sum).
// - Softmax on the accumulator fragments: each row is held by the four
//   threads of a quad, which reduce its max by shuffles; the per-thread
//   row sums are reduced once at the end. With c = log2(e)/√hd,
//   p = exp2((s − m)·c) and alpha = exp2((m_old − m_new)·c), the
//   subtraction first so that the −1e30 wipe below stays exact.
// - P·V: a tensor-core product needs P in bf16, and one rounding of P
//   puts ~24 % of the outputs of a causal S 2048 case outside one bf16
//   ulp of the f32 function. So P is split, P_hi = bf16(P),
//   P_lo = bf16(P − P_hi), and two register-sourced wgmmas
//   (m64n{hd}k16, V MN-major via the transpose bit) add P_hi·V + P_lo·V
//   into one f32 accumulator: 6·hd operations per visible pair where the
//   bound counts 4·hd, so at most ~67 % of the bound.
// - Schedule. Each consumer issues tile i's q·kᵀ beside tile i−1's P·V
//   and runs tile i's softmax while that P·V is on the tensor cores; the
//   two consumers take turns to issue (named barriers, ping-pong). The
//   instruction stream between the products is kept short: one cvt packs
//   two P values, one MUFU op gives each exp2.
// - Masks. −1e30, not −inf: a first tile that is wholly masked leaves
//   m = −1e30 and p = exp2(0) = 1; the first visible key wipes them with
//   alpha = exp2((−1e30 − m)·c) = 0 exactly. The same wipe makes it exact
//   to skip the key tiles hidden from the whole query tile; only the
//   tiles that a causal, window or S boundary crosses are masked.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;             // query rows per block
constexpr int kBK = 128;             // keys per tile (wgmma_ss_n128)
constexpr int kStages = 3;           // K/V ring depth
constexpr int kConsumers = 2;        // warpgroups of 64 query rows
constexpr int kThreads = 128 * (1 + kConsumers);

// head-dim columns of one TMA box and swizzle row (128 bytes at most),
// and the number of such column blocks an operand tile takes
template <int HD>
struct Cols {
  static constexpr int kBox = HD <= 16 ? 16 : HD <= 32 ? 32 : 64;
  static constexpr int kBlocks = (HD + kBox - 1) / kBox;
  static constexpr int kRowBytes = kBox * 2;
  static constexpr int kKSteps = (HD + 15) / 16;   // k16 steps of q·kᵀ
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint32_t kQBytes = kBlocks * kBQ * kRowBytes;
  static constexpr uint32_t kTileBytes = kBlocks * kBK * kRowBytes;
};

// shared memory: Q, then kStages K tiles and kStages V tiles (each
// 1024-byte aligned, as the 128-byte swizzle needs), then the barriers
template <int HD>
struct Smem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = Cols<HD>::kQBytes;
  static constexpr uint32_t kV = kK + kStages * Cols<HD>::kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * Cols<HD>::kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr uint32_t kAlloc = kBytes + 1024;   // room to align
  static_assert(Cols<HD>::kTileBytes % 1024 == 0, "tiles stay aligned");
};

// --- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// named barriers 1 and 2 order the two consumers' wgmma issue (ping-pong)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence/wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F4A "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// S[64 x 128] (+)= A[64 x 16] · B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(
    float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// O[64 x N] += A[64 x 16] · B[16 x N], A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(0)
      : F4A, "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, "
      "%19}, %20, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8)
      : F4A, "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : F4A, "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n72(
    float (&d)[36], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : F4A, "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : F4A, "l"(b), "r"(scale_d));
}


#undef F8
#undef F4A

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, b, 1);
  else if constexpr (HD == 32) wgmma_rs_n32(d, a, b, 1);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, b, 1);
  else if constexpr (HD == 72) wgmma_rs_n72(d, a, b, 1);
  else wgmma_rs_n128(d, a, b, 1);
}

// two finite f32 values -> their bf16 pair in one cvt (round to nearest
// even, as PyTorch rounds; the first in the low half, as the A fragment's
// lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// 2^x in one MUFU instruction (subnormal results flush to 0, which moves
// no probability by more than 2^-126)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  uint16_t* out;        // contiguous [B, S, H, hd] bf16
  int S, H, BH, nq, causal, window;
  float c;              // log2(e) / √hd
};

// barriers: q_full, k_full[kStages], v_full[kStages], empty[kStages]
__device__ __forceinline__ uint32_t bar_k(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bar_v(uint32_t bars, int s) {
  return bars + 8 * (1 + kStages + s);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + 2 * kStages + s);
}

// The fragments and running state of one consumer warpgroup: 64 query
// rows from row0. Thread (warp w, lane) holds rows row0 + 16w + lane/4
// (+8) and, in every n8 chunk j of a fragment, columns
// 8j + 2·(lane%4) + {0, 1}.
template <int HD>
struct Consumer {
  using C = Cols<HD>;
  static constexpr uint32_t kSbo = 8 * C::kRowBytes;    // next 8 rows/keys
  static constexpr uint32_t kMnLbo = kBK * C::kRowBytes;  // V's next column block

  const Params& p;
  uint32_t sQ, sK, sV, bars;
  int cw, row0, r0, col0;
  float o[HD / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t phi[kBK / 16][4], plo[kBK / 16][4];

  __device__ __forceinline__ Consumer(const Params& p_, uint32_t sQ_,
                                      uint32_t sK_, uint32_t sV_,
                                      uint32_t bars_, int cw_, int row0_)
      : p(p_), sQ(sQ_), sK(sK_), sV(sV_), bars(bars_), cw(cw_),
        row0(row0_) {
    const int t = threadIdx.x % 128, lane = t % 32;
    r0 = row0 + 16 * (t / 32) + lane / 4;
    col0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  }

  // S = Q·Kᵀ of stage s over the head dim, k16 steps across the column
  // blocks; issued and committed, not waited for
  __device__ __forceinline__ void issue_s(float (&sc)[kBK / 2], int s) {
#pragma unroll
    for (int kk = 0; kk < C::kKSteps; ++kk) {
      const int cb = kk * 16 / C::kBox;
      const uint32_t off = (kk * 16 % C::kBox) * 2;
      const uint64_t da = gmma_desc(
          sQ + cb * kBQ * C::kRowBytes + (row0 % kBQ) * C::kRowBytes + off,
          16, kSbo, C::kLayout);
      const uint64_t db = gmma_desc(
          sK + s * C::kTileBytes + cb * kBK * C::kRowBytes + off, 16, kSbo,
          C::kLayout);
      wgmma_ss_n128(sc, da, db, kk > 0);
    }
    wgmma_commit();
  }

  // O += P_hi·V + P_lo·V of stage s; issued and committed
  __device__ __forceinline__ void issue_pv(int s) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = gmma_desc(
          sV + s * C::kTileBytes + kk * 16 * C::kRowBytes, kMnLbo, kSbo,
          C::kLayout);
      wgmma_pv<HD>(o, phi[kk], dv);
      wgmma_pv<HD>(o, plo[kk], dv);
    }
    wgmma_commit();
  }

  // mask (only tiles that a causal, window or S boundary crosses), then
  // the online softmax of the scores of keys k0.. in place: sc becomes p,
  // (m, l) move on, and the returned factors rescale O
  __device__ __forceinline__ void softmax(float (&sc)[kBK / 2], int k0,
                                          float (&alpha)[2]) {
    const bool crossed = k0 + kBK > p.S ||
                         (p.causal && k0 + kBK - 1 > row0) ||
                         (p.window > 0 && row0 + 63 - k0 >= p.window);
    if (crossed) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * j + col0 + e, qi = r0 + 8 * rr;
            bool ok = kj < p.S;
            if (p.causal) ok = ok && kj <= qi;
            if (p.window > 0) ok = ok && qi - kj < p.window;
            if (!ok) sc[4 * j + 2 * rr + e] = kNegInf;
          }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]));
      // the quad of a row reduces its max
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      alpha[rr] = exp2_ftz((m[rr] - m_new) * p.c);
      m[rr] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * rr + e];
          x = exp2_ftz((x - m_new) * p.c);
          rs += x;
        }
      l[rr] = alpha[rr] * l[rr] + rs;    // this thread's columns only
    }
  }

  // P split into bf16 hi and lo A fragments, one per 16 keys
  __device__ __forceinline__ void split(const float (&sc)[kBK / 2]) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
        const uint32_t hi = pack_bf16(x0, x1);
        phi[kk][r] = hi;
        plo[kk][r] = pack_bf16(x0 - __uint_as_float(hi << 16),
                               x1 - __uint_as_float(hi & 0xFFFF0000u));
      }
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        o[4 * j + 2 * rr] *= alpha[rr];
        o[4 * j + 2 * rr + 1] *= alpha[rr];
      }
  }

  __device__ __forceinline__ void fence_p() {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      fence_regs(phi[kk]);
      fence_regs(plo[kk]);
    }
  }

  // Key tiles t_lo .. t_lo + n_tiles − 1, one software-pipelined loop:
  // tile i's q·kᵀ is issued beside tile i−1's P·V, and its softmax runs
  // while that P·V is on the tensor cores. The two consumers take turns
  // to issue (ping-pong): consumer 0 issues, then consumer 1, so one's
  // softmax runs while the other's products do.
  __device__ __forceinline__ void run(int t_lo, int n_tiles) {
    const int me = 1 + cw, other = 2 - cw;
    float sc[kBK / 2], alpha[2];
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) sc[e] = 0.f;
    if (cw == 1) named_arrive(other);              // consumer 0 goes first
    mbar_wait(bars, 0);                            // Q has landed
    mbar_wait(bar_k(bars, 0), 0);
    fence_regs(sc);
    named_sync(me);
    wgmma_fence();
    issue_s(sc, 0);
    named_arrive(other);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, t_lo * kBK, alpha);
    split(sc);
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(bar_k(bars, s), (i / kStages) & 1);
      mbar_wait(bar_v(bars, prev), ((i - 1) / kStages) & 1);
      fence_regs(sc);
      fence_regs(o);
      fence_p();
      named_sync(me);
      wgmma_fence();
      issue_s(sc, s);
      issue_pv(prev);
      named_arrive(other);
      wgmma_wait<1>();                             // the scores are in
      fence_regs(sc);
      softmax(sc, (t_lo + i) * kBK, alpha);
      wgmma_wait<0>();                             // tile i−1's P·V is done
      fence_regs(o);
      fence_p();
      mbar_arrive(bar_empty(bars, prev));          // stage i−1 is free
      rescale(alpha);
      split(sc);
    }
    const int last = (n_tiles - 1) % kStages;
    mbar_wait(bar_v(bars, last), ((n_tiles - 1) / kStages) & 1);
    fence_regs(o);
    fence_p();
    named_sync(me);
    wgmma_fence();
    issue_pv(last);
    if (cw == 0) named_arrive(other);   // consumer 1's last turn is its own
    wgmma_wait<0>();
    fence_regs(o);
  }

  // out = O / l in bf16 (rows past S are not written)
  __device__ __forceinline__ void store(int b, int h) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float li = l[rr];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li = li == 0.f ? 1.f : li;         // rows that see no key
      const int qi = r0 + 8 * rr;
      if (qi >= p.S) continue;
      uint16_t* ob =
          p.out + ((static_cast<int64_t>(b) * p.S + qi) * p.H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 8 * j + col0) =
            static_cast<uint32_t>(rt::BF16::store(o[4 * j + 2 * rr] / li)) |
            static_cast<uint32_t>(rt::BF16::store(o[4 * j + 2 * rr + 1] / li))
                << 16;
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cols<HD>;
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bars = base + L::kBar;

  // heaviest query tiles first: causal tile nq-1 sees the most key tiles
  const int qt = p.nq - 1 - static_cast<int>(blockIdx.x) / p.BH;
  const int bh = static_cast<int>(blockIdx.x) % p.BH;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBQ;
  // the key tiles some row of this block can see
  const int q_last = min(q0 + kBQ, p.S) - 1;
  const int k_hi = p.causal ? q_last : p.S - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / kBK, n_tiles = k_hi / kBK - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(bars, s), 1);
      mbar_init(bar_v(bars, s), 1);
      mbar_init(bar_empty(bars, s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, C::kQBytes);
      for (int cb = 0; cb < C::kBlocks; ++cb)
        tma_load_4d(sQ + cb * kBQ * C::kRowBytes, &qmap, bars, cb * C::kBox,
                    q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty(bars, s), ((i / kStages) & 1) ^ 1);
        const int k0 = (t_lo + i) * kBK;
        const uint32_t off = s * C::kTileBytes;
        mbar_expect_tx(bar_k(bars, s), C::kTileBytes);
        for (int cb = 0; cb < C::kBlocks; ++cb)
          tma_load_4d(sK + off + cb * kBK * C::kRowBytes, &kmap,
                      bar_k(bars, s), cb * C::kBox, k0, h, b);
        mbar_expect_tx(bar_v(bars, s), C::kTileBytes);
        for (int cb = 0; cb < C::kBlocks; ++cb)
          tma_load_4d(sV + off + cb * kBK * C::kRowBytes, &vmap,
                      bar_v(bars, s), cb * C::kBox, k0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Consumer<HD> c(p, sQ, sK, sV, bars, wg - 1, q0 + 64 * (wg - 1));
    c.run(t_lo, n_tiles);
    c.store(b, h);
  }
}

// --- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Error codes of this file beyond cudaError_t: kEncodeBase + the CUresult
// of cuTensorMapEncodeTiled, and kEncodeBase - 1 when the driver does not
// export it.
constexpr int kEncodeBase = 10000;

int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return kEncodeBase - 1;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return 0;
}

// A 4-D map (hd, S, H, B) of one bf16 operand; strides in elements.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
             int S, int H, int hd, long long sb, long long ss, long long sh,
             int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeBase + static_cast<int>(r);
}

template <int HD>
int launch(EncodeTiled encode, const void* q, const void* k, const void* v,
           void* out, int B, int S, int H, const long long* st, int causal,
           int window, float scale, cudaStream_t stream, int device) {
  using C = Cols<HD>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int e = make_map(encode, &maps[i], ptrs[i], B, S, H, HD,
                           st[3 * i], st[3 * i + 1], st[3 * i + 2], C::kBox,
                           i == 0 ? kBQ : kBK, C::kSwizzle);
    if (e) return e;
  }
  auto fn = flash_sm90_kernel<HD>;
  constexpr uint32_t bytes = Smem<HD>::kAlloc;
  static uint64_t attribute_set = 0;       // one bit per device
  if (!(attribute_set >> (device & 63) & 1)) {
    const int e = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
    if (e) return e;
    attribute_set |= uint64_t{1} << (device & 63);
  }
  Params p;
  p.out = static_cast<uint16_t*>(out);
  p.S = S;
  p.H = H;
  p.BH = B * H;
  p.nq = (S + kBQ - 1) / kBQ;
  p.causal = causal;
  p.window = window;
  p.c = scale * kLog2e;
  fn<<<static_cast<unsigned>(p.nq) * static_cast<unsigned>(p.BH), kThreads,
       bytes, stream>>>(maps[0], maps[1], maps[2], p);
  return rt::launched();
}

}  // namespace

// Returns 0 when launched, else a cudaError_t or an encode error (see
// kEncodeBase). q/k/v are bf16 [B, S, H, hd] with strides in elements
// (b, s, h; the last axis contiguous); out is a contiguous [B, S, H, hd]
// bf16 buffer. The caller guarantees hd in {16, 32, 64, 72, 128}, S >= 1,
// 16-byte-aligned bases and strides that are multiples of 8 elements.
extern "C" int flash_attention_sm90(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int hd, long long qsb,
                                    long long qss, long long qsh,
                                    long long ksb, long long kss,
                                    long long ksh, long long vsb,
                                    long long vss, long long vsh, int causal,
                                    int window, float scale, void* stream,
                                    int device) {
  if (B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  EncodeTiled encode;
  err = encoder(&encode);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  switch (hd) {
    case 16: return launch<16>(encode, q, k, v, out, B, S, H, st, causal, window, scale, s, device);
    case 32: return launch<32>(encode, q, k, v, out, B, S, H, st, causal, window, scale, s, device);
    case 64: return launch<64>(encode, q, k, v, out, B, S, H, st, causal, window, scale, s, device);
    case 72: return launch<72>(encode, q, k, v, out, B, S, H, st, causal, window, scale, s, device);
    case 128: return launch<128>(encode, q, k, v, out, B, S, H, st, causal, window, scale, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
