// Flash attention on Hopper's tensor cores for f32 q/k/v: 3×TF32 wgmma.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py:68, body _flash_kernel at :22) for
// f32 inputs, reached through ops.flash_attention and
// full_attention(..., use_flash=True); bf16 inputs take
// flash_attention_sm90.cu (ops.flash_attention dispatches by dtype).
//
// q/k/v [B, S, H, hd] f32 read through their strides -> out [B, S, H, hd]
// contiguous f32; scores q·k/√hd, masked with −1e30 where key k is not
// visible from query q (k > q when causal, q − k >= window when window >
// 0, also without causal, k >= S), online softmax with f32 (m, l, acc),
// l == 0 -> 1, out = acc / l.
//
// Bound on the card: the dense TF32 tensor cores, 494.7 TFLOP/s. Each
// product of two f32 values is taken as three TF32 products (below), so
// a visible query–key pair costs 3 · 4·hd = 12·hd operations: 0.83 ms at
// gemma3-27b global (S 4096, 32 heads of 128, causal), against 2.05 ms
// for the 4·hd operations on the f32 CUDA cores (67 TFLOP/s).
//
// The 3×TF32 split. x = hi + lo with hi = tf32(x) and lo = tf32(x − hi)
// (cvt.rna: round to nearest, ties away; x − hi is exact in f32), and
// a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, each TF32 product exact in the
// f32 accumulator. The dropped a_lo·b_lo and the rounding of the lo parts
// are ~2^-21 of |a·b|, so scores and P·V keep the f32 function's
// tolerance (rtol = atol = 2e-5); one TF32 product (2^-11) would not. A
// .tf32 operand is a 32-bit register or word whose low 13 mantissa bits
// the tensor cores ignore, which truncates the value. The kernel does not
// lean on that: hi and lo are both rounded explicitly, so every product
// sees exactly the parts of the split.
//
// Design (flash_attention_sm90.cu's where it fits):
//
// - Grid and roles. One block per (128-query tile, b·h), heaviest causal
//   tiles first. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg 48), one thread issues the TMA loads and all 128 threads
//   split and lay out the K and V tiles. Warpgroups 1 and 2 are consumers
//   of 64 query rows each (setmaxnreg 224). setmaxnreg.inc draws on
//   the registers that the block's own warps gave back: 128·(168 − 48)
//   = 15,360 cover 256·(224 − 168) = 14,336 (232 would need 16,384 and
//   wait for ever).
// - TMA. One 4-D tensor map per operand on the [B, S, H, hd] strides
//   (dims hd, S, H, B), no swizzle, box = hd × 128 queries or hd × BK
//   keys; out-of-bounds rows (the ragged S tail) arrive as zeros. Q lands
//   once in stage 1's space; each raw K and V tile in a raw buffer.
// - Operand layout. wgmma takes .tf32 shared-memory operands K-major only
//   (no transpose bit), so every shared operand is written by threads in
//   the no-swizzle K-major layout: 8-row × 16-byte core matrices, 128
//   bytes apart along M/N (SBO) and C bytes apart along K (LBO). The
//   producer reads a raw K tile [BK][hd] as float4s, splits them and
//   writes K_hi and K_lo; it reads V [BK][hd] a column at a time and
//   writes Vᵀ_hi and Vᵀ_lo [hd][BK] — the transpose that TMA cannot do
//   for 4-byte elements. The work items are ordered so that a warp's
//   reads and writes fall in distinct banks (a diagonal over each 8 × 8
//   block of K, consecutive columns of V).
// - q·kᵀ: Q_hi stays in registers as the A fragments (split once per
//   block); Q_lo goes to shared memory. S = Q_lo·K_hi (A from shared
//   memory) + Q_hi·K_lo + Q_hi·K_hi (A from registers), wgmma m64nBKk8.
// - P·V: P's accumulator fragments are the A fragments of a k8 step
//   except for the order of keys inside each group of 8 (thread t holds
//   keys 2t and 2t+1; the A fragment takes columns t and t + 4). Instead
//   of shuffling P, the producer writes Vᵀ with the keys of each group of
//   8 in the order 0 2 4 6 1 3 5 7, which is the same permutation; the
//   sum over keys does not care. P is split in registers, and
//   O += P_hi·Vᵀ_lo + P_lo·Vᵀ_hi + P_hi·Vᵀ_hi, wgmma m64n{hd}k8.
// - Softmax on the accumulator fragments as in the bf16 kernel: with
//   c = log2(e)/√hd, p = exp2((s − m)·c) and alpha = exp2((m_old −
//   m_new)·c) in one MUFU instruction each (ex2.approx.ftz: ~2^-22
//   relative), the quad of a row reduces its max by shuffles. O is
//   rescaled only when some row of the warp has a new max (exact).
// - Masks. −1e30, not −inf: a first tile that is wholly masked leaves
//   m = −1e30 and p = exp2(0) = 1; the first visible key wipes them with
//   alpha = exp2((−1e30 − m)·c) = 0 exactly. The same wipe makes it exact
//   to skip the key tiles hidden from the whole query tile; only the
//   tiles that a causal, window or S boundary crosses are masked.
//
// Shared memory (227 KB a block at most). Per stage K_hi, K_lo, Vᵀ_hi,
// Vᵀ_lo of BK keys = 16·BK·hd bytes; Q_lo 512·hd; the raw K and V tiles
// 8·BK·hd; raw Q (512·hd) lands in stage 1 before its first use. With
// two stages: hd 128, BK 32: 64 + 128 + 32 = 224 KB; hd 72, BK 64: 36 +
// 144 + 36 = 216 KB; hd 64, BK 64: 32 + 128 + 32 = 192 KB (hd 16 and 32
// less). A third stage does not fit at hd 64 and above.
// Registers of a consumer thread: Q_hi hd/2, S BK/2, O hd/2, P_hi and P_lo
// BK/2 each: 176 at hd 128 (BK 32), 168 at hd 72, under setmaxnreg 224.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;             // query rows per block
constexpr int kStages = 2;           // K/V ring depth
constexpr int kConsumers = 2;        // warpgroups of 64 query rows
constexpr int kThreads = 128 * (1 + kConsumers);
// barriers: q_full, q_free, raw_k, raw_v, full[kStages], empty[kStages]
constexpr int kBars = 4 + 2 * kStages;

template <int HD>
struct Tile {
  static constexpr int kBK = HD == 128 ? 32 : 64;   // keys per tile
  static constexpr int kKSteps = HD / 8;            // k8 steps of q·kᵀ
  static constexpr int kPSteps = kBK / 8;           // k8 steps of P·V
  static constexpr uint32_t kOp = kBK * HD * 4;     // one operand tile
  // K-major core-matrix strides along K (the descriptors' LBO), bytes
  static constexpr uint32_t kCK = kBK * 16;         // K tiles: along hd
  static constexpr uint32_t kCV = HD * 16;          // Vᵀ tiles: along keys
  static constexpr uint32_t kCA = 64 * 16;          // Q_lo: along hd
  // shared memory: Q_lo of both consumers, the stages, raw K and V, bars
  static constexpr uint32_t kQlo = 0;
  static constexpr uint32_t kStage = kQlo + kBQ * HD * 4;
  static constexpr uint32_t kRawK = kStage + kStages * 4 * kOp;
  static constexpr uint32_t kRawV = kRawK + kOp;
  static constexpr uint32_t kBar = kRawV + kOp;
  static constexpr uint32_t kAlloc = kBar + 8 * kBars + 1024;  // + align
  static_assert(kBQ * HD * 4 <= 4 * kOp, "raw Q fits in stage 1");
  static_assert(kOp % 1024 == 0 && kStage % 1024 == 0, "aligned tiles");
  static_assert(kAlloc <= 232448, "227 KB of shared memory a block");
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

// S[64 x 32] (+)= A[64 x 8] · B[8 x 32], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : F8(0), F8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// S[64 x 64] (+)= A[64 x 8] · B[8 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 16] (+)= A[64 x 8] · B[8 x 16], A (tf32) in registers, B K-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1;\n}\n"
      : F8(0)
      : F4A, "l"(b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] · B[8 x 32], A (tf32) in registers, B K-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : F8(0), F8(8)
      : F4A, "l"(b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] · B[8 x 64], A (tf32) in registers, B K-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : F4A, "l"(b), "r"(scale_d));
}

// D[64 x 72] (+)= A[64 x 8] · B[8 x 72], A (tf32) in registers, B K-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, "
      "%40, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : F4A, "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 8] · B[8 x 128], A (tf32) in registers, B K-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : F4A, "l"(b), "r"(scale_d));
}

#undef F8
#undef F4A

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  else wgmma_ss_n64(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b, 1);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b, 1);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b, 1);
  else if constexpr (N == 72) wgmma_rs_n72(d, a, b, 1);
  else wgmma_rs_n128(d, a, b, 1);
}

// descriptor of a K-major, no-swizzle operand whose core matrices lie
// `k_stride` bytes apart along K and 128 bytes apart along M/N
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, uint32_t k_stride) {
  return gmma_desc(addr, k_stride, 128, 0);
}

// x = hi + lo, both TF32 (round to nearest, ties away; x − hi is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// 2^x in one MUFU instruction (subnormal results flush to 0, which moves
// no probability by more than 2^-126)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// make this thread's generic-proxy writes to shared memory visible to
// the async proxy (the wgmma operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over `n` threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

struct Params {
  float* out;           // contiguous [B, S, H, hd] f32
  int S, H, BH, nq, causal, window;
  float c;              // log2(e) / √hd
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) {
  return bars + 8 * (4 + s);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (4 + kStages + s);
}

// --- producer: raw tiles -> TF32 hi/lo operands ------------------------------

// K [BK][hd] (raw, row-major) -> K_hi, K_lo K-major (N = keys, K = hd).
// Item w = (l, n-block, diagonal d): key 8·nb + l, float4 column
// (d + l) mod hd/4; a warp's 8-thread phases then read and write eight
// distinct 16-byte bank groups.
template <int HD>
__device__ __forceinline__ void convert_k(const float* raw, float* hi,
                                          float* lo, int tid) {
  using T = Tile<HD>;
  constexpr int kQ4 = HD / 4, kNB = T::kBK / 8;
#pragma unroll 2
  for (int j = 0; j < T::kBK * kQ4 / 128; ++j) {
    const int w = tid + 128 * j, l = w % 8, rest = w / 8;
    const int nb = rest % kNB, kq = (rest / kNB + l) % kQ4;
    const float4 x =
        *reinterpret_cast<const float4*>(raw + (8 * nb + l) * HD + 4 * kq);
    uint4 h, o;
    split_tf32(x.x, h.x, o.x);
    split_tf32(x.y, h.y, o.y);
    split_tf32(x.z, h.z, o.z);
    split_tf32(x.w, h.w, o.w);
    const int off = kq * (T::kCK / 4) + nb * 32 + l * 4;   // in floats
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = o;
  }
}

// V [BK][hd] (raw) -> Vᵀ_hi, Vᵀ_lo K-major (N = hd, K = keys), the keys
// of each group of 8 in the order 0 2 4 6 1 3 5 7 (P's fragment order).
// Item w = (hd column, group g, half h) writes one 16-byte core row: keys
// 8g + h + {0, 2, 4, 6} of one column.
template <int HD>
__device__ __forceinline__ void convert_v(const float* raw, float* hi,
                                          float* lo, int tid) {
  using T = Tile<HD>;
#pragma unroll 2
  for (int j = 0; j < HD * T::kBK / 4 / 128; ++j) {
    const int w = tid + 128 * j, col = w % HD, rest = w / HD;
    const int h = rest % 2, g = rest / 2;
    const float* src = raw + (8 * g + h) * HD + col;
    uint4 a, b;
    split_tf32(src[0], a.x, b.x);
    split_tf32(src[2 * HD], a.y, b.y);
    split_tf32(src[4 * HD], a.z, b.z);
    split_tf32(src[6 * HD], a.w, b.w);
    const int off = (2 * g + h) * (T::kCV / 4) + (col / 8) * 32 + (col % 8) * 4;
    *reinterpret_cast<uint4*>(hi + off) = a;
    *reinterpret_cast<uint4*>(lo + off) = b;
  }
}

// The producer warpgroup: thread 0 loads Q and every raw K/V tile with
// TMA; all 128 threads turn raw tile i into stage i % kStages.
template <int HD>
__device__ __forceinline__ void produce(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    uint32_t base, uint8_t* gbase, int q0, int h, int b, int t_lo,
    int n_tiles) {
  using T = Tile<HD>;
  const int tid = threadIdx.x;
  const uint32_t bars = base + T::kBar;
  const uint32_t q_full = bars, q_free = bars + 8, raw_k = bars + 16,
                 raw_v = bars + 24;
  const auto load_raw = [&](int i) {
    const int k0 = (t_lo + i) * T::kBK;
    mbar_expect_tx(raw_k, T::kOp);
    tma_load_4d(base + T::kRawK, kmap, raw_k, 0, k0, h, b);
    mbar_expect_tx(raw_v, T::kOp);
    tma_load_4d(base + T::kRawV, vmap, raw_v, 0, k0, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, kBQ * HD * 4);
    tma_load_4d(base + T::kStage + 4 * T::kOp, qmap, q_full, 0, q0, h, b);
    load_raw(0);
  }
  const float* rk = reinterpret_cast<const float*>(gbase + T::kRawK);
  const float* rv = reinterpret_cast<const float*>(gbase + T::kRawV);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    float* st = reinterpret_cast<float*>(gbase + T::kStage + s * 4 * T::kOp);
    if (i == 1) mbar_wait(q_free, 0);    // stage 1 held the raw Q tile
    mbar_wait(bar_empty(bars, s), ((i / kStages) & 1) ^ 1);
    mbar_wait(raw_k, i & 1);
    convert_k<HD>(rk, st, st + T::kOp / 4, tid);
    mbar_wait(raw_v, i & 1);
    convert_v<HD>(rv, st + T::kOp / 2, st + 3 * T::kOp / 4, tid);
    fence_async_smem();
    mbar_arrive(bar_full(bars, s));
    bar_sync(3, 128);                    // every read of the raw tiles done
    if (tid == 0 && i + 1 < n_tiles) load_raw(i + 1);
  }
}

// --- consumers ---------------------------------------------------------------

// The fragments and running state of one consumer warpgroup: 64 query
// rows from row0. Thread (warp w, lane) holds rows row0 + 16w + lane/4
// (+8); in the accumulators, columns 8j + 2·(lane%4) + {0, 1} of every n8
// chunk j; in an A fragment of a k8 step, columns lane%4 and lane%4 + 4.
template <int HD>
struct Consumer {
  using T = Tile<HD>;
  static constexpr int kBK = T::kBK;

  const Params& p;
  uint32_t sQlo, sStage, bars;
  int cw, row0, r0, col0;
  uint32_t qh[T::kKSteps][4];
  float o[HD / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t phi[T::kPSteps][4], plo[T::kPSteps][4];

  __device__ __forceinline__ Consumer(const Params& p_, uint32_t base,
                                      int cw_, int row0_)
      : p(p_), sQlo(base + T::kQlo + cw_ * 64 * HD * 4),
        sStage(base + T::kStage), bars(base + T::kBar), cw(cw_),
        row0(row0_) {
    const int lane = threadIdx.x % 32;
    r0 = row0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    col0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  }

  // Q from its raw tile (in stage 1): Q_hi into the A fragments, Q_lo into
  // shared memory (K-major cores, 1024 bytes apart along hd); then stage 1
  // is free for the producer
  __device__ __forceinline__ void load_q(uint8_t* gbase) {
    mbar_wait(bars, 0);
    const float* raw = reinterpret_cast<const float*>(
                           gbase + T::kStage + 4 * T::kOp) + cw * 64 * HD;
    float* qlo = reinterpret_cast<float*>(gbase + T::kQlo) + cw * 64 * HD;
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    const int t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < T::kKSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + lane / 4 + 8 * (e & 1);
        const int col = 8 * kk + t + 4 * (e >> 1);
        uint32_t lo;
        split_tf32(raw[row * HD + col], qh[kk][e], lo);
        qlo[(2 * kk + (e >> 1)) * (T::kCA / 4) + (row / 8) * 32 +
            (row % 8) * 4 + t] = __uint_as_float(lo);
      }
    fence_async_smem();
    bar_sync(1 + cw, 128);               // this warpgroup's Q_lo is written
    mbar_arrive(bars + 8);               // q_free
  }

  // S = Q_lo·K_hi + Q_hi·K_lo + Q_hi·K_hi of stage s over the head dim
  __device__ __forceinline__ void issue_s(float (&sc)[kBK / 2], int s) {
    const uint32_t khi = sStage + s * 4 * T::kOp, klo = khi + T::kOp;
#pragma unroll
    for (int kk = 0; kk < T::kKSteps; ++kk) {
      const uint32_t off = 2 * kk * T::kCK;
      wgmma_ss<kBK>(sc, kmajor(sQlo + 2 * kk * T::kCA, T::kCA),
                    kmajor(khi + off, T::kCK), kk > 0);
      wgmma_rs<kBK>(sc, qh[kk], kmajor(klo + off, T::kCK));
      wgmma_rs<kBK>(sc, qh[kk], kmajor(khi + off, T::kCK));
    }
    wgmma_commit();
  }

  // O += P_hi·Vᵀ_lo + P_lo·Vᵀ_hi + P_hi·Vᵀ_hi of stage s
  __device__ __forceinline__ void issue_pv(int s) {
    const uint32_t vhi = sStage + s * 4 * T::kOp + 2 * T::kOp;
    const uint32_t vlo = vhi + T::kOp;
#pragma unroll
    for (int kk = 0; kk < T::kPSteps; ++kk) {
      const uint32_t off = 2 * kk * T::kCV;
      wgmma_rs<HD>(o, phi[kk], kmajor(vlo + off, T::kCV));
      wgmma_rs<HD>(o, plo[kk], kmajor(vhi + off, T::kCV));
      wgmma_rs<HD>(o, phi[kk], kmajor(vhi + off, T::kCV));
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

  // P split into TF32 hi and lo A fragments, one per 8 keys: the
  // accumulator's keys 2t, 2t+1 of rows r, r+8 go to A columns t, t+4
  __device__ __forceinline__ void split(const float (&sc)[kBK / 2]) {
#pragma unroll
    for (int kk = 0; kk < T::kPSteps; ++kk) {
      split_tf32(sc[4 * kk], phi[kk][0], plo[kk][0]);
      split_tf32(sc[4 * kk + 2], phi[kk][1], plo[kk][1]);
      split_tf32(sc[4 * kk + 1], phi[kk][2], plo[kk][2]);
      split_tf32(sc[4 * kk + 3], phi[kk][3], plo[kk][3]);
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
    for (int kk = 0; kk < T::kPSteps; ++kk) {
      fence_regs(phi[kk]);
      fence_regs(plo[kk]);
    }
  }

  // key tiles t_lo .. t_lo + n_tiles − 1: q·kᵀ, softmax, P·V in turn
  __device__ __forceinline__ void run(int t_lo, int n_tiles) {
    float sc[kBK / 2], alpha[2];
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(bar_full(bars, s), (i / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_s(sc, s);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, (t_lo + i) * kBK, alpha);
      // O *= alpha, unless no row of the warp has a new max (exact)
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))
        rescale(alpha);
      split(sc);
      fence_regs(o);
      fence_p();
      wgmma_fence();
      issue_pv(s);
      wgmma_wait<0>();
      fence_regs(o);
      fence_p();
      mbar_arrive(bar_empty(bars, s));   // stage s is free
    }
  }

  // out = O / l (rows past S are not written)
  __device__ __forceinline__ void store(int b, int h) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float li = l[rr];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li = li == 0.f ? 1.f : li;         // rows that see no key
      const int qi = r0 + 8 * rr;
      if (qi >= p.S) continue;
      float* ob = p.out + ((static_cast<int64_t>(b) * p.S + qi) * p.H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(ob + 8 * j + col0) =
            make_float2(o[4 * j + 2 * rr] / li, o[4 * j + 2 * rr + 1] / li);
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Params p) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw0);
  const uint32_t bars = base + T::kBar;

  // heaviest query tiles first: causal tile nq-1 sees the most key tiles
  const int qt = p.nq - 1 - static_cast<int>(blockIdx.x) / p.BH;
  const int bh = static_cast<int>(blockIdx.x) % p.BH;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBQ;
  // the key tiles some row of this block can see
  const int q_last = min(q0 + kBQ, p.S) - 1;
  const int k_hi = p.causal ? q_last : p.S - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / T::kBK, n_tiles = k_hi / T::kBK - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);                           // q_full
    mbar_init(bars + 8, 128 * kConsumers);        // q_free
    mbar_init(bars + 16, 1);                      // raw_k
    mbar_init(bars + 24, 1);                      // raw_v
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(bars, s), 128);
      mbar_init(bar_empty(bars, s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 48;\n");
    produce<HD>(&qmap, &kmap, &vmap, base, gbase, q0, h, b, t_lo, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    Consumer<HD> c(p, base, wg - 1, q0 + 64 * (wg - 1));
    c.load_q(gbase);
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

// A 4-D map (hd, S, H, B) of one f32 operand, no swizzle; strides in
// elements.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
             int S, int H, int hd, long long sb, long long ss, long long sh,
             int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 4,
                                 static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeBase + static_cast<int>(r);
}

template <int HD>
int launch(EncodeTiled encode, const void* q, const void* k, const void* v,
           void* out, int B, int S, int H, const long long* st, int causal,
           int window, float scale, cudaStream_t stream, int device) {
  using T = Tile<HD>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int e = make_map(encode, &maps[i], ptrs[i], B, S, H, HD, st[3 * i],
                           st[3 * i + 1], st[3 * i + 2],
                           i == 0 ? kBQ : T::kBK);
    if (e) return e;
  }
  auto fn = flash_f32_kernel<HD>;
  static uint64_t attribute_set = 0;       // one bit per device
  if (!(attribute_set >> (device & 63) & 1)) {
    const int e = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::kAlloc)));
    if (e) return e;
    attribute_set |= uint64_t{1} << (device & 63);
  }
  Params p;
  p.out = static_cast<float*>(out);
  p.S = S;
  p.H = H;
  p.BH = B * H;
  p.nq = (S + kBQ - 1) / kBQ;
  p.causal = causal;
  p.window = window;
  p.c = scale * kLog2e;
  fn<<<static_cast<unsigned>(p.nq) * static_cast<unsigned>(p.BH), kThreads,
       T::kAlloc, stream>>>(maps[0], maps[1], maps[2], p);
  return rt::launched();
}

}  // namespace

// Returns 0 when launched, else a cudaError_t or an encode error (see
// kEncodeBase). q/k/v are f32 [B, S, H, hd] with strides in elements
// (b, s, h; the last axis contiguous); out is a contiguous [B, S, H, hd]
// f32 buffer. The caller guarantees hd in {16, 32, 64, 72, 128}, S >= 1,
// 16-byte-aligned bases and strides that are multiples of 4 elements.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int hd,
                               long long qsb, long long qss, long long qsh,
                               long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh,
                               int causal, int window, float scale,
                               void* stream, int device) {
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
