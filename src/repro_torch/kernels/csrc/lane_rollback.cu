// Per-lane snapshot restore: the rollback of a depth-K chain.
//
// Replaces the TPU kernel lane_rollback_2d
// (src/repro/kernels/taylor_predict.py:166, pallas_call at :187).
//
// chain [K+1, R, C] (R = G·lanes, lane = row % lanes) of any element
// size, idx [lanes] int32 -> out [R, C] = chain[clamp(idx[lane], 0, K),
// row]. Exact copies of the selected snapshot, so the restore is bitwise
// whichever snapshot wins; the clamp is what the reference's where-chain
// over the snapshot axis does with an index outside 0..K.
//
// Bound on the card: bytes, and at the serving shape (a [5, 4, 4096] f32
// latent chain, 131 KB moved) the launch itself. The TPU kernel reads all
// K+1 snapshot tiles into its where-chain; here a block loads its lane's
// index once and reads only the selected snapshot's row, so the bytes are
// one row read and one row written. Design: one block row per output row,
// each thread copying one unit — 16 bytes when the row length and the
// pointers allow, else the widest of 8, 4, 2, 1 bytes that divides them.
#include "common.cuh"

namespace {

template <class U>
__global__ void __launch_bounds__(rt::kThreads)
rollback_kernel(const U* __restrict__ chain, const int32_t* __restrict__ idx,
                U* __restrict__ out, int K, int64_t R, int64_t units,
                int lanes) {
  const int64_t row = blockIdx.y;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (u >= units) return;
  int k = idx[row % lanes];
  k = k < 0 ? 0 : (k > K ? K : k);
  out[row * units + u] = chain[(k * R + row) * units + u];
}

template <class U>
void launch(const void* chain, const int32_t* idx, void* out, int K,
            int64_t R, int64_t row_bytes, int lanes, cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(U));
  dim3 grid(static_cast<unsigned>((units + rt::kThreads - 1) / rt::kThreads),
            static_cast<unsigned>(R));
  rollback_kernel<U><<<grid, rt::kThreads, 0, stream>>>(
      static_cast<const U*>(chain), idx, static_cast<U*>(out), K, R, units,
      lanes);
}

// The copy unit for rows of `row_bytes` bytes whose base pointers are all
// aligned to `align` bytes: the widest of 16, 8, 4, 2, 1 dividing both.
int copy_unit(long long row_bytes, unsigned long long align) {
  int u = 16;
  while (u > 1 && (row_bytes % u != 0 || align % u != 0)) u /= 2;
  return u;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). The caller
// guarantees K >= 0, 1 <= R < 65536, row_bytes >= 1 and contiguous
// buffers; the copy unit follows from row_bytes and the pointers.
extern "C" int lane_rollback(const void* chain, const void* idx, void* out,
                             int K, long long R, long long row_bytes,
                             int lanes, void* stream, int device) {
  if (K < 0 || R < 1 || row_bytes < 1 || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int32_t*>(idx);
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(chain) |
      reinterpret_cast<unsigned long long>(out);
  switch (copy_unit(row_bytes, align)) {
    case 16: launch<uint4>(chain, ix, out, K, R, row_bytes, lanes, s); break;
    case 8: launch<uint2>(chain, ix, out, K, R, row_bytes, lanes, s); break;
    case 4: launch<uint32_t>(chain, ix, out, K, R, row_bytes, lanes, s);
      break;
    case 2: launch<uint16_t>(chain, ix, out, K, R, row_bytes, lanes, s);
      break;
    default: launch<uint8_t>(chain, ix, out, K, R, row_bytes, lanes, s);
  }
  return rt::launched();
}
