// Per-lane snapshot restore: the rollback of a depth-K chain.
//
// Replaces the TPU kernel lane_rollback_2d
// (src/repro/kernels/taylor_predict.py:166, pallas_call at :187).
//
// K+1 snapshots [R, C] (R = G·lanes, lane = row % lanes) of any element
// size, idx [lanes] int32 -> out [R, C] = snapshot clamp(idx[lane], 0, K)
// at row. Exact copies of the selected snapshot, so the restore is bitwise
// whichever snapshot wins; the clamp is what the reference's where-chain
// over the snapshot axis does with an index outside 0..K.
//
// Bound on the card: bytes — one selected row read and one row written
// per output row, and idx. At the serving shape (the latent x, [4 lanes,
// 32, 32, 4] f32: 16 KB a lane, 64 KB a snapshot) that is 131 KB, 0.04 µs
// at 3.35 TB/s, against the ~1.4 µs that any launch takes on this card:
// the kernel sits at the launch floor, and no rewrite of its body brings
// it near its bound. The TPU kernel reads all K+1 snapshot tiles into its
// where-chain; here a block loads its lane's index once, clamps it and
// copies one row of the selected snapshot.
//
// What the design removes is the work around the kernel. The chain step
// used to torch.stack its K+1 snapshots into one [K+1, R, C] buffer — a
// copy of (K+1)·64 KB and a launch on every chain tick — for this kernel
// to read one of them. The entry lane_rollback_snapshots reads the
// snapshots where they lie: it takes their K+1 base pointers and passes
// them by value, as a table of kMaxSnapshots entries in the kernel's
// parameter space (2 KB; with the other arguments under the 4 KB limit),
// so there is no device-side pointer table and no host-to-device copy per
// call. The entry lane_rollback keeps the reference's stacked signature:
// it addresses snapshot k as chain + k·R·row_bytes and needs no table. The
// kernel is the same size either way.
//
// Copy unit: one thread copies 16 bytes when the row length and every
// pointer (each snapshot's base and out) allow it, else the widest of 8,
// 4, 2, 1 bytes that divides them all.
#include "common.cuh"

namespace {

constexpr int kMaxSnapshots = 256;   // _MAX_SNAPSHOTS in ops.py

// snapshot k of a stacked [K+1, R, C] buffer: base + k·stride units
template <class U>
struct Stacked {
  const U* base;
  int64_t stride;
  __device__ __forceinline__ const U* operator[](int k) const {
    return base + k * stride;
  }
};

// snapshot k at its own base pointer (the first K+1 entries are set)
template <class U>
struct Table {
  const U* p[kMaxSnapshots];
  __device__ __forceinline__ const U* operator[](int k) const {
    return p[k];
  }
};

template <class U, class Snaps>
__global__ void __launch_bounds__(rt::kThreads)
rollback_kernel(const __grid_constant__ Snaps snaps,
                const int32_t* __restrict__ idx, U* __restrict__ out, int K,
                int64_t units, int lanes) {
  const int64_t row = blockIdx.y;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (u >= units) return;
  int k = idx[row % lanes];
  k = k < 0 ? 0 : (k > K ? K : k);
  out[row * units + u] = snaps[k][row * units + u];
}

template <class U, class Snaps>
void launch(const Snaps& snaps, const int32_t* idx, void* out, int K,
            int64_t R, int64_t units, int lanes, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((units + rt::kThreads - 1) / rt::kThreads),
            static_cast<unsigned>(R));
  rollback_kernel<U, Snaps><<<grid, rt::kThreads, 0, stream>>>(
      snaps, idx, static_cast<U*>(out), K, units, lanes);
}

// The copy unit for rows of `row_bytes` bytes whose base pointers are all
// aligned to `align` bytes: the widest of 16, 8, 4, 2, 1 dividing both.
int copy_unit(long long row_bytes, unsigned long long align) {
  int u = 16;
  while (u > 1 && (row_bytes % u != 0 || align % u != 0)) u /= 2;
  return u;
}

// Calls f(U{}) with U the unsigned type of `unit` bytes.
template <class F>
void by_unit(int unit, F f) {
  switch (unit) {
    case 16: f(uint4{}); break;
    case 8: f(uint2{}); break;
    case 4: f(uint32_t{}); break;
    case 2: f(uint16_t{}); break;
    default: f(uint8_t{});
  }
}

unsigned long long address(const void* p) {
  return reinterpret_cast<unsigned long long>(p);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). chain is the
// stacked [K+1, R, C] buffer, contiguous. The caller guarantees
// 1 <= R < 65536 and contiguous buffers; the copy unit follows from
// row_bytes and the pointers.
extern "C" int lane_rollback(const void* chain, const void* idx, void* out,
                             int K, long long R, long long row_bytes,
                             int lanes, void* stream, int device) {
  if (K < 0 || R < 1 || row_bytes < 1 || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int32_t*>(idx);
  by_unit(copy_unit(row_bytes, address(chain) | address(out)), [&](auto t) {
    using U = decltype(t);
    const int64_t units = row_bytes / static_cast<int64_t>(sizeof(U));
    launch<U>(Stacked<U>{static_cast<const U*>(chain), R * units}, ix, out,
              K, R, units, lanes, s);
  });
  return rt::launched();
}

// The same restore from n = K+1 snapshots [R, C] at their own base
// pointers snaps[0..n-1] (a host array, copied into the launch's
// parameters), 1 <= n <= kMaxSnapshots; otherwise as lane_rollback.
extern "C" int lane_rollback_snapshots(const void* const* snaps, int n,
                                       const void* idx, void* out,
                                       long long R, long long row_bytes,
                                       int lanes, void* stream, int device) {
  if (n < 1 || n > kMaxSnapshots || R < 1 || row_bytes < 1 || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = rt::prepare(device);
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int32_t*>(idx);
  unsigned long long align = address(out);
  for (int k = 0; k < n; ++k) align |= address(snaps[k]);
  by_unit(copy_unit(row_bytes, align), [&](auto t) {
    using U = decltype(t);
    Table<U> table{};
    for (int k = 0; k < n; ++k) table.p[k] = static_cast<const U*>(snaps[k]);
    launch<U>(table, ix, out, n - 1, R,
              row_bytes / static_cast<int64_t>(sizeof(U)), lanes, s);
  });
  return rt::launched();
}
