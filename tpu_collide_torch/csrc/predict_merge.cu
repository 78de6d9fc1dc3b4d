// The fused prediction's per-pair merge for Hopper (sm_90a): for each row,
// the top merge_k of its occupied predict slots over every offset, by risk
// and then the lower pool column (offset * k_slots + slot), kept once per
// other id (its highest-risk entry), as merge_pair_risks(..., return_kth=
// True) gives it over the row's pool of n_off * k_slots columns.
//
// Replaces no TPU kernel: the JAX package leaves the fused prediction's
// merge to XLA (tpu_collide/kernels/refine.py:963, merge_pair_risks over
// the dense pool in fused_predict_rows). The port built the same pool in
// PyTorch (kernels/refine.merge_slots_plain): five [n_off, m, k_slots]
// buffers filled and scattered into, permuted into [m, n_off * k_slots],
// every row sorted whole to keep merge_k, then sorted by other id and
// scanned over [m, merge_k] to drop duplicates. At the 1M-drone warn
// cell's density about 1% of the pool's 160M entries are occupied, and the
// sorts and scans alone took about 31 ms of device time a call on an H100.
//
// One warp a row, its lanes on the offsets (lane o takes offsets o, o + 32,
// ...). A row's occupied slots sit in the recompute's order (the occupancy
// mask's nonzero, row-major over [n_off, m, k_slots]), so those of (offset
// o, row r) are positions ends[o * m + r - 1] .. ends[o * m + r] - 1, where
// `ends` is the inclusive prefix sum of the (offset, row) counts; `slot`
// gives each one's slot. The warp touches only its row's occupied entries,
// and builds no pool:
//   1. it counts the row's valid hits (hit and risk >= 0: the pool's
//      where(hit, risk, -1) >= 0);
//   2. where there are merge_k or more, it selects the merge_k-th largest
//      key, bit by bit over the 64-bit keys (the risk's bits above, the
//      column's complement below: all distinct), counting with the warp;
//   3. each kept hit (key at or above that threshold, or every hit) goes to
//      the warp's shared memory, at most cap = min(merge_k, n_off *
//      k_slots) of them; past SMEM_CAP kept hits a row (a merge wider than
//      256 over more than 256 columns) to a global scratch of cap entries
//      a row instead;
//   4. each kept hit's position is its rank by (other id ascending, key
//      descending) among the kept; the first of each other id writes the
//      entry, the others and the positions past the kept write the fill
//      (0, false, 0, inf, inf), as merge_pair_risks leaves them.
// At the warn cell almost every row holds 0-3 hits, so step 2 does not run
// and step 4 compares a handful; a full row (20 x 32 = 640 columns) takes
// 64 counting passes over its slots.
//
// What bounds it: the bytes. The [m, merge_k] outputs are written once
// (17 bytes an entry: 544 MB at 1M rows and merge_k 32, 0.16 ms at 3.35
// TB/s), the prefix sums read once (80 MB at 20 offsets), the occupied
// slots' values once (25 bytes each). The values are copied, and the keys
// order floats as the pool's stable sort does (risks >= 0, -0.0 as +0.0),
// so the outputs are merge_pair_risks' bit for bit.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_CAP = 256;  // 16 bytes a kept hit: 32 KB a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// a hit's merge key: the larger key is the higher risk, then the lower
// column. A risk >= +0.0 orders as its bits do; + 0.0f makes -0.0 +0.0.
__device__ __forceinline__ unsigned long long merge_key(float risk, int col) {
  return (static_cast<unsigned long long>(__float_as_uint(risk + 0.0f))
          << 32) |
         static_cast<unsigned>(~col);
}

__global__ void __launch_bounds__(THREADS)
predict_merge_kernel(const int* __restrict__ ends,
                     const long long* __restrict__ slot,
                     const int* __restrict__ other,
                     const uint8_t* __restrict__ hit,
                     const float* __restrict__ risk,
                     const float* __restrict__ ttc,
                     const float* __restrict__ dist, int n_off, int m,
                     int k_slots, int merge_k, int cap,
                     unsigned long long* __restrict__ scratch,
                     int* __restrict__ out_other,
                     uint8_t* __restrict__ out_valid,
                     float* __restrict__ out_risk,
                     float* __restrict__ out_ttc,
                     float* __restrict__ out_dist,
                     float* __restrict__ kth) {
  extern __shared__ unsigned long long s_key_all[];
  __shared__ int s_n[WARPS];
  __shared__ float s_kth[WARPS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * WARPS + w;
  if (r >= m) return;  // the whole warp: r is the warp's
  // the row's kept hits: keys, other ids, positions; cap of each
  unsigned long long* s_key;
  int* s_other;
  if (scratch != nullptr) {
    s_key = scratch + r * 2 * cap;
    s_other = reinterpret_cast<int*>(s_key + cap);
  } else {
    s_key = s_key_all + w * cap;
    s_other = reinterpret_cast<int*>(s_key_all + WARPS * cap) + 2 * w * cap;
  }
  int* s_pos = s_other + cap;

  // f(col, p) for each occupied slot of this lane's offsets
  auto each = [&](auto&& f) {
    for (int o = lane; o < n_off; o += 32) {
      const long long fo = static_cast<long long>(o) * m + r;
      const int e = ends[fo];
      for (int p = fo ? ends[fo - 1] : 0; p < e; ++p)
        f(o * k_slots + static_cast<int>(slot[p]), p);
    }
  };
  auto valid = [&](int p) { return hit[p] != 0 && risk[p] >= 0.0f; };

  int nv = 0;
  each([&](int, int p) { nv += valid(p); });
  nv = warp_sum(nv);

  // keys >= thr are kept: the merge_k largest, or every valid hit
  unsigned long long thr = 0;
  if (nv >= merge_k) {
    unsigned long long known = 0;
    int need = merge_k;
    for (int bit = 63; bit >= 0; --bit) {
      const unsigned long long b = 1ull << bit, mask = known | b;
      const unsigned long long want = thr | b;
      int c = 0;
      each([&](int col, int p) {
        c += valid(p) && (merge_key(risk[p], col) & mask) == want;
      });
      c = warp_sum(c);
      if (c >= need)
        thr = want;
      else
        need -= c;
      known = mask;
    }
  }

  if (lane == 0) s_n[w] = 0;
  __syncwarp();
  each([&](int col, int p) {
    if (!valid(p)) return;
    const unsigned long long key = merge_key(risk[p], col);
    if (key < thr) return;
    const int i = atomicAdd(&s_n[w], 1);
    s_key[i] = key;
    s_other[i] = other[p];
    s_pos[i] = p;
    if (key == thr) s_kth[w] = risk[p];  // only when nv >= merge_k
  });
  __syncwarp();
  const int n_sel = s_n[w];

  const long long base = r * merge_k;
  for (int j = lane; j < n_sel; j += 32) {
    const unsigned long long kj = s_key[j];
    const int oj = s_other[j];
    int at = 0;
    bool first = true;
    for (int i = 0; i < n_sel; ++i) {
      const int oi = s_other[i];
      const bool above = oi == oj && s_key[i] > kj;
      at += oi < oj || above;
      first = first && !above;
    }
    const int pj = s_pos[j];
    const long long q = base + at;
    out_other[q] = first ? oj : 0;
    out_valid[q] = first;
    out_risk[q] = first ? risk[pj] : 0.0f;
    out_ttc[q] = first ? ttc[pj] : INFINITY;
    out_dist[q] = first ? dist[pj] : INFINITY;
  }
  for (int j = n_sel + lane; j < merge_k; j += 32) {
    const long long q = base + j;
    out_other[q] = 0;
    out_valid[q] = 0;
    out_risk[q] = 0.0f;
    out_ttc[q] = INFINITY;
    out_dist[q] = INFINITY;
  }
  if (lane == 0) kth[r] = nv >= merge_k ? s_kth[w] : -1.0f;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// ends [n_off * m] int32: inclusive prefix sums of the occupied slots of
// each (offset, row), offset-major; slot [p] int64, the slot of each
// occupied one in that order; other [p] int32, hit [p] bool (one byte),
// risk, ttc, dist [p] f32 its recomputed pair. Outputs out_other [m,
// merge_k] int32, out_valid [m, merge_k] bool, out_risk, out_ttc, out_dist
// [m, merge_k] f32 and kth [m] f32. merge_k >= 1. scratch: 16 * cap
// bytes a row (cap = min(merge_k, n_off * k_slots)) where cap > 256, else
// null: the rows' kept hits then stay in shared memory.
int tc_predict_merge(const void* ends, const void* slot, const void* other,
                     const void* hit, const void* risk, const void* ttc,
                     const void* dist, int n_off, int m, int k_slots,
                     int merge_k, void* out_other, void* out_valid,
                     void* out_risk, void* out_ttc, void* out_dist,
                     void* kth, void* scratch, void* stream) {
  const long long cols = static_cast<long long>(n_off) * k_slots;
  if (n_off < 1 || m < 0 || k_slots < 1 || merge_k < 1 ||
      cols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = static_cast<int>(cols < merge_k ? cols : merge_k);
  if ((cap > SMEM_CAP) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((m + WARPS - 1) / WARPS);
  const size_t smem = scratch != nullptr
                          ? 0
                          : static_cast<size_t>(WARPS) * cap *
                                (sizeof(unsigned long long) + 2 * sizeof(int));
  predict_merge_kernel<<<blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ends), static_cast<const long long*>(slot),
      static_cast<const int*>(other), static_cast<const uint8_t*>(hit),
      static_cast<const float*>(risk), static_cast<const float*>(ttc),
      static_cast<const float*>(dist), n_off, m, k_slots, merge_k, cap,
      static_cast<unsigned long long*>(scratch), static_cast<int*>(out_other), static_cast<uint8_t*>(out_valid),
      static_cast<float*>(out_risk), static_cast<float*>(out_ttc),
      static_cast<float*>(out_dist), static_cast<float*>(kth));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
