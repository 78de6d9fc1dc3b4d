// The fast refine tail's scene cut for Hopper (sm_90a): the top a of the
// masked slot keys and the hot rows' keys by (key descending, flat index
// ascending), their count, and the scene's max_risk.
//
// Replaces no Pallas kernel. The JAX package leaves its scene cut
// (tpu_collide/kernels/refine.py:402-434, an exact two-stage cut: block
// maxima, the top-A rows by their best slot, then those rows' slots) to
// XLA. The port first took it as one flat cut over all m*k slots: about ten
// elementwise passes that build a 64-bit key, a radix torch.topk over 640 MB
// of them at 10M objects, and four more passes for max_risk, some 12 GB a
// step. The cut needs only one read of the slot keys and of the two row
// masks: at 10M x 8 that is 340 MB, 0.10 ms at 3.35 TB/s. That read is the
// bound; everything after it touches a few MB.
//
// The cut (kernels/refine.scene_cut_plain is the flat form it equals):
//   eligible  the slots of own rows not covered by the hot top-up;
//   qualifying  a key >= 0 (no NaN): key bits with the sign clear order as
//             the floats do, -0.0 taken as +0.0;
//   output    the a best qualifying entries of the eligible slots (flat
//             index r*k + j) and the hot keys (flat index m*k + j), best
//             first; then KEY_NONE / index 0 padding. count: the qualifying
//             entries listed. max_risk: the max of decode_risk over every
//             occupied slot (key > KEY_NONE), halo mirrors and covered rows
//             included, and 0.
//
// Design. Exactness under ties comes from unique composite keys: a row
// ranks by (its best qualifying key, lower row first), an entry by (key,
// lower flat index first), both packed into one 64-bit word. Let T be the
// a-th largest row composite, t its key. The rows at or above T hold, with
// the hot keys, every entry of the top a: an entry of any other row is
// beaten by the a chosen rows' bests (each a greater key, or an equal key at
// a lower flat index, since the row index orders the flat index), and an
// entry with a key below t by the same a bests. So:
//   1. rows: one pass over the [m, k] keys, 16 bytes a load where k % 4 is
//      0: each row's best qualifying key (written as one word a row),
//      max_risk, and a shared-memory histogram of the row composite's top
//      11 bits (a warp adds equal digits once, __match_any_sync).
//   2. row threshold: radix selection of T, 11 bits a pass over the
//      rows' words, each pass only the rows whose higher digits match the
//      threshold so far. The last block of a pass (a ticket after a
//      __threadfence) scans the histogram and fixes the next digit, so the
//      host never waits and the launch count is fixed by the shape; a pass
//      whose threshold is already fixed returns at once.
//   3. collect: the qualifying entries >= t of the rows at or above T, and
//      the hot keys >= t, into a pool of at most a*k + P composites.
//   4. final, one block: radix selection of the pool's a-th composite in
//      shared memory, the entries above it compacted and sorted by a bitonic
//      network (in shared memory up to SORT_CAP entries, in the workspace
//      beyond), and written out with the keys as they were.
// When m*k + P <= SINGLE_MAX, one block of FINAL_THREADS runs the four
// steps in one launch (shards, small fleets). On an H100 the one block took
// 0.018-0.035 ms of device time up to 2^15 entries at a = 1,024, the
// launches 0.029-0.050, and 4-25 us less of the host a call; at 2^16 the
// launches were ahead (0.043 against 0.048 ms), at 2^17 by 1.6x.
// A cut of nothing (a = 0) runs step 1 for max_risk and the final block,
// which writes count 0.
// tc_scene_cut_plan gives the launches and the workspace; chip_smoke.py
// holds the launches to the kernels of a call captured in a CUDA graph.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int DIGIT = 11;                 // bits of one selection pass
constexpr int BINS = 1 << DIGIT;
constexpr int PASSES_MAX = 6;             // composites have at most 62 bits
constexpr int THREADS = 256;              // a block of the row kernels
constexpr int GRID_MAX = 1056;            // blocks of the row kernels
constexpr int FINAL_THREADS = 1024;       // the final and single kernels
constexpr int SORT_CAP = 4096;            // entries sorted in shared memory
constexpr long long SINGLE_MAX = 1 << 15; // m*k + P cut by one block (above)
constexpr unsigned NONE = 0xffffffffu;    // a row without a qualifying key
constexpr unsigned KEY_TOP = 0x7f800000u; // +inf: the largest qualifying bits
constexpr float KEY_NONE = -3.0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t ALIGN = 256;

using u64 = unsigned long long;

// shape of one cut: rows composite (b << L) | (2^L - 1 - r) on W = 31 + L
// bits, pool composite (u << L2) | (2^L2 - 1 - flat) on W2 = 31 + L2 bits
struct Geo {
  int m, k, p, a;
  int L, W, passes;
  int L2, W2, passes2;
  long long mk;
  unsigned pool_cap;  // a*k + P, and no more than m*k + P
};

struct Sel {
  u64 thresh;      // the digits fixed so far, lower bits 0
  unsigned need;   // entries still to take inside the matching group
  int resolved;    // 1: every entry >= thresh is taken, and no more
};

// the multi-launch path's state, zeroed before the first kernel
struct Head {
  Sel sel;
  unsigned max_risk;  // bits of a float >= 0
  unsigned pool_n;
  unsigned ticket[PASSES_MAX];
  unsigned hist[PASSES_MAX][BINS];
};

struct ScanSmem {
  unsigned hist[BINS];
  unsigned warp[32];
  float wmax[32];
  Sel sel;
  unsigned counter;
  int last;
};

constexpr size_t aligned(size_t b) { return (b + ALIGN - 1) / ALIGN * ALIGN; }

int bit_length(long long x) {
  int n = 0;
  while (x > 0) {
    ++n;
    x >>= 1;
  }
  return n;
}

long long pow2_at_least(long long x) {
  long long n = 1;
  while (n < x) n <<= 1;
  return n;
}

__host__ __device__ inline int digit_hi(int W, int d) { return W - DIGIT * d; }
__host__ __device__ inline int digit_lo(int W, int d) {
  const int lo = W - DIGIT * (d + 1);
  return lo > 0 ? lo : 0;
}

__device__ __forceinline__ unsigned canon(float key) {
  const unsigned u = __float_as_uint(key);
  return u == 0x80000000u ? 0u : u;
}

__device__ __forceinline__ bool qualifies(unsigned u) { return u <= KEY_TOP; }

__device__ __forceinline__ u64 row_comp(unsigned b, long long r, int L) {
  return (static_cast<u64>(b) << L) |
         (((1ull << L) - 1) - static_cast<u64>(r));
}

__device__ __forceinline__ u64 pool_comp(unsigned u, long long flat, int L2) {
  return (static_cast<u64>(u) << L2) |
         (((1ull << L2) - 1) - static_cast<u64>(flat));
}

__device__ __forceinline__ bool in_group(u64 c, u64 thresh, int hi) {
  return (c >> hi) == (thresh >> hi);
}

__device__ __forceinline__ unsigned digit_of(u64 c, int lo, int hi) {
  return static_cast<unsigned>(c >> lo) & ((1u << (hi - lo)) - 1u);
}

// One histogram count per distinct digit of the warp's active lanes. Every
// lane of the warp calls it.
__device__ __forceinline__ void count_digit(unsigned* hist, bool active,
                                            unsigned digit) {
  const unsigned act = __ballot_sync(FULL, active);
  if (active) {
    const unsigned peers = __match_any_sync(act, digit);
    if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
  }
}

// Appends the active lanes' values at out[atomicAdd(n, ...)], inside
// out[0 .. cap). Every lane of the warp calls it.
__device__ __forceinline__ void append(u64* out, unsigned* n, unsigned cap,
                                       bool active, u64 v) {
  const unsigned act = __ballot_sync(FULL, active);
  if (act == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(act) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(n, static_cast<unsigned>(__popc(act)));
  base = __shfl_sync(FULL, base, leader);
  const unsigned at = base + __popc(act & ((1u << lane) - 1u));
  if (active && at < cap) out[at] = v;
}

// Exclusive prefix sum of v over the block in thread order; `total` gets
// the sum. Every thread calls it.
__device__ unsigned block_scan(unsigned v, unsigned* warp_tot,
                               unsigned& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    unsigned t = lane < nw ? warp_tot[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  total = warp_tot[nw - 1];
  const unsigned excl = (w ? warp_tot[w - 1] : 0u) + x - v;
  __syncthreads();
  return excl;
}

// The block's max of v (>= 0), in thread 0.
__device__ float block_max(float v, float* wmax) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) wmax[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < nw ? wmax[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  }
  __syncthreads();
  return v;
}

// Fixes the digit at bits [lo, lo + log2(bins)) of s.sel from the group's
// histogram hist(b): the bin, counted from the top, that holds the need-th
// entry. The first pass starts from need0; a group no larger than that is
// taken whole (threshold 0). Every thread calls it.
template <typename Hist>
__device__ void pick(Hist hist, int bins, int lo, bool first, unsigned need0,
                     ScanSmem& s) {
  const unsigned need = first ? need0 : s.sel.need;
  const int chunk = (bins + static_cast<int>(blockDim.x) - 1) / blockDim.x;
  const int top = bins - 1 - static_cast<int>(threadIdx.x) * chunk;
  unsigned local = 0;
  for (int c = 0; c < chunk && top - c >= 0; ++c) local += hist(top - c);
  unsigned total;
  const unsigned excl = block_scan(local, s.warp, total);
  if (first && total <= need) {
    if (threadIdx.x == 0) {
      s.sel.thresh = 0;
      s.sel.need = total;
      s.sel.resolved = 1;
    }
  } else if (excl < need && need <= excl + local) {
    unsigned cum = excl;
    for (int c = 0; c < chunk && top - c >= 0; ++c) {
      const unsigned h = hist(top - c);
      if (cum + h >= need) {
        s.sel.need = need - cum;
        s.sel.resolved = h == need - cum;
        s.sel.thresh |= static_cast<u64>(top - c) << lo;
        break;
      }
      cum += h;
    }
  }
  __syncthreads();
}

// Step 1 over rows base + threadIdx.x, base = r0, r0 + stride, ...
template <bool VEC>
__device__ void rows_phase(const float* __restrict__ keys,
                           const uint8_t* __restrict__ own,
                           const uint8_t* __restrict__ covered, const Geo& g,
                           unsigned* __restrict__ best, unsigned* hist,
                           long long r0, long long stride, float& mr) {
  const int hi = digit_hi(g.W, 0), lo = digit_lo(g.W, 0);
  for (long long base = r0; base < g.m; base += stride) {
    const long long r = base + threadIdx.x;
    bool act = false;
    unsigned dig = 0;
    if (r < g.m) {
      unsigned b = 0;
      bool any = false;
      auto take = [&](float key) {
        if (key > KEY_NONE) mr = fmaxf(mr, key - 2.0f * floorf(key * 0.5f));
        const unsigned u = canon(key);
        if (qualifies(u)) {
          b = u > b ? u : b;
          any = true;
        }
      };
      const float* row = keys + r * g.k;
      if (VEC) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        for (int j = 0; j < g.k / 4; ++j) {
          const float4 v = __ldg(row4 + j);
          take(v.x);
          take(v.y);
          take(v.z);
          take(v.w);
        }
      } else {
        for (int j = 0; j < g.k; ++j) take(__ldg(row + j));
      }
      const bool elig = own[r] != 0 && covered[r] == 0;
      const unsigned out = elig && any ? b : NONE;
      best[r] = out;
      if (out != NONE) {
        act = true;
        dig = digit_of(row_comp(out, r, g.L), lo, hi);
      }
    }
    count_digit(hist, act, dig);
  }
}

// Step 2, pass d >= 1: the digit d histogram of the rows in sel's group,
// four rows a thread and load (best is 16-byte aligned; it is written
// earlier in the single kernel, so no read-only loads).
__device__ void rows_pass(const unsigned* best, const Geo& g,
                          int d, u64 thresh, unsigned* hist, long long q0,
                          long long stride) {
  const int hi = digit_hi(g.W, d), lo = digit_lo(g.W, d);
  const long long quads = (g.m + 3) / 4;
  for (long long base = q0; base < quads; base += stride) {
    const long long q = base + threadIdx.x;
    uint4 b = make_uint4(NONE, NONE, NONE, NONE);
    if (4 * q + 3 < g.m) {
      b = *reinterpret_cast<const uint4*>(best + 4 * q);
    } else if (q < quads) {
      b.x = best[4 * q];
      if (4 * q + 1 < g.m) b.y = best[4 * q + 1];
      if (4 * q + 2 < g.m) b.z = best[4 * q + 2];
    }
    const unsigned bs[4] = {b.x, b.y, b.z, b.w};
    for (int i = 0; i < 4; ++i) {
      bool act = false;
      unsigned dig = 0;
      if (bs[i] != NONE) {
        const u64 c = row_comp(bs[i], 4 * q + i, g.L);
        act = in_group(c, thresh, hi);
        dig = digit_of(c, lo, hi);
      }
      count_digit(hist, act, dig);
    }
  }
}

// Step 3: the chosen rows' qualifying entries >= t and the hot keys >= t
// into pool[*pool_n ...].
__device__ void collect(const float* __restrict__ keys,
                        const float* __restrict__ hkey,
                        const unsigned* best, const Geo& g,
                        u64 T, u64* pool, unsigned* pool_n, long long i0,
                        long long stride) {
  const unsigned tb = static_cast<unsigned>(T >> g.L);
  for (long long base = i0; base < g.m; base += stride) {
    const long long r = base + threadIdx.x;
    bool chosen = false;
    if (r < g.m) {
      const unsigned b = best[r];
      chosen = b != NONE && row_comp(b, r, g.L) >= T;
    }
    if (!__any_sync(FULL, chosen)) continue;
    for (int j = 0; j < g.k; ++j) {
      bool act = false;
      u64 c = 0;
      if (chosen) {
        const long long flat = r * g.k + j;
        const unsigned u = canon(keys[flat]);
        if (qualifies(u) && u >= tb) {
          act = true;
          c = pool_comp(u, flat, g.L2);
        }
      }
      append(pool, pool_n, g.pool_cap, act, c);
    }
  }
  for (long long base = i0; base < g.p; base += stride) {
    const long long j = base + threadIdx.x;
    bool act = false;
    u64 c = 0;
    if (j < g.p) {
      const unsigned u = canon(hkey[j]);
      if (qualifies(u) && u >= tb) {
        act = true;
        c = pool_comp(u, g.mk + j, g.L2);
      }
    }
    append(pool, pool_n, g.pool_cap, act, c);
  }
}

// Sorts v[0 .. n) descending, n a power of two, with the block.
__device__ void bitonic_desc(u64* v, unsigned n) {
  for (unsigned size = 2; size <= n; size <<= 1) {
    for (unsigned stride = size >> 1; stride > 0; stride >>= 1) {
      for (unsigned i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const unsigned lo = 2 * i - (i & (stride - 1));
        const unsigned hi = lo + stride;
        const u64 x = v[lo], y = v[hi];
        if ((lo & size) == 0 ? x < y : x > y) {
          v[lo] = y;
          v[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Step 4, one block: the a best of pool[0 .. q) in order, written out.
__device__ void final_cut(const float* __restrict__ keys,
                          const float* __restrict__ hkey, const Geo& g,
                          const u64* pool, unsigned q, u64* gbuf, u64* sbuf,
                          ScanSmem& s, float* top_key, long long* top_i,
                          int* count) {
  const unsigned a = static_cast<unsigned>(g.a);
  if (q > g.pool_cap) q = g.pool_cap;
  if (threadIdx.x == 0) {
    s.sel.thresh = 0;
    s.sel.need = a;
    s.sel.resolved = 0;
  }
  __syncthreads();
  for (int d = 0; d < g.passes2 && !s.sel.resolved; ++d) {
    const int hi = digit_hi(g.W2, d), lo = digit_lo(g.W2, d);
    const int bins = 1 << (hi - lo);
    for (int b = threadIdx.x; b < bins; b += blockDim.x) s.hist[b] = 0;
    __syncthreads();
    const u64 thresh = s.sel.thresh;
    for (unsigned base = 0; base < q; base += blockDim.x) {
      const unsigned i = base + threadIdx.x;
      bool act = false;
      unsigned dig = 0;
      if (i < q) {
        const u64 c = pool[i];
        act = in_group(c, thresh, hi);
        dig = digit_of(c, lo, hi);
      }
      count_digit(s.hist, act, dig);
    }
    __syncthreads();
    pick([&](int b) { return s.hist[b]; }, bins, lo, d == 0, a, s);
  }
  const unsigned cnt = q < a ? q : a;
  unsigned n = 1;
  while (n < cnt) n <<= 1;
  u64* buf = n <= SORT_CAP ? sbuf : gbuf;
  const u64 thresh = s.sel.thresh;
  if (threadIdx.x == 0) s.counter = 0;
  __syncthreads();
  for (unsigned base = 0; base < q; base += blockDim.x) {
    const unsigned i = base + threadIdx.x;
    const u64 c = i < q ? pool[i] : 0;
    append(buf, &s.counter, n, i < q && c >= thresh, c);
  }
  for (unsigned i = cnt + threadIdx.x; i < n; i += blockDim.x) buf[i] = 0;
  __syncthreads();
  bitonic_desc(buf, n);
  const u64 mask2 = (1ull << g.L2) - 1;
  for (unsigned i = threadIdx.x; i < a; i += blockDim.x) {
    if (i < cnt) {
      const long long flat = static_cast<long long>(mask2 - (buf[i] & mask2));
      top_i[i] = flat;
      top_key[i] = flat < g.mk ? keys[flat] : hkey[flat - g.mk];
    } else {
      top_i[i] = 0;
      top_key[i] = KEY_NONE;
    }
  }
  if (threadIdx.x == 0) *count = static_cast<int>(cnt);
}

// true in the block whose ticket is the grid's last, after every block's
// writes before the call
__device__ bool last_block(unsigned* ticket, ScanSmem& s) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return s.last;
}

// The last block fixes the next digit from the grid's histogram of pass d.
__device__ void grid_pick(Head* h, const Geo& g, int d, ScanSmem& s) {
  if (!last_block(&h->ticket[d], s)) return;
  if (threadIdx.x == 0) {
    s.sel.thresh = __ldcg(&h->sel.thresh);
    s.sel.need = __ldcg(&h->sel.need);
    s.sel.resolved = 0;
  }
  __syncthreads();
  const int hi = digit_hi(g.W, d), lo = digit_lo(g.W, d);
  const unsigned* hist = h->hist[d];
  pick([&](int b) { return __ldcg(hist + b); }, 1 << (hi - lo), lo, d == 0,
       static_cast<unsigned>(g.a), s);
  if (threadIdx.x == 0) h->sel = s.sel;
}

__device__ void flush_hist(const ScanSmem& s, unsigned* out, int bins) {
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x)
    if (s.hist[b]) atomicAdd(&out[b], s.hist[b]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    scene_cut_rows(const float* __restrict__ keys,
                   const uint8_t* __restrict__ own,
                   const uint8_t* __restrict__ covered, Geo g, Head* h,
                   unsigned* __restrict__ best) {
  __shared__ ScanSmem s;
  for (int b = threadIdx.x; b < BINS; b += blockDim.x) s.hist[b] = 0;
  __syncthreads();
  float mr = 0.0f;
  rows_phase<VEC>(keys, own, covered, g, best, s.hist,
                  static_cast<long long>(blockIdx.x) * blockDim.x,
                  static_cast<long long>(gridDim.x) * blockDim.x, mr);
  mr = block_max(mr, s.wmax);
  if (threadIdx.x == 0 && mr > 0.0f) atomicMax(&h->max_risk, __float_as_uint(mr));
  flush_hist(s, h->hist[0], BINS);
  if (g.a > 0) grid_pick(h, g, 0, s);
}

__global__ void __launch_bounds__(THREADS)
    scene_cut_pass(const unsigned* __restrict__ best, Geo g, int d, Head* h) {
  __shared__ ScanSmem s;
  if (h->sel.resolved) return;
  const u64 thresh = h->sel.thresh;
  const int bins = 1 << (digit_hi(g.W, d) - digit_lo(g.W, d));
  for (int b = threadIdx.x; b < bins; b += blockDim.x) s.hist[b] = 0;
  __syncthreads();
  rows_pass(best, g, d, thresh, s.hist,
            static_cast<long long>(blockIdx.x) * blockDim.x,
            static_cast<long long>(gridDim.x) * blockDim.x);
  flush_hist(s, h->hist[d], bins);
  grid_pick(h, g, d, s);
}

__global__ void __launch_bounds__(THREADS)
    scene_cut_collect(const float* __restrict__ keys,
                      const float* __restrict__ hkey,
                      const unsigned* __restrict__ best, Geo g, Head* h,
                      u64* pool) {
  collect(keys, hkey, best, g, h->sel.thresh, pool, &h->pool_n,
          static_cast<long long>(blockIdx.x) * blockDim.x,
          static_cast<long long>(gridDim.x) * blockDim.x);
}

__global__ void __launch_bounds__(FINAL_THREADS)
    scene_cut_final(const float* __restrict__ keys,
                    const float* __restrict__ hkey, Geo g, const Head* h,
                    const u64* pool, u64* gbuf, float* top_key,
                    long long* top_i, int* count, float* max_risk) {
  __shared__ ScanSmem s;
  __shared__ u64 sbuf[SORT_CAP];
  if (g.a > 0)
    final_cut(keys, hkey, g, pool, h->pool_n, gbuf, sbuf, s, top_key, top_i,
              count);
  else if (threadIdx.x == 0)
    *count = 0;
  if (threadIdx.x == 0) *max_risk = __uint_as_float(h->max_risk);
}

template <bool VEC>
__global__ void __launch_bounds__(FINAL_THREADS)
    scene_cut_single(const float* __restrict__ keys,
                     const uint8_t* __restrict__ own,
                     const uint8_t* __restrict__ covered,
                     const float* __restrict__ hkey, Geo g,
                     unsigned* best, u64* pool, u64* gbuf, float* top_key,
                     long long* top_i, int* count, float* max_risk) {
  __shared__ ScanSmem s;
  __shared__ u64 sbuf[SORT_CAP];
  for (int b = threadIdx.x; b < BINS; b += blockDim.x) s.hist[b] = 0;
  if (threadIdx.x == 0) {
    s.sel.thresh = 0;
    s.sel.need = 0;
    s.sel.resolved = 0;
    s.counter = 0;
  }
  __syncthreads();
  float mr = 0.0f;
  rows_phase<VEC>(keys, own, covered, g, best, s.hist, 0, blockDim.x, mr);
  mr = block_max(mr, s.wmax);
  if (threadIdx.x == 0) *max_risk = mr;
  pick([&](int b) { return s.hist[b]; }, BINS, digit_lo(g.W, 0), true,
       static_cast<unsigned>(g.a), s);
  for (int d = 1; d < g.passes && !s.sel.resolved; ++d) {
    const int hi = digit_hi(g.W, d), lo = digit_lo(g.W, d);
    const int bins = 1 << (hi - lo);
    for (int b = threadIdx.x; b < bins; b += blockDim.x) s.hist[b] = 0;
    __syncthreads();
    rows_pass(best, g, d, s.sel.thresh, s.hist, 0, blockDim.x);
    __syncthreads();
    pick([&](int b) { return s.hist[b]; }, bins, lo, false, 0u, s);
  }
  collect(keys, hkey, best, g, s.sel.thresh, pool, &s.counter, 0,
          blockDim.x);
  __syncthreads();
  const unsigned q = s.counter;
  __syncthreads();
  final_cut(keys, hkey, g, pool, q, gbuf, sbuf, s, top_key, top_i, count);
}

// blocks of a row kernel over n items, a grid-stride loop beyond GRID_MAX
int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 1 ? 1 : blocks < GRID_MAX ? blocks : GRID_MAX);
}

struct Plan {
  Geo g;
  bool single;
  int grid, launches;
  long long pool_cap, gbuf_n;
  size_t off_best, off_pool, off_gbuf, bytes;
};

bool make_plan(int m, int k, int p, int a, Plan& pl) {
  const long long mk = static_cast<long long>(m) * k;
  if (m < 0 || k < 1 || p < 0 || mk + p >= (1ll << 31) || a < 0 ||
      a > mk + p)
    return false;
  Geo& g = pl.g;
  g.m = m;
  g.k = k;
  g.p = p;
  g.a = a;
  g.mk = mk;
  g.L = bit_length(m - 1ll);
  g.W = 31 + g.L;
  g.passes = (g.W + DIGIT - 1) / DIGIT;
  g.L2 = bit_length(mk + p - 1);
  g.W2 = 31 + g.L2;
  g.passes2 = (g.W2 + DIGIT - 1) / DIGIT;
  pl.single = a > 0 && mk + p <= SINGLE_MAX;
  pl.grid = grid_for(m);
  pl.launches = pl.single ? 1 : a == 0 ? 2 : g.passes + 2;
  const long long cap = static_cast<long long>(a) * k + p;
  pl.pool_cap = a == 0 ? 0 : cap < mk + p ? cap : mk + p;
  g.pool_cap = static_cast<unsigned>(pl.pool_cap);
  const long long n = pow2_at_least(a);
  pl.gbuf_n = n > SORT_CAP ? n : 0;
  pl.off_best = aligned(sizeof(Head));
  pl.off_pool = pl.off_best + aligned(4 * static_cast<size_t>(m));
  pl.off_gbuf = pl.off_pool + aligned(8 * static_cast<size_t>(pl.pool_cap));
  pl.bytes = pl.off_gbuf + aligned(8 * static_cast<size_t>(pl.gbuf_n));
  return true;
}

}  // namespace

extern "C" {

// The plan of a cut of m rows of k slots, p hot keys and a outputs:
// out[0] workspace bytes, out[1] kernel launches, out[2] 1 for the single
// block, out[3] row selection passes, out[4] blocks of the row kernels
// (-1 everywhere: not a valid shape).
void tc_scene_cut_plan(int m, int k, int p, int a, long long* out) {
  Plan pl;
  if (!make_plan(m, k, p, a, pl)) {
    for (int i = 0; i < 5; ++i) out[i] = -1;
    return;
  }
  out[0] = static_cast<long long>(pl.bytes);
  out[1] = pl.launches;
  out[2] = pl.single;
  out[3] = pl.g.passes;
  out[4] = pl.grid;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// keys [m, k] f32, own / covered [m] bool, hkey [p] f32; ws: ws_bytes of
// device scratch (tc_scene_cut_plan's out[0]), 256-byte aligned; outputs
// top_key [a] f32, top_i [a] i64, count [] i32, max_risk [] f32.
int tc_scene_cut(const void* keys, const void* own, const void* covered,
                 int m, int k, const void* hkey, int p, int a, void* ws,
                 long long ws_bytes, void* top_key, void* top_i, void* count,
                 void* max_risk, void* stream) {
  Plan pl;
  if (!make_plan(m, k, p, a, pl) || ws_bytes < static_cast<long long>(pl.bytes) ||
      reinterpret_cast<uintptr_t>(ws) % ALIGN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(ws);
  Head* h = reinterpret_cast<Head*>(base);
  unsigned* best = reinterpret_cast<unsigned*>(base + pl.off_best);
  u64* pool = reinterpret_cast<u64*>(base + pl.off_pool);
  u64* gbuf = reinterpret_cast<u64*>(base + pl.off_gbuf);
  const float* kf = static_cast<const float*>(keys);
  const uint8_t* ob = static_cast<const uint8_t*>(own);
  const uint8_t* cb = static_cast<const uint8_t*>(covered);
  const float* hf = static_cast<const float*>(hkey);
  float* tk = static_cast<float*>(top_key);
  long long* ti = static_cast<long long*>(top_i);
  int* cnt = static_cast<int*>(count);
  float* mr = static_cast<float*>(max_risk);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  if (pl.single) {
    if (vec)
      scene_cut_single<true><<<1, FINAL_THREADS, 0, st>>>(
          kf, ob, cb, hf, pl.g, best, pool, gbuf, tk, ti, cnt, mr);
    else
      scene_cut_single<false><<<1, FINAL_THREADS, 0, st>>>(
          kf, ob, cb, hf, pl.g, best, pool, gbuf, tk, ti, cnt, mr);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(h, 0, sizeof(Head), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec)
    scene_cut_rows<true><<<pl.grid, THREADS, 0, st>>>(kf, ob, cb, pl.g, h,
                                                      best);
  else
    scene_cut_rows<false><<<pl.grid, THREADS, 0, st>>>(kf, ob, cb, pl.g, h,
                                                       best);
  if (a > 0) {
    for (int d = 1; d < pl.g.passes; ++d)
      scene_cut_pass<<<grid_for((m + 3) / 4), THREADS, 0, st>>>(best, pl.g,
                                                                 d, h);
    scene_cut_collect<<<grid_for(m > p ? m : p), THREADS, 0, st>>>(
        kf, hf, best, pl.g, h, pool);
  }
  scene_cut_final<<<1, FINAL_THREADS, 0, st>>>(kf, hf, pl.g, h, pool, gbuf,
                                               tk, ti, cnt, mr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
