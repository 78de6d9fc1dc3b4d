// Bitonic co-sort for Hopper (sm_90a): every operand sorted by an int32 key.
//
// Replaces the Pallas kernel of the staged bitonic co-sort,
// .probe/block_sort.py:158 `_block_kernel` (launched per pass by
// `_one_block_pass`, :205, from `co_sort`, :273), together with its
// cross-block stages, which ran there as XLA passes (`_xla_stage`, :230).
//
// The network is the standard one over the operands padded to the next power
// of two npad (pad key INT32_MAX, pad payload 0): for merge size k = 2..npad
// and exchange distance j = k/2..1, the element e and its partner e + j
// (e & j == 0) swap when they are strictly out of order ON THE KEY ALONE for
// the direction of e, ascending where bit k of e is 0. The permutation then
// depends on the keys and the network alone, not on how the stages are
// grouped into passes, so this kernel gives the Pallas kernel's output bit
// for bit, tie order included. (Comparing key and position together would
// make the sort stable, which the network is not.)
//
// Design. The TPU kept all operands in VMEM with 128-lane rolls. Here only
// (key, position) pairs move through the network, packed in one 8-byte word
// in device and shared memory; the payloads are gathered once, by the pass
// that finishes the sort. What bounds the function on this card is bytes
// (every operand read and written once, 112 MB at 1M x 14, ~33 us); what
// bounded the first port was neither bytes nor operations but 46 dependent
// launches at 1M, each with one compare per pair, and a block barrier after
// every stage of a tile. So:
//
//   * A thread keeps E = 16 pairs in registers. A stage whose partner lies
//     in the same thread is register moves, one whose partner lies in the
//     same warp is two __shfl_xor_sync per pair, and only a change of layout
//     goes through shared memory and a __syncthreads(). A tile of
//     TILE = 4096 pairs (256 threads) has two layouts:
//       low   thread t holds slots 16 t .. 16 t + 15: slot bits 0-3 in
//             registers, 4-8 across the lanes: stages j = 1..256 without
//             shared memory;
//       high  thread t holds slots t + 256 m: slot bits 8-11 in registers:
//             stages j = 256..2048.
//     The whole prefix k <= TILE takes 8 barriers (78 before).
//   * A descending part of a merge runs as an ascending one on complemented
//     keys (flip): a compare-exchange is then one comparison and four
//     selects, whatever its direction.
//   * The shared-memory tile is XOR-swizzled (swz) so that the 16-byte
//     accesses of the low layout and the 8-byte accesses of the others are
//     free of bank conflicts.
//   * strided kernel: ALL stages j >= TILE of one merge k = 2^L in one
//     launch (two where L - 12 > 8). A block holds the TILE pairs whose
//     indices run over hb stage bits [lo_bit, lo_bit + hb) and over the
//     12 - hb lowest bits, i.e. runs of at least 16 consecutive pairs
//     (128 bytes); slot s of block b is the global index
//         (b >> mid) << (lo_bit + hb) | (s >> run) << lo_bit
//                                     | (b & (2^mid - 1)) << run
//                                     | s & (2^run - 1),
//     run = 12 - hb, mid = lo_bit - run
//     (kernels/block_sort.py strided_tile_index, tested on the CPU). The top
//     four stage bits are register bits of the high layout; further ones
//     take one pass through shared memory into a layout whose registers are
//     slot bits run..run+3. The direction of a pair is bit L of its GLOBAL
//     index, which is constant over a block.
//   * tile kernel: the prefix (FIRST), or the stages j < TILE of a merge;
//     the one that ends the sort (LAST) writes the sorted keys and gathers
//     every payload itself, coalesced on the side it writes.
// At 1M that is 1 + 8 x 2 = 17 launches and no separate gather.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB = 12;               // log2 of the pairs per tile
constexpr int EB = 4;                // log2 of the pairs per thread
constexpr int TILE = 1 << TB;
constexpr int E = 1 << EB;
constexpr int THREADS = TILE / E;
constexpr int HB = TB - EB;          // lowest slot bit of the high layout
// stage bits one strided launch takes: runs stay >= 16 pairs, and the bits
// below the high layout's fit the registers of one more layout
constexpr int HB_MAX = (TB - 4 < 2 * EB) ? TB - 4 : 2 * EB;
constexpr int MAX_PAYLOADS = 32;
constexpr unsigned FULL = 0xffffffffu;

static_assert(EB >= 4, "the swizzle keeps 16-slot groups together");
static_assert(HB >= 5, "a block is whole warps");
static_assert(HB <= EB + 5, "the low layout reaches every bit below HB");

struct Payloads {
  const uint32_t* src[MAX_PAYLOADS];
  uint32_t* dst[MAX_PAYLOADS];
};

// shared-memory position of a slot: bits 1-3 XOR the low three lane bits of
// the low layout
__device__ __forceinline__ int swz(int slot) {
  return slot ^ (((slot >> EB) & 7) << 1);
}

// the slot of register m of thread t where the registers are slot bits
// p..p+EB-1 (p = HB: the high layout, also the order of coalesced access)
__device__ __forceinline__ int reg_slot(int t, int m, int p) {
  return ((t >> p) << (p + EB)) | (m << p) | (t & ((1 << p) - 1));
}

// Descending parts of a merge run as ascending ones on complemented keys:
// ~a > ~b exactly where a < b, ties included, and a pair never leaves the
// 2^L-aligned part whose direction it has. flip() complements the keys of
// the elements g0 + r * GS whose bit k is set; a pass applies it when it
// takes a merge up and again when it lays it down, so that every stage in
// between is one comparison.
template <unsigned GS>
__device__ __forceinline__ void flip(int (&K)[E], unsigned g0, unsigned k) {
#pragma unroll
  for (int r = 0; r < E; ++r)
    if ((g0 + r * GS) & k) K[r] = ~K[r];
}

// One stage along register bit RB: the pair (r, r | 1 << RB) swaps when
// strictly out of order on the key.
template <int RB>
__device__ __forceinline__ void reg_stage(int (&K)[E], int (&P)[E]) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (r & (1 << RB)) continue;
    const int q = r | (1 << RB);
    const int a = K[r], b = K[q];
    if (a > b) {
      K[r] = b;
      K[q] = a;
      const int t = P[r];
      P[r] = P[q];
      P[q] = t;
    }
  }
}

// The stages along the register bits RB..0 whose slot bit off + RB lies in
// [lo, hi), highest first.
template <int RB>
struct RegStages {
  static __device__ __forceinline__ void run(int (&K)[E], int (&P)[E],
                                             int off, int lo, int hi) {
    if (off + RB >= lo && off + RB < hi) reg_stage<RB>(K, P);
    RegStages<RB - 1>::run(K, P, off, lo, hi);
  }
};
template <>
struct RegStages<-1> {
  static __device__ __forceinline__ void run(int (&)[E], int (&)[E], int,
                                             int, int) {}
};

// One stage between the lanes lane and lane ^ mask (low layout: the pairs of
// register r of both lanes). The lower lane takes the other's pair where
// its own key is greater, the upper lane where its own is less, so both
// make the same decision.
__device__ __forceinline__ void lane_stage(int (&K)[E], int (&P)[E],
                                           int mask) {
  const int upper = (threadIdx.x & mask) ? -1 : 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int ok = __shfl_xor_sync(FULL, K[r], mask);
    const int op = __shfl_xor_sync(FULL, P[r], mask);
    if ((K[r] ^ upper) > (ok ^ upper)) {
      K[r] = ok;
      P[r] = op;
    }
  }
}

// low layout: the stages along slot bits nbits-1..0 (nbits <= EB + 5)
__device__ __forceinline__ void low_stages(int (&K)[E], int (&P)[E],
                                           int nbits) {
#pragma unroll
  for (int b = EB + 4; b >= EB; --b)
    if (b < nbits) lane_stage(K, P, 1 << (b - EB));
  RegStages<EB - 1>::run(K, P, 0, 0, nbits);
}

__device__ __forceinline__ void store_low(int2* sm, int t, const int (&K)[E],
                                          const int (&P)[E]) {
#pragma unroll
  for (int c = 0; c < E / 2; ++c)
    *reinterpret_cast<int4*>(&sm[swz(t * E + 2 * c)]) =
        make_int4(K[2 * c], P[2 * c], K[2 * c + 1], P[2 * c + 1]);
}

__device__ __forceinline__ void load_low(const int2* sm, int t, int (&K)[E],
                                         int (&P)[E]) {
#pragma unroll
  for (int c = 0; c < E / 2; ++c) {
    const int4 v = *reinterpret_cast<const int4*>(&sm[swz(t * E + 2 * c)]);
    K[2 * c] = v.x;
    P[2 * c] = v.y;
    K[2 * c + 1] = v.z;
    P[2 * c + 1] = v.w;
  }
}

__device__ __forceinline__ void store_regs(int2* sm, int t, int p,
                                           const int (&K)[E],
                                           const int (&P)[E]) {
#pragma unroll
  for (int m = 0; m < E; ++m)
    sm[swz(reg_slot(t, m, p))] = make_int2(K[m], P[m]);
}

__device__ __forceinline__ void load_regs(const int2* sm, int t, int p,
                                          int (&K)[E], int (&P)[E]) {
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int2 v = sm[swz(reg_slot(t, m, p))];
    K[m] = v.x;
    P[m] = v.y;
  }
}

// FIRST: reads the keys (pads past n), pairs them with their positions and
// runs every stage with k <= TILE. Otherwise: reads the pairs and runs the
// stages j = TILE/2..1 of the merge k_merge. LAST: writes the sorted keys
// and gathers the payloads; otherwise writes the pairs.
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(THREADS)
cosort_tile_kernel(const int* __restrict__ key_in, int n, int2* pairs,
                   unsigned k_merge, int n_pay, Payloads pl,
                   int* __restrict__ key_out) {
  extern __shared__ int4 smem4[];
  int2* sm = reinterpret_cast<int2*>(smem4);
  const int t = threadIdx.x;
  const unsigned base = blockIdx.x * static_cast<unsigned>(TILE);
  const unsigned g_low = base + t * E;   // register 0 of the low layout
  const unsigned g_high = base + t;      // register 0 of the high layout
  int K[E], P[E];
  if (FIRST) {
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int slot = reg_slot(t, m, HB);
      const unsigned g = base + slot;
      sm[swz(slot)] = make_int2(
          g < static_cast<unsigned>(n) ? key_in[g] : INT_MAX,
          static_cast<int>(g));
    }
    __syncthreads();
    load_low(sm, t, K, P);
    for (int L = 1; L <= TB; ++L) {
      const unsigned k = 1u << L;
      flip<1>(K, g_low, k);
      if (L > EB + 5) {
        store_low(sm, t, K, P);
        __syncthreads();
        load_regs(sm, t, HB, K, P);
        RegStages<EB - 1>::run(K, P, HB, HB, L);
        store_regs(sm, t, HB, K, P);
        __syncthreads();
        load_low(sm, t, K, P);
        low_stages(K, P, HB);
      } else {
        low_stages(K, P, L);
      }
      flip<1>(K, g_low, k);
    }
  } else {
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int2 v = pairs[base + reg_slot(t, m, HB)];
      K[m] = v.x;
      P[m] = v.y;
    }
    flip<0>(K, base, k_merge);     // one direction over the tile
    RegStages<EB - 1>::run(K, P, HB, HB, TB);
    store_regs(sm, t, HB, K, P);
    __syncthreads();
    load_low(sm, t, K, P);
    low_stages(K, P, HB);
    flip<0>(K, base, k_merge);
  }
  store_low(sm, t, K, P);
  __syncthreads();
  load_regs(sm, t, HB, K, P);    // consecutive lanes, consecutive indices
  if (!LAST) {
#pragma unroll
    for (int m = 0; m < E; ++m)
      pairs[g_high + m * THREADS] = make_int2(K[m], P[m]);
    return;
  }
  bool live[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    live[m] = g_high + m * THREADS < static_cast<unsigned>(n);
    if (live[m]) key_out[g_high + m * THREADS] = K[m];
  }
  // E independent loads of a payload in flight, then its E stores. A pad
  // that ties with a real INT32_MAX key may sort before it: it carries the
  // pad payload 0, as in the plain version.
  for (int f = 0; f < n_pay; ++f) {
    const uint32_t* __restrict__ src = pl.src[f];
    uint32_t* __restrict__ dst = pl.dst[f];
    uint32_t v[E];
#pragma unroll
    for (int m = 0; m < E; ++m)
      v[m] = live[m] && P[m] < n ? src[P[m]] : 0u;
#pragma unroll
    for (int m = 0; m < E; ++m)
      if (live[m]) dst[g_high + m * THREADS] = v[m];
  }
}

// The stages along index bits lo_bit + hb - 1 .. lo_bit (all >= TB) of the
// merge k, on the strided tile described at the top of the file.
__global__ void __launch_bounds__(THREADS)
cosort_strided_kernel(int2* pairs, int lo_bit, int hb, unsigned k) {
  extern __shared__ int4 smem4[];
  int2* sm = reinterpret_cast<int2*>(smem4);
  const int t = threadIdx.x;
  const int run = TB - hb;
  const int mid = lo_bit - run;
  const unsigned b = blockIdx.x;
  const unsigned fixed = ((b >> mid) << (lo_bit + hb))
                         | ((b & ((1u << mid) - 1u)) << run);
  const unsigned run_mask = (1u << run) - 1u;
  int K[E], P[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const unsigned s = reg_slot(t, m, HB);
    const int2 v = pairs[fixed | ((s >> run) << lo_bit) | (s & run_mask)];
    K[m] = v.x;
    P[m] = v.y;
  }
  // bit k lies above every stage bit: one direction for the whole block
  flip<0>(K, fixed, k);
  RegStages<EB - 1>::run(K, P, HB, run, TB);
  int p = HB;
  if (run < HB) {
    store_regs(sm, t, HB, K, P);
    __syncthreads();
    p = run;
    load_regs(sm, t, p, K, P);
    RegStages<EB - 1>::run(K, P, p, run, HB);
  }
  flip<0>(K, fixed, k);
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const unsigned s = reg_slot(t, m, p);
    pairs[fixed | ((s >> run) << lo_bit) | (s & run_mask)] =
        make_int2(K[m], P[m]);
  }
}

struct Launcher {
  cudaStream_t stream;
  bool dry;          // count the launches, launch nothing
  int count = 0;
  cudaError_t err = cudaSuccess;

  template <typename Kernel, typename... Args>
  void operator()(Kernel kernel, int blocks, Args... args) {
    ++count;
    if (dry || err != cudaSuccess) return;
    kernel<<<blocks, THREADS, TILE * sizeof(int2), stream>>>(args...);
    err = cudaGetLastError();
  }
};

// The launches of one sort over npad elements, in order.
void co_sort_launches(Launcher& go, const int* key_in, int n, int npad,
                      int n_pay, const Payloads& pl, int* key_out,
                      int2* pairs) {
  // a short input is one tile padded to TILE: the network over the longer
  // padding leaves the first npad elements as the network over npad does
  const int tiles = npad <= TILE ? 1 : npad / TILE;
  if (tiles == 1) {
    go(cosort_tile_kernel<true, true>, 1, key_in, n, pairs, 0u, n_pay, pl,
       key_out);
    return;
  }
  go(cosort_tile_kernel<true, false>, tiles, key_in, n, pairs, 0u, n_pay, pl,
     key_out);
  for (int L = TB + 1; (1LL << L) <= npad; ++L) {
    const unsigned k = 1u << L;
    for (int hi = L; hi > TB;) {
      const int hb = hi - TB < HB_MAX ? hi - TB : HB_MAX;
      hi -= hb;
      go(cosort_strided_kernel, tiles, pairs, hi, hb, k);
    }
    if ((1LL << L) == npad)
      go(cosort_tile_kernel<false, true>, tiles, key_in, n, pairs, k, n_pay,
         pl, key_out);
    else
      go(cosort_tile_kernel<false, false>, tiles, key_in, n, pairs, k, n_pay,
         pl, key_out);
  }
}

bool valid_pad(int npad) {
  return npad >= 2 && npad <= (1 << 30) && (npad & (npad - 1)) == 0;
}

}  // namespace

extern "C" {

// The number of kernel launches tc_co_sort makes for npad (-1: not a valid
// padded length).
int tc_co_sort_launches(int npad) {
  if (!valid_pad(npad)) return -1;
  Launcher go{nullptr, true};
  co_sort_launches(go, nullptr, 0, npad, 0, Payloads{}, nullptr, nullptr);
  return go.count;
}

// Launches on `stream` and returns the first non-zero cudaGetLastError()
// (0 on success). key_in [n] i32; src / dst: host arrays of n_pay device
// pointers to [n] 4-byte payloads and their outputs; key_out [n] i32; keys /
// pos: the two halves of ONE [2 * npad] i32 scratch buffer (pos == keys +
// npad, 8-byte aligned), which holds the npad (key, position) pairs; npad a
// power of two with 2 <= npad <= 2^30 and npad >= n.
int tc_co_sort(const void* key_in, int n, int npad, int n_pay,
               const void* const* src, void* const* dst, void* key_out,
               void* keys, void* pos, void* stream) {
  if (n <= 0) return 0;
  if (!valid_pad(npad) || npad < n || n_pay < 0 || n_pay > MAX_PAYLOADS ||
      static_cast<int*>(pos) != static_cast<int*>(keys) + npad ||
      reinterpret_cast<uintptr_t>(keys) % sizeof(int2) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Payloads pl{};
  for (int f = 0; f < n_pay; ++f) {
    pl.src[f] = static_cast<const uint32_t*>(src[f]);
    pl.dst[f] = static_cast<uint32_t*>(dst[f]);
  }
  if (TILE * sizeof(int2) > 48 * 1024) {
    const int bytes = TILE * sizeof(int2);
    cudaFuncSetAttribute(cosort_tile_kernel<true, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaFuncSetAttribute(cosort_tile_kernel<true, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaFuncSetAttribute(cosort_tile_kernel<false, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaFuncSetAttribute(cosort_tile_kernel<false, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaFuncSetAttribute(cosort_strided_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  Launcher go{static_cast<cudaStream_t>(stream), false};
  co_sort_launches(go, static_cast<const int*>(key_in), n, npad, n_pay, pl,
                   static_cast<int*>(key_out), static_cast<int2*>(keys));
  return static_cast<int>(go.err);
}

}  // extern "C"
