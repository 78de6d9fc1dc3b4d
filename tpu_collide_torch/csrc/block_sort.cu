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
// (e & j == 0) swap when they are strictly out of order for the direction of
// e, ascending where bit k of e is 0. The permutation then depends on the
// keys and the network alone, not on how the stages are grouped into passes,
// so this kernel gives the Pallas kernel's output bit for bit, tie order
// included.
//
// Design. The TPU kept all operands in VMEM with 128-lane rolls. Here only
// (key, position) pairs move through the network, and every payload operand
// is written once at the end, by the permutation:
//   * tile kernel: one block sorts a tile of TILE pairs in shared memory
//     (32 KB): the whole prefix k <= TILE on the first pass, which also reads
//     the key and pads it, and for k > TILE the stages j < TILE of that
//     merge; __syncthreads() between stages;
//   * global kernel: one stage with j >= TILE, one thread per pair;
//   * gather kernel: the sorted keys and every payload, one launch.
// What bounds it on this card: the payload gather reads and writes each
// operand once (1M elements x 14 operands x 4 B x 2 = 112 MB, ~33 us at
// 3.35 TB/s); the network itself moves its 8 B pairs through device memory
// once per global stage and twice per tile pass (at 1M: 36 global stages and
// 9 tile passes, ~45 passes of 8 MB each way), so fusing the global stages
// is the next step. Compare-exchanges are integer compares and moves, far
// from any arithmetic limit.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;           // pairs per shared-memory tile
constexpr int TILE_THREADS = 1024;   // two compare-exchanges per stage each
constexpr int THREADS = 256;         // global stage and gather kernels
constexpr int MAX_PAYLOADS = 32;

struct Payloads {
  const uint32_t* src[MAX_PAYLOADS];
  uint32_t* dst[MAX_PAYLOADS];
};

// compare-exchange c of a stage: the pair (e, e + j) with e & j == 0
__device__ __forceinline__ int lower_of(int c, int j) {
  return ((c & ~(j - 1)) << 1) | (c & (j - 1));
}

__device__ __forceinline__ void tile_stage(int* sk, int* sp, int half,
                                           unsigned base, int j, int k) {
  for (int c = threadIdx.x; c < half; c += blockDim.x) {
    const int e = lower_of(c, j);
    const int p = e + j;
    const bool asc = ((base + e) & static_cast<unsigned>(k)) == 0;
    const int a = sk[e], b = sk[p];
    if (asc ? a > b : a < b) {
      sk[e] = b;
      sk[p] = a;
      const int t = sp[e];
      sp[e] = sp[p];
      sp[p] = t;
    }
  }
}

// k_merge == 0: load the keys (pads past n), run every stage with k <= tile.
// k_merge > 0: load the pairs, run the stages j = tile/2..1 of merge k_merge.
__global__ void __launch_bounds__(TILE_THREADS)
bitonic_tile_kernel(const int* __restrict__ key_in, int n, int* keys,
                    int* pos, int tile, int k_merge) {
  __shared__ int sk[TILE];
  __shared__ int sp[TILE];
  const unsigned base = blockIdx.x * static_cast<unsigned>(tile);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const unsigned g = base + i;
    if (k_merge == 0) {
      sk[i] = g < static_cast<unsigned>(n) ? key_in[g] : INT_MAX;
      sp[i] = static_cast<int>(g);
    } else {
      sk[i] = keys[g];
      sp[i] = pos[g];
    }
  }
  __syncthreads();
  const int half = tile >> 1;
  if (k_merge == 0) {
    for (int k = 2; k <= tile; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        tile_stage(sk, sp, half, base, j, k);
        __syncthreads();
      }
    }
  } else {
    for (int j = half; j > 0; j >>= 1) {
      tile_stage(sk, sp, half, base, j, k_merge);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    keys[base + i] = sk[i];
    pos[base + i] = sp[i];
  }
}

__global__ void __launch_bounds__(THREADS)
bitonic_global_kernel(int* keys, int* pos, int half, int j, int k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= half) return;
  const int e = lower_of(c, j);
  const int p = e + j;
  const bool asc = (e & k) == 0;
  const int a = keys[e], b = keys[p];
  if (asc ? a > b : a < b) {
    keys[e] = b;
    keys[p] = a;
    const int t = pos[e];
    pos[e] = pos[p];
    pos[p] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
cosort_gather_kernel(const int* __restrict__ keys,
                     const int* __restrict__ pos, int n, int n_pay,
                     Payloads pl, int* __restrict__ key_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  key_out[i] = keys[i];
  const int p = pos[i];
  const bool real = p < n;
  for (int f = 0; f < n_pay; ++f) pl.dst[f][i] = real ? pl.src[f][p] : 0u;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first non-zero cudaGetLastError()
// (0 on success). key_in [n] i32; src / dst: host arrays of n_pay device
// pointers to [n] 4-byte payloads and their outputs; key_out [n] i32; keys /
// pos: [npad] i32 scratch, npad a power of two with 2 <= npad <= 2^30 and
// npad >= n.
int tc_co_sort(const void* key_in, int n, int npad, int n_pay,
               const void* const* src, void* const* dst, void* key_out,
               void* keys, void* pos, void* stream) {
  if (n <= 0) return 0;
  if (npad < 2 || npad > (1 << 30) || (npad & (npad - 1)) != 0 || npad < n ||
      n_pay < 0 || n_pay > MAX_PAYLOADS)
    return static_cast<int>(cudaErrorInvalidValue);
  Payloads pl;
  for (int f = 0; f < n_pay; ++f) {
    pl.src[f] = static_cast<const uint32_t*>(src[f]);
    pl.dst[f] = static_cast<uint32_t*>(dst[f]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ki = static_cast<const int*>(key_in);
  auto* kk = static_cast<int*>(keys);
  auto* pp = static_cast<int*>(pos);
  const int tile = npad < TILE ? npad : TILE;
  const int tile_threads = tile / 2 < TILE_THREADS ? tile / 2 : TILE_THREADS;
  const int tiles = npad / tile;
  const int half = npad / 2;
  bitonic_tile_kernel<<<tiles, tile_threads, 0, s>>>(ki, n, kk, pp, tile, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long kl = 2LL * tile; kl <= npad; kl <<= 1) {
    const int k = static_cast<int>(kl);
    for (int j = k >> 1; j >= tile; j >>= 1) {
      bitonic_global_kernel<<<(half + THREADS - 1) / THREADS, THREADS, 0,
                              s>>>(kk, pp, half, j, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    bitonic_tile_kernel<<<tiles, tile_threads, 0, s>>>(ki, n, kk, pp, tile,
                                                       k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cosort_gather_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      kk, pp, n, n_pay, pl, static_cast<int*>(key_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
