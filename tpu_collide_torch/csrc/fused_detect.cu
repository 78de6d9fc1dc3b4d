// Fused broad + narrow phase for Hopper (sm_90a): each object's top-k pair
// slots, in the two detection modes of the fused step.
//
// Replaces the TPU kernel tpu_collide/kernels/fused_detect.py::_kernel,
// launched there by fused_topk in modes "hits" (fast) and "survivors"
// (precise). It computes what that kernel computes; the TPU layout (128-lane
// storage rows, tiles, candidate windows, packed slot keys) is not carried
// over.
//
// What bounds it on the card: instruction throughput and the latency of
// dependent steps, not device memory (the bytes of a 100k fleet take 0.004
// ms). A thread per object, the first design, ran stage 2 for every
// candidate that any of a warp's 32 objects passed, with a seventh to a
// third of the lanes live; walked a crowded cell's thousands of candidates
// one after another; and kept its slots, indexed at run time, in local
// memory.
//
// Design:
//   1. Lanes across candidates. A group of G lanes (2 to 32) walks one own
//      object's 3 (2D) or 9 (3D) runs as ONE concatenated list, UNROLL
//      candidates a lane and round, straight from the records (16 of a
//      record's 64 bytes; the L1 holds what neighbouring groups read again).
//      G is chosen per launch from the fleet's size: the fewest lanes with
//      which the fleet still fills GRID_MIN blocks. Few lanes share a round's
//      instructions among the many objects of a warp, which wins on a large
//      fleet; a small fleet, or one crowd in one cell, needs many lanes per
//      object to spread over the card and to shorten the walk of a long list.
//   2. Stage 2 on full groups. The lanes that pass stage 1 append their
//      candidate to the group's ring in shared memory (__ballot_sync and a
//      prefix count). When a group's ring has no room for another round, and
//      at the end, every group runs stage 2 on its waiting pairs, one per
//      lane.
//   3. Stages 3-4 on full warps (mode "hits"). A pair in twenty passes stage
//      2, so the survivors of all groups go on into one ring per warp, as
//      (own object, candidate); when 32 wait, and at the end, the warp runs
//      stages 3-4 on them, one per lane.
//   4. Slots in shared memory, k <= 32 per own object. A survivor (mode
//      "survivors") goes by __shfl_sync to its group's first lane, a hit
//      that beats its object's last slot to the warp's first lane, which
//      inserts it. The slots are the k largest under a total order (key
//      descending, candidate index ascending) in which every candidate
//      occurs once, so the visiting order does not matter; emitted, qual and
//      checked are counts. The block writes its slots out as one contiguous
//      piece of keys and idx.
// A block first fills a table of its own objects' runs (two reads of
// cell_start each) and copies their records into shared memory; after that
// one barrier its warps work alone. checked is summed per warp and added
// once per warp into a 64-bit total. Tried and not kept (PERF.md section 6
// has the times): a block's ranges brought into shared memory first, whole
// records in three 16-byte planes (no gain where cells are crowded, a loss
// where they are sparse: at 1M objects in 3D the ranges of a block are 11
// records per own object and the copies alone take the old kernel's whole
// time); a lane per object with one ring per warp.
// ptxas: 64 registers (the launch bound, 4 blocks of 256 threads an SM); 16
// bytes of stack and 20-24 bytes of spill in the hits kernels, none in the
// survivors kernels; 9 to 31 KB of static shared memory by width, the
// block's slots beside it.
//
// Arithmetic follows the kernel's order (fused_detect.py:651-784) and the
// plain PyTorch version in tpu_collide_torch/kernels/fused_detect.py; built
// with -fmad=false and without fast math, the two agree bit for bit.

#include <mutex>
#include <set>
#include <utility>

#include "fused_common.cuh"

namespace {

using tc::K_MAX;
using tc::KEY_NONE;
using tc::KEY_SUB;
using tc::N_PARAMS;
using tc::Params;
using tc::Shape;

constexpr int WARPS = 8;      // warps of a block
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 4;  // blocks an SM must hold: 64 registers a thread
constexpr int MAX_RUNS = 9;   // stencil rows: 3 in 2D, 9 in 3D
constexpr int UNROLL = 4;     // candidates a lane tests per round
// a warp's rings of stage-1 candidates, one per group of lanes: a group of
// G lanes holds up to UNROLL * G waiting and as many new
constexpr int RINGS = 2 * UNROLL * 32;
constexpr int TAIL = 64;      // a warp's ring of stage-2 pairs (mode "hits")
// Lanes per own object: the fewest of WIDTH_MIN .. 32 with which the fleet
// fills GRID_MIN blocks. Few lanes share a round's instructions among the many
// objects of a warp; a small fleet needs more lanes per object to spread
// over the card.
constexpr int WIDTH_MIN = 2, GRID_MIN = 1056;
constexpr unsigned FULL = 0xffffffffu;

// lanes per own object for a fleet of n objects
int width_for(int n) {
  int width = WIDTH_MIN;
  while (width < 32 && static_cast<long long>(n) * width < GRID_MIN * THREADS)
    width *= 2;
  return width;
}

// own objects of a block with `width` lanes per object
constexpr int span_of(int width) { return THREADS / width; }

// the dynamic shared memory of a launch: the block's slots
constexpr int slot_bytes(int width, int k) { return span_of(width) * k * 8; }

// What pair_key computes of a pair that passed stage 1.
enum Part {
  SURVIVOR,  // stage 2 and the survivor's key (mode "survivors")
  FILTER,    // stage 2 alone: does the pair go on to stages 3-4?
  HIT        // stages 2-4 and the hit's key (mode "hits")
};

// true when the pair passes (FILTER) or is emitted (SURVIVOR, HIT), then
// with its slot key and whether it qualifies. own, c: the own object's and
// the candidate's records (the candidate's fourth quarter is read only
// where the angle term needs it). PRODUCT: the angle term from the records'
// sines and cosines (DetectionConfig.angle_form == "product"), else sinf of
// the heading difference: a compile-time choice so that sinf's
// large-argument path and its stack frame stay out of the product form.
template <Part PART, bool PRODUCT>
__device__ __forceinline__ bool pair_key(const float4* __restrict__ own,
                                         const float4* __restrict__ c,
                                         const Shape& sh, const Params& p,
                                         float& key, bool& qual) {
  const float4 o0 = own[0], o1 = own[1], o2 = own[2];
  const float4 c0 = c[0], c1 = c[1], c2 = c[2];
  const float dxp = c0.x - o0.x, dyp = c0.y - o0.y;
  float d2 = dxp * dxp + dyp * dyp;
  float dzp = 0.0f;
  if (sh.is3d) {
    dzp = c0.z - o0.z;
    d2 = d2 + dzp * dzp;
  }

  // stage 2: closest approach under constant acceleration
  const float dvx = c0.w - o0.w, dvy = c1.x - o1.x;
  float rs2 = dvx * dvx + dvy * dvy;
  float dot = dxp * dvx + dyp * dvy;
  float dvz = 0.0f;
  if (sh.is3d) {
    dvz = c1.y - o1.y;
    rs2 = rs2 + dvz * dvz;
    dot = dot + dzp * dvz;
  }
  const float rs2s = rs2 > 1e-12f ? rs2 : 1.0f;
  const float ts = -(p.conv * dot) / rs2s;
  const float dax = c1.z - o1.z, day = c1.w - o1.w;
  const float cdx = dxp + dvx * ts + 0.5f * dax * ts * ts;
  const float cdy = dyp + dvy * ts + 0.5f * day * ts * ts;
  float cd2 = cdx * cdx + cdy * cdy;
  if (sh.is3d) {
    const float daz = c2.x - o2.x;
    const float cdz = dzp + dvz * ts + 0.5f * daz * ts * ts;
    cd2 = cd2 + cdz * cdz;
  }
  const float safe = (o2.y + c2.y) * 0.5f + p.safe_base;
  const float safe2 = safe * safe;
  if (!((rs2 >= p.min_rs2) && (ts >= 0.0f) && (ts <= p.time_window) &&
        (cd2 <= safe2)))
    return false;
  if (PART == FILTER) return true;

  if (PART == HIT) {
    // stage 3 (fast): first crossing of |p + v t| = safe, snapped up to the
    // dt lattice
    const float bq = 2.0f * dot;
    const float cq = d2 - safe2;
    const float disc = bq * bq - 4.0f * rs2 * cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t_en = (-bq - sq) / (2.0f * rs2s);
    const float t_ex = (-bq + sq) / (2.0f * rs2s);
    const bool inside = cq <= 0.0f;
    const float t_fi = inside ? 0.0f : fmaxf(t_en, 0.0f);
    const float t_sn = ceilf(t_fi / p.dt - 1e-6f) * p.dt;
    const bool sok =
        inside || ((t_sn >= t_en - 1e-6f) && (t_sn <= t_ex + 1e-6f));
    if (!((disc >= 0.0f) && (rs2 > 1e-12f) && sok && (t_sn <= p.t_max)))
      return false;
    const float t_hit = inside ? 0.0f : t_sn;
    const float hdx = dxp + dvx * t_hit;
    const float hdy = dyp + dvy * t_hit;
    float hd2 = hdx * hdx + hdy * hdy;
    if (sh.is3d) {
      const float hdz = dzp + dvz * t_hit;
      hd2 = hd2 + hdz * hdz;
    }
    const float d_hit = sqrtf(hd2);

    // stage 4: weighted risk
    const float ohead = o2.z, chead = c2.z;
    float angle;
    if (PRODUCT) {
      const float4 o3 = own[3];
      const float4 c3 = c[3];
      const float sd = o3.x * c3.y - o3.y * c3.x;
      angle = ohead >= chead ? sd : -sd;
    } else {
      angle = sinf(fabsf(ohead - chead));
    }
    float risk =
        p.w_dist * (1.0f - d_hit / safe) +
        p.w_time * (1.0f - fminf(t_hit / p.max_warning_time, 1.0f)) +
        p.w_speed * fminf(sqrtf(rs2) / p.max_relative_speed, 1.0f) +
        p.w_angle * angle +
        p.w_type * (c2.w == o2.w ? p.same_type : p.diff_type);
    risk = fminf(fmaxf(risk, 0.0f), 1.0f);

    // priority and the scene ranking key
    const bool crit = (risk >= p.risk_high) && (t_hit < p.ttc_critical);
    const bool high = (risk >= p.risk_high) || (t_hit < p.ttc_high);
    const bool med = risk >= p.risk_medium;
    const float prio = crit ? 3.0f : (high ? 2.0f : (med ? 1.0f : 0.0f));
    qual = risk >= p.risk_low;
    key = qual ? 2.0f * prio + risk : risk + KEY_SUB;
  } else {
    // stage-2 survivor, ranked by closest-approach proximity
    qual = true;
    key = 1.0f - cd2 / safe2;
  }
  return true;
}

// HITS: mode "hits", else "survivors". G: lanes per own object.
template <bool HITS, bool PRODUCT, int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_topk_kernel(const float4* __restrict__ rec,
                  const int* __restrict__ cell,
                  const int* __restrict__ cell_start, Shape sh, Params p,
                  float* __restrict__ keys, int* __restrict__ idx,
                  int* __restrict__ emitted_out, int* __restrict__ qual_out,
                  unsigned long long* __restrict__ checked) {
  constexpr int GROUPS = 32 / G;          // own objects of a warp
  constexpr int SPAN = THREADS / G;       // own objects of a block
  constexpr int RING = 2 * UNROLL * G;    // a group's ring
  constexpr unsigned GMASK = G == 32 ? FULL : (1u << (G & 31)) - 1u;

  extern __shared__ float s_dyn[];        // the block's slots: keys, then idx
  __shared__ float4 s_own[SPAN][4];       // the own objects' records
  __shared__ int s_ring[WARPS][RINGS];    // candidates past stage 1
  __shared__ int2 s_tail[HITS ? WARPS : 1][TAIL];  // (own, candidate) past 2
  // each own object's runs: first candidate (sorted index) and end
  __shared__ int s_run_at[SPAN][MAX_RUNS], s_run_end[SPAN][MAX_RUNS];
  __shared__ int s_emit[SPAN], s_qual[SPAN];

  float* s_key = s_dyn;
  int* s_idx = reinterpret_cast<int*>(s_dyn + SPAN * sh.k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / G, gl = lane % G, gbase = g * G;
  const unsigned below = ((1u << gl) - 1u) << gbase;  // the group's lower lanes
  const unsigned mine = GMASK << gbase;               // the group's lanes
  const unsigned before = (1u << lane) - 1u;          // the warp's lower lanes
  const int runs = sh.is3d ? 9 : 3;
  const int num_cells = sh.nx * sh.ny * sh.nz;
  const int i0 = blockIdx.x * SPAN;
  const int i1 = min(i0 + SPAN, sh.n);

  // the block's own records, its slots empty, and every own object's runs
  // (dz outer, dy inner; empty outside the grid and for a dead object, whose
  // cell is num_cells: dead objects sort last and keep their empty slots)
  for (int t = tid; t < 4 * (i1 - i0); t += THREADS)
    s_own[0][t] = rec[4 * static_cast<size_t>(i0) + t];
  for (int t = tid; t < SPAN * sh.k; t += THREADS) {
    s_key[t] = KEY_NONE;
    s_idx[t] = -1;
  }
  if (tid < SPAN) {
    s_emit[tid] = 0;
    s_qual[tid] = 0;
  }
  for (int t = tid; t < SPAN * runs; t += THREADS) {
    const int at = t / runs, r = t - at * runs;
    const int c = i0 + at < i1 ? cell[i0 + at] : num_cells;
    int first = 0, end = 0;
    if (c < num_cells) {
      const int cx = c % sh.nx;
      const int y = (c / sh.nx) % sh.ny + r % 3 - 1;
      const int z = c / (sh.nx * sh.ny) + (sh.is3d ? r / 3 - 1 : 0);
      if (y >= 0 && y < sh.ny && z >= 0 && z < sh.nz) {
        const int base = (z * sh.ny + y) * sh.nx;
        first = cell_start[base + max(cx - 1, 0)];
        end = cell_start[base + min(cx + 1, sh.nx - 1) + 1];
      }
    }
    s_run_at[at][r] = first;
    s_run_end[at][r] = end;
  }
  __syncthreads();

  // From here to the last barrier a warp works alone on its GROUPS own
  // objects, G lanes each; every branch that holds a warp-wide primitive is
  // taken by the whole warp.
  const int me = warp * GROUPS + g;  // the group's own object in the block
  const int i = i0 + me;
  const float4 o0 = s_own[me][0];
  const int* run_at = s_run_at[me];
  const int* run_end = s_run_end[me];
  int* ring = s_ring[warp] + g * RING;
  int2* tail = s_tail[HITS ? warp : 0];
  float* skey = s_key + me * sh.k;
  int* sidx = s_idx + me * sh.k;
  unsigned n_checked = 0;

  // the lane strides through the object's runs, concatenated, G candidates
  // at a time: run r, candidate pos, the run's end lim
  int r = 0, pos = run_at[0] + gl, lim = run_end[0];
  auto settle = [&]() {  // past the run's end: on into the next runs
    while (pos >= lim) {
      const int over = pos - lim;
      if (++r >= runs) return;
      pos = run_at[r] + over;
      lim = run_end[r];
    }
  };
  settle();

  int head = 0, waiting = 0;    // the ring holds [head, head + waiting)
  int thead = 0, twaiting = 0;  // and the warp's tail ring
  int n_emit = 0;

  // Stages 2-4 of the tail ring's first m (<= 32) pairs, one per lane, then
  // the hits into their objects' counts and slots. The slots are the k
  // largest of a total order, so only hits that beat their object's last slot
  // are inserted, one after another by the first lane.
  auto finish = [&](int m) {
    const bool active = lane < m;
    int2 e = make_int2(0, i0);
    if (active) e = tail[(thead + lane) & (TAIL - 1)];
    __syncwarp();  // the entries are read before any is overwritten
    thead = (thead + m) & (TAIL - 1);
    twaiting -= m;
    float key = 0.0f;
    bool qual = false, ranks = false;
    if (active &&
        pair_key<HIT, PRODUCT>(s_own[e.x], rec + 4 * static_cast<size_t>(e.y),
                               sh, p, key, qual)) {
      atomicAdd(&s_emit[e.x], 1);
      if (qual) atomicAdd(&s_qual[e.x], 1);
      const float last = s_key[e.x * sh.k + sh.k - 1];
      ranks = key > last ||
              (key == last && e.y < s_idx[e.x * sh.k + sh.k - 1]);
    }
    unsigned todo = __ballot_sync(FULL, ranks);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int at = __shfl_sync(FULL, e.x, src);
      const float ks = __shfl_sync(FULL, key, src);
      const int js = __shfl_sync(FULL, e.y, src);
      if (lane == 0)
        tc::insert_slot(s_key + at * sh.k, s_idx + at * sh.k, sh.k, ks, js);
    }
    __syncwarp();
  };

  // Stage 2 of each group's first min(waiting, G) pairs, one per lane.
  // Survivors go into the group's slots (mode "survivors") or on into the
  // warp's tail ring (mode "hits").
  auto sweep = [&]() {
    const int m = min(waiting, G);
    const bool active = gl < m;
    int j = i0;
    if (active) j = ring[(head + gl) & (RING - 1)];
    __syncwarp();  // the ring's entries are read before any is overwritten
    head = (head + m) & (RING - 1);
    waiting -= m;
    float key = 0.0f;
    bool qual = false, pass = false;
    if (active)
      pass = pair_key<HITS ? FILTER : SURVIVOR, PRODUCT>(
          s_own[me], rec + 4 * static_cast<size_t>(j), sh, p, key, qual);
    if (HITS) {
      const unsigned passed = __ballot_sync(FULL, pass);
      if (pass)
        tail[(thead + twaiting + __popc(passed & before)) & (TAIL - 1)] =
            make_int2(me, j);
      twaiting += __popc(passed);
      __syncwarp();
      if (twaiting >= 32) finish(32);
    } else {
      unsigned hits = __ballot_sync(FULL, pass) & mine;
      n_emit += __popc(hits);
      while (__any_sync(FULL, hits != 0)) {
        const int src = hits ? __ffs(hits) - 1 : lane;
        const float ks = __shfl_sync(FULL, key, src);
        const int js = __shfl_sync(FULL, j, src);
        if (hits != 0 && gl == 0) tc::insert_slot(skey, sidx, sh.k, ks, js);
        hits &= hits - 1;
      }
    }
  };

  while (__any_sync(FULL, r < runs)) {
    // the lane's next UNROLL candidates (-1: none)
    int cj[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      cj[u] = r < runs ? pos : -1;
      if (r < runs) {
        pos += G;
        settle();
      }
    }
    // stage 1: within search radius, not self (pair identity = sorted index)
    bool pass[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float4 c0 = rec[4 * static_cast<size_t>(max(cj[u], 0))];
      const float dxp = c0.x - o0.x, dyp = c0.y - o0.y;
      float d2 = dxp * dxp + dyp * dyp;
      if (sh.is3d) {
        const float dzp = c0.z - o0.z;
        d2 = d2 + dzp * dzp;
      }
      pass[u] = cj[u] >= 0 && cj[u] != i && d2 <= p.r2;
    }
    unsigned passed[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) passed[u] = __ballot_sync(FULL, pass[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (pass[u]) {
        const int slot = head + waiting + __popc(passed[u] & below);
        ring[slot & (RING - 1)] = cj[u];
        ++n_checked;
      }
      waiting += __popc(passed[u] & mine);
    }
    __syncwarp();
    // room for the next round's candidates
    while (__any_sync(FULL, waiting > RING - UNROLL * G)) sweep();
  }
  while (__any_sync(FULL, waiting > 0)) sweep();
  if (HITS) {
    if (twaiting > 0) finish(twaiting);
  } else if (gl == 0) {
    s_emit[me] = n_emit;
    s_qual[me] = n_emit;
  }
  __syncthreads();

  // ---- the block's slots and counts, one contiguous piece each ----
  const size_t out0 = static_cast<size_t>(i0) * sh.k;
  for (int t = tid; t < (i1 - i0) * sh.k; t += THREADS) {
    keys[out0 + t] = s_key[t];
    idx[out0 + t] = s_idx[t];
  }
  if (tid < i1 - i0) {
    emitted_out[i0 + tid] = s_emit[tid];
    qual_out[i0 + tid] = s_qual[tid];
  }
  if (sh.count_checked) {
    // every thread of the block reaches here, so the full mask is exact
    const unsigned int w = __reduce_add_sync(FULL, n_checked);
    if (lane == 0 && w != 0)
      atomicAdd(checked, static_cast<unsigned long long>(w));
  }
}

using Kernel = void (*)(const float4*, const int*, const int*, Shape, Params,
                        float*, int*, int*, int*, unsigned long long*);

template <bool HITS, bool PRODUCT>
Kernel kernel_of(int width) {
  return width == 2    ? fused_topk_kernel<HITS, PRODUCT, 2>
         : width == 4  ? fused_topk_kernel<HITS, PRODUCT, 4>
         : width == 8  ? fused_topk_kernel<HITS, PRODUCT, 8>
         : width == 16 ? fused_topk_kernel<HITS, PRODUCT, 16>
                       : fused_topk_kernel<HITS, PRODUCT, 32>;
}

// The kernel of a mode and width. Once per kernel and device it is given as
// much of the SM's memory as shared memory as its resident blocks need, and
// leave to pass 48 KB a block (its static arrays and a block's slots can).
Kernel kernel_of(int hits, int product, int width) {
  Kernel kernel = !hits     ? kernel_of<false, false>(width)
                  : product ? kernel_of<true, true>(width)
                            : kernel_of<true, false>(width);
  static std::mutex lock;
  static std::set<std::pair<int, Kernel>> ready;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> guard(lock);
  if (ready.insert({device, kernel}).second) {
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         slot_bytes(width, K_MAX));
  }
  return kernel;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// fields [n, 16] f32, cell [n] i32, cell_start [nx*ny*nz + 1] i32,
// params: N_PARAMS f32 on the host; outputs keys [n, k] f32, idx [n, k] i32,
// emitted [n] i32, qual [n] i32, checked [] i64 (zeroed by the caller; left
// alone when count_checked is 0).
int tc_fused_topk(const void* fields, const void* cell,
                  const void* cell_start, int n, int nx, int ny, int nz,
                  int is3d, int k, int hits, int count_checked,
                  int angle_product, const void* params, void* keys,
                  void* idx, void* emitted, void* qual, void* checked,
                  void* stream) {
  if (k < 1 || k > K_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  Params p;
  const float* pf = static_cast<const float*>(params);
  float* dst = reinterpret_cast<float*>(&p);
  for (int t = 0; t < N_PARAMS; ++t) dst[t] = pf[t];
  const Shape sh{n, nx, ny, nz, is3d, k, count_checked, angle_product};
  const int width = width_for(n);
  const int span = span_of(width);
  const Kernel kernel = kernel_of(hits, angle_product, width);
  kernel<<<(n + span - 1) / span, THREADS, slot_bytes(width, k),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(fields), static_cast<const int*>(cell),
      static_cast<const int*>(cell_start), sh, p, static_cast<float*>(keys),
      static_cast<int*>(idx), static_cast<int*>(emitted),
      static_cast<int*>(qual), static_cast<unsigned long long*>(checked));
  return static_cast<int>(cudaGetLastError());
}

// The plan tc_fused_topk launches n objects with k slots with: out[0 .. 4) =
// lanes per own object, blocks, threads a block, dynamic shared memory in
// bytes; out[4] = the blocks of the hits kernel an SM holds at once.
void tc_fused_topk_plan(int n, int k, int* out) {
  const int width = width_for(n);
  const int span = span_of(width);
  out[0] = width;
  out[1] = (n + span - 1) / span;
  out[2] = THREADS;
  out[3] = slot_bytes(width, k);
  out[4] = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], kernel_of(1, 1, width), THREADS, out[3]);
}

int tc_param_count() { return N_PARAMS; }

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
