// Trajectory prediction for Hopper (sm_90a): each object's top-k predicted
// pair slots at every prediction offset, in one launch.
//
// Replaces the predict mode of the TPU kernel
// tpu_collide/kernels/fused_detect.py::_kernel (the emit == "predict" branch,
// fused_detect.py:553-646), which refine.fused_predict_rows launched once per
// offset under a lax.scan. What it computes, per offset t and own object:
//   * the own object moves to its class-predicted position (stationary:
//     p; constant velocity: p + v t; accelerating: p + v t + 0.5 a t t);
//   * its candidates are the objects of the 1-cell stencil around the
//     PREDICTED position's cell, tested at their CURRENT positions
//     (|p_c - pred| <= search_radius, the reference's quirk of querying
//     today's index with tomorrow's position);
//   * each candidate advances to t under constant acceleration, and a
//     sub_steps sampled sweep finds the first sample within the safe
//     distance; a hit scores the stage-4 risk, which is the slot key.
// Slots are ordered by (key descending, candidate sorted index ascending),
// an empty slot is (KEY_NONE, -1); emitted counts every hit exactly.
//
// What bounds it on the card: instruction throughput and the latency of its
// loads through L1, not device memory. Per (offset, row) the work is a
// prologue (the predicted position, three IEEE divisions, the 3 or 9 runs'
// bounds), a walk of its stencil (stage 1: one 16-byte load and about 10
// operations a candidate), and the set-up, sweep and stage 4 of each
// candidate within the radius (about 60 operations and three gathered
// 16-byte loads, then 19-25 a sample). How these weigh depends on the
// density (device ms a call of 20 offsets on an H100 80GB HBM3 at 700 W,
// without the sweep in brackets):
//   * sparse (the 1M-3D warn fleet, 2.5 objects a cell): a row walks about
//     56 candidates in 9 runs of about 6 and keeps about 9.5. A warp per
//     row, the first design, ran each run's round with 6 of 32 lanes live,
//     its one sweep round with about 10, and paid the prologue 32 times
//     over: 36.8 ms (32.8), 45x its bound. This design: 9.2 ms (8.1), the
//     walk, the pairs' set-up and the prologue still nearly all of it.
//   * crowded (100k city skew, 20k objects in a city core): a row walks
//     thousands of candidates, every layout fills its lanes, and the sweep
//     of the many pairs within the radius takes 40%: 11.6 ms (6.8) in the
//     first design, 11.4 (7.2) in this one.
//
// Design (the layout of the detection kernel B1, fused_detect.cu, with its
// own code: B1 is left as it is):
//   1. Lanes across rows. A block owns SPAN = 256 / G consecutive sorted
//      rows of one offset (blockIdx.y), G lanes each (2 to 32, a power of
//      two). G is chosen per launch from the rows, n x n_off: the fewest
//      lanes with which the launch still fills GRID_MIN blocks, B1's rule
//      with a larger minimum. G = 32 is the first design's warp per row.
//   2. The prologue once per row. The block's first SPAN threads compute
//      each row's predicted position, its cell and its 3 or 9 run bounds
//      (two reads of cell_start each) into shared memory.
//   3. One list a row. A group walks its row's runs as ONE concatenated
//      list, UNROLL candidates a lane and round, straight from the records
//      (16 of a record's 64 bytes; neighbouring rows are neighbours in one
//      cell and walk the same runs, so the L1 serves the repeats).
//   4. Set-up, sweep and stage 4 on full warps. The stage-1 survivors of all
//      the warp's groups go into one ring per warp as (row, candidate)
//      pairs (__ballot_sync and a prefix count); whenever 32 wait, and once
//      at the end, the warp runs them one per lane. B1's second ring, a
//      group's own, is not needed: nothing runs between stage 1 and the
//      sweep.
//   5. Slots in shared memory, k <= 32 a row. A hit counts into its row's
//      emitted (a shared-memory atomic); one that beats its row's last slot
//      goes by __shfl_sync to the warp's first lane, which inserts it. The
//      slots are the k largest under a total order in which every candidate
//      occurs once, so the order of insertion does not matter. The block
//      writes its slots out as one contiguous piece.
// A distance is only ever compared with a threshold until a sample hits, so
// the comparisons run on squared distances against sqrt_le_bound
// (fused_common.cuh), which decides exactly as the square root would; only
// the hit sample takes its square root.
// Tried and not kept (device ms a call at the warn shape unless said;
// PERF.md section 6): the run table filled by all threads after the
// prologue (integer divisions by the run count and the grid's widths: 12.2
// against 11.4); __match_any_sync, or a count a run of lanes, in place of
// one atomic a hit (12.0-12.6 against 11.4; better only on a fleet crowded
// into one cell); UNROLL 2 / 8 and 3 blocks an SM (11.4, 14.0, 12.7);
// fused_detect.cu's GRID_MIN, which gives 2 lanes a row below 540k rows
// (100k city skew at 2 offsets: 1.87 against 1.17 at 8 lanes; a 20k
// city-skew fleet at 20 offsets, as Scene.predict launches it: 0.66 / 0.41
// against 0.60 / 0.30 at 4, 2D / 3D); the largest shared-memory carveout (11.4
// against 9.3); the rows' records copied into shared memory (9.34 against
// 9.24).
//
// Arithmetic follows the reference's expressions (detect/predict.py,
// detect/pipeline.py _dist_at_time / _risk_score) in their order, and the
// plain PyTorch version predict_topk_plain in kernels/fused_detect.py; built
// with -fmad=false and without fast math, the two agree bit for bit.

#include <cmath>

#include "fused_common.cuh"

namespace {

using tc::K_MAX;
using tc::KEY_NONE;
using tc::Params;
using tc::Shape;
using tc::sqrt_le_bound;

// f32 constants of the predict mode, in the order of PRED_PARAM_NAMES in
// kernels/fused_detect.py
struct PredParams {
  float lo_x, lo_y, lo_z, cell_size, radius;
};
constexpr int N_PRED_PARAMS = sizeof(PredParams) / sizeof(float);

constexpr int WARPS = 8;       // warps of a block
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 4;  // blocks an SM must hold: 64 registers a thread
constexpr int MAX_RUNS = 9;    // stencil rows: 3 in 2D, 9 in 3D
constexpr int UNROLL = 4;      // candidates a lane tests per round
// a warp's ring of (row, candidate) pairs past stage 1: fewer than 32
// waiting and up to 32 new
constexpr int TAIL = 64;
// Lanes per row: the fewest of WIDTH_MIN .. 32 with which the launch's rows
// (objects x offsets) fill GRID_MIN blocks, fused_detect.cu's rule at four
// times its minimum: eight waves of the 4 blocks each of 132 SMs holds. A
// row's predicted cell may lie in a crowd, where a narrow group walks
// thousands of candidates, and with few waves such blocks set the end.
// kernels/fused_detect.py mirrors THREADS, WIDTH_MIN and GRID_MIN as
// PRED_THREADS, PRED_WIDTH_MIN and PRED_GRID_MIN.
constexpr int WIDTH_MIN = 2, GRID_MIN = 4224;
constexpr unsigned FULL = 0xffffffffu;

// lanes per row for a launch of `rows` (offset, object) rows
int width_for(long long rows) {
  int width = WIDTH_MIN;
  while (width < 32 && rows * width < static_cast<long long>(GRID_MIN) *
                                          THREADS)
    width *= 2;
  return width;
}

// rows of a block with `width` lanes per row
constexpr int span_of(int width) { return THREADS / width; }

// the dynamic shared memory of a launch: the block's slots
constexpr int slot_bytes(int width, int k) { return span_of(width) * k * 8; }

// the kernel's static shared memory (s_pred, s_run_at, s_run_end, s_emit,
// s_tail below)
constexpr int static_bytes(int width) {
  return span_of(width) * (16 + 2 * MAX_RUNS * 4 + 4) + WARPS * TAIL * 8;
}
// A block fits the 48 KB a launch may use without leave to pass it at every
// width (2 lanes a row holds the most rows) and k
static_assert(static_bytes(WIDTH_MIN) + slot_bytes(WIDTH_MIN, K_MAX) <=
                  48 * 1024,
              "a block's shared memory passes 48 KB");

__device__ __forceinline__ int clip_cell(float f, int n) {
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

// PRODUCT: the angle term from the records' sines and cosines
// (DetectionConfig.angle_form == "product"), else sinf of the heading
// difference. A compile-time choice so that sinf's large-argument path and
// its stack frame stay out of the product form. G: lanes per row.
template <bool PRODUCT, int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_predict_kernel(const float4* __restrict__ rec,
                     const int* __restrict__ cell_start,
                     const float* __restrict__ offsets, Shape sh, Params p,
                     PredParams q, int sub_steps, float* __restrict__ keys,
                     int* __restrict__ idx, int* __restrict__ emitted_out) {
  constexpr int GROUPS = 32 / G;     // rows of a warp
  constexpr int SPAN = THREADS / G;  // rows of a block

  extern __shared__ float s_dyn[];   // the block's slots: keys, then idx
  __shared__ float4 s_pred[SPAN];    // their predicted positions
  // each row's runs: first candidate (sorted index) and end
  __shared__ int s_run_at[SPAN][MAX_RUNS], s_run_end[SPAN][MAX_RUNS];
  __shared__ int2 s_tail[WARPS][TAIL];  // (row in the block, candidate)
  __shared__ int s_emit[SPAN];

  float* s_key = s_dyn;
  int* s_idx = reinterpret_cast<int*>(s_dyn + SPAN * sh.k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / G, gl = lane % G;
  const unsigned before = (1u << lane) - 1u;  // the warp's lower lanes
  const int runs = sh.is3d ? 9 : 3;
  const int i0 = blockIdx.x * SPAN;
  const int i1 = min(i0 + SPAN, sh.n);
  const float t = offsets[blockIdx.y];
  const long long out_row0 = static_cast<long long>(blockIdx.y) * sh.n + i0;

  // the block's slots empty, and each row's prologue, by one thread a row:
  // its class-predicted position
  // (detect/predict.class_advance), that position's cell, floor((pred -
  // lo) / cell_size) clipped into the grid with an IEEE division as in the
  // cell list's build, and the runs around it. With cells sorted by (z, y,
  // x), the cells cx-1 .. cx+1 of one (dz, dy) row are one contiguous run
  // of the sorted order (dz outer, dy inner; empty outside the grid). Dead
  // objects sort last (rows from cell_start[num_cells] on) and walk
  // nothing.
  for (int u = tid; u < SPAN * sh.k; u += THREADS) {
    s_key[u] = KEY_NONE;
    s_idx[u] = -1;
  }
  if (tid < SPAN) {
    const int i = i0 + tid;
    const bool live = i < i1 && i < cell_start[sh.nx * sh.ny * sh.nz];
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    int cx = 0, cy = 0, cz = 0;
    if (live) {
      const float4 o0 = rec[4 * static_cast<size_t>(i)];
      const float4 o1 = rec[4 * static_cast<size_t>(i) + 1];
      const float4 o2 = rec[4 * static_cast<size_t>(i) + 2];
      const float ocls = rec[4 * static_cast<size_t>(i) + 3].z;
      px = o0.x;
      py = o0.y;
      pz = o0.z;
      if (ocls != 0.0f) {
        px = o0.x + o0.w * t;
        py = o0.y + o1.x * t;
        pz = o0.z + o1.y * t;
        if (ocls != 1.0f) {
          px = px + 0.5f * o1.z * t * t;
          py = py + 0.5f * o1.w * t * t;
          pz = pz + 0.5f * o2.x * t * t;
        }
      }
      cx = clip_cell(floorf((px - q.lo_x) / q.cell_size), sh.nx);
      cy = clip_cell(floorf((py - q.lo_y) / q.cell_size), sh.ny);
      cz = clip_cell(floorf((pz - q.lo_z) / q.cell_size), sh.nz);
    }
    const int x0 = max(cx - 1, 0), x1 = min(cx + 1, sh.nx - 1);
    const int dz0 = sh.is3d ? -1 : 0, dz1 = sh.is3d ? 1 : 0;
    int r = 0;
    for (int dz = dz0; dz <= dz1; ++dz) {
      for (int dy = -1; dy <= 1; ++dy, ++r) {
        const int y = cy + dy, z = cz + dz;
        int first = 0, end = 0;
        if (live && y >= 0 && y < sh.ny && z >= 0 && z < sh.nz) {
          const int base = (z * sh.ny + y) * sh.nx;
          first = cell_start[base + x0];
          end = cell_start[base + x1 + 1];
        }
        s_run_at[tid][r] = first;
        s_run_end[tid][r] = end;
      }
    }
    s_pred[tid] = make_float4(px, py, pz, 0.0f);
    s_emit[tid] = 0;
  }
  __syncthreads();

  // From here to the last barrier a warp works alone on its GROUPS rows, G
  // lanes each; every branch that holds a warp-wide primitive is taken by
  // the whole warp (the ring's counters are the same in all lanes).
  const int me = warp * GROUPS + g;  // the group's row in the block
  const int i = i0 + me;
  const float4 pr = s_pred[me];
  const float radius_sq = sqrt_le_bound(q.radius);
  const int* run_at = s_run_at[me];
  const int* run_end = s_run_end[me];
  int2* tail = s_tail[warp];

  // the lane strides through the row's runs, concatenated, G candidates at
  // a time: run r, candidate pos, the run's end lim
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

  int thead = 0, twaiting = 0;  // the ring holds [thead, thead + twaiting)

  // Set-up, sweep and stage 4 of the ring's first m (<= 32) pairs, one per
  // lane, then the hits into their rows' counts and slots. The slots are the
  // k largest of a total order, so only hits that beat their row's last slot
  // are inserted, one after another by the first lane.
  auto finish = [&](int m) {
    const bool active = lane < m;
    int2 e = make_int2(0, 0);
    if (active) e = tail[(thead + lane) & (TAIL - 1)];
    __syncwarp();  // the entries are read before any is overwritten
    thead = (thead + m) & (TAIL - 1);
    twaiting -= m;
    float risk = 0.0f;
    bool hit = false;
    if (active) {
      const float4* own = rec + 4 * static_cast<size_t>(i0 + e.x);
      const float4 o0 = own[0], o1 = own[1], o2 = own[2];
      const float4 pe = s_pred[e.x];
      const float4* c = rec + 4 * static_cast<size_t>(e.y);
      // candidate advanced to t under constant acceleration
      const float4 c0 = c[0], c1 = c[1], c2 = c[2];
      const float sx = c0.x + c0.w * t + 0.5f * c1.z * t * t - pe.x;
      const float sy = c0.y + c1.x * t + 0.5f * c1.w * t * t - pe.y;
      const float dvx = c0.w - o0.w, dvy = c1.x - o1.x;
      const float dax = c1.z - o1.z, day = c1.w - o1.w;
      float sz = 0.0f, dvz = 0.0f, daz = 0.0f;
      if (sh.is3d) {
        sz = c0.z + c1.y * t + 0.5f * c2.x * t * t - pe.z;
        dvz = c1.y - o1.y;
        daz = c2.x - o2.x;
      }
      const float safe = (o2.y + c2.y) * 0.5f + p.safe_base;
      const float safe_sq = sqrt_le_bound(safe);

      // first sample of the sub-window sweep within the safe distance
      float t_hit = 0.0f, d_hit = 0.0f;
      for (int s = 0; s < sub_steps; ++s) {
        const float ts = static_cast<float>(s) * p.dt;
        const float tt = ts * ts;
        const float ddx = sx + dvx * ts + 0.5f * dax * tt;
        const float ddy = sy + dvy * ts + 0.5f * day * tt;
        float dd2 = ddx * ddx + ddy * ddy;
        if (sh.is3d) {
          const float ddz = sz + dvz * ts + 0.5f * daz * tt;
          dd2 = dd2 + ddz * ddz;
        }
        if (dd2 <= safe_sq) {  // sqrtf(dd2) <= safe
          hit = true;
          t_hit = ts;
          d_hit = sqrtf(dd2);
          break;
        }
      }
      if (hit) {
        // stage 4: weighted risk, the slot key
        float rs2 = dvx * dvx + dvy * dvy;
        if (sh.is3d) rs2 = rs2 + dvz * dvz;
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
        risk =
            p.w_dist * (1.0f - d_hit / safe) +
            p.w_time * (1.0f - fminf(t_hit / p.max_warning_time, 1.0f)) +
            p.w_speed * fminf(sqrtf(rs2) / p.max_relative_speed, 1.0f) +
            p.w_angle * angle +
            p.w_type * (c2.w == o2.w ? p.same_type : p.diff_type);
        risk = fminf(fmaxf(risk, 0.0f), 1.0f);
      }
    }
    bool ranks = false;
    if (hit) {
      atomicAdd(&s_emit[e.x], 1);
      const float last = s_key[e.x * sh.k + sh.k - 1];
      ranks = risk > last ||
              (risk == last && e.y < s_idx[e.x * sh.k + sh.k - 1]);
    }
    unsigned todo = __ballot_sync(FULL, ranks);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int at = __shfl_sync(FULL, e.x, src);
      const float ks = __shfl_sync(FULL, risk, src);
      const int js = __shfl_sync(FULL, e.y, src);
      if (lane == 0)
        tc::insert_slot(s_key + at * sh.k, s_idx + at * sh.k, sh.k, ks, js);
    }
    __syncwarp();
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
    // stage 1: the candidate's CURRENT position within the search radius
    // of the predicted one (the reference's |p_c - pred| <= r), not self
    // (pair identity = sorted index)
    bool pass[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float4 c0 = rec[4 * static_cast<size_t>(max(cj[u], 0))];
      const float qx = c0.x - pr.x, qy = c0.y - pr.y;
      float q2 = qx * qx + qy * qy;
      if (sh.is3d) {
        const float qz = c0.z - pr.z;
        q2 = q2 + qz * qz;
      }
      pass[u] = cj[u] >= 0 && cj[u] != i && q2 <= radius_sq;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned passed = __ballot_sync(FULL, pass[u]);
      if (pass[u])
        tail[(thead + twaiting + __popc(passed & before)) & (TAIL - 1)] =
            make_int2(me, cj[u]);
      twaiting += __popc(passed);
      __syncwarp();
      if (twaiting >= 32) finish(32);
    }
  }
  if (twaiting > 0) finish(twaiting);
  __syncthreads();

  // ---- the block's slots and counts, one contiguous piece each ----
  const size_t out0 = static_cast<size_t>(out_row0) * sh.k;
  for (int u = tid; u < (i1 - i0) * sh.k; u += THREADS) {
    keys[out0 + u] = s_key[u];
    idx[out0 + u] = s_idx[u];
  }
  if (tid < i1 - i0) emitted_out[out_row0 + tid] = s_emit[tid];
}

using Kernel = void (*)(const float4*, const int*, const float*, Shape,
                        Params, PredParams, int, float*, int*, int*);

template <bool PRODUCT>
Kernel kernel_of(int width) {
  return width == 2    ? fused_predict_kernel<PRODUCT, 2>
         : width == 4  ? fused_predict_kernel<PRODUCT, 4>
         : width == 8  ? fused_predict_kernel<PRODUCT, 8>
         : width == 16 ? fused_predict_kernel<PRODUCT, 16>
                       : fused_predict_kernel<PRODUCT, 32>;
}

// The kernel of an angle form and width. The split of the SM's memory
// between shared memory and L1 is left to CUDA's default, which keeps the
// rest of what the resident blocks need as L1: the walk lives on L1 hits,
// and the largest shared share (fused_detect.cu's choice) left 28 KB of L1
// and took 23% more time at the warn shape.
Kernel kernel_of(int product, int width) {
  return product ? kernel_of<true>(width) : kernel_of<false>(width);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// fields [n, 16] f32 (cls in the record's field 14), cell_start
// [nx*ny*nz + 1] i32, offsets [n_off] f32 on the device; params: N_PARAMS
// f32 and pred_params: N_PRED_PARAMS f32 on the host; outputs keys
// [n_off, n, k] f32, idx [n_off, n, k] i32, emitted [n_off, n] i32.
int tc_fused_predict(const void* fields, const void* cell_start,
                     const void* offsets, int n_off, int n, int nx, int ny,
                     int nz, int is3d, int k, int sub_steps,
                     int angle_product, const void* params,
                     const void* pred_params, void* keys, void* idx,
                     void* emitted, void* stream) {
  if (k < 1 || k > K_MAX || n_off > 65535 || sub_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || n_off <= 0) return 0;
  Params p;
  const float* pf = static_cast<const float*>(params);
  float* dst = reinterpret_cast<float*>(&p);
  for (int t = 0; t < tc::N_PARAMS; ++t) dst[t] = pf[t];
  PredParams q;
  pf = static_cast<const float*>(pred_params);
  dst = reinterpret_cast<float*>(&q);
  for (int t = 0; t < N_PRED_PARAMS; ++t) dst[t] = pf[t];
  const Shape sh{n, nx, ny, nz, is3d, k, 0, angle_product};
  const int width = width_for(static_cast<long long>(n) * n_off);
  const int span = span_of(width);
  const Kernel kernel = kernel_of(angle_product, width);
  kernel<<<dim3((n + span - 1) / span, n_off), THREADS, slot_bytes(width, k),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(fields), static_cast<const int*>(cell_start),
      static_cast<const float*>(offsets), sh, p, q, sub_steps,
      static_cast<float*>(keys), static_cast<int*>(idx),
      static_cast<int*>(emitted));
  return static_cast<int>(cudaGetLastError());
}

// The plan tc_fused_predict launches n objects at n_off offsets with k
// slots with: out[0 .. 4) = lanes per row, blocks, threads a block, dynamic
// shared memory in bytes.
void tc_fused_predict_plan(int n, int n_off, int k, int* out) {
  const int width = width_for(static_cast<long long>(n) * n_off);
  const int span = span_of(width);
  out[0] = width;
  out[1] = (n + span - 1) / span * n_off;
  out[2] = THREADS;
  out[3] = slot_bytes(width, k);
}

int tc_pred_param_count() { return N_PRED_PARAMS; }

}  // extern "C"
