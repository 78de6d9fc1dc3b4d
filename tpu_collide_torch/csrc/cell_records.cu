// The cell list's sorted records for Hopper (sm_90a): for each sorted row i,
// the state of object order[i] written once as its 16-float record (x, y,
// z, vx, vy, vz, ax, ay, az, size, heading, otype, sin_h, cos_h, cls, pad1;
// kernels/cell_list.FIELD_NAMES) and its oid, copied as the state holds it
// (a halo mirror's mark -(oid + 2) included).
//
// Replaces no TPU kernel: the JAX package leaves its record build to XLA.
// The port built the records with six gathers, sin, cos, a conversion, two
// zero columns and a ten-piece torch.cat (kernels/cell_list.
// cell_records_plain), whose every piece writes a 10M-long intermediate and
// whose cat fills the 64-byte rows one 4-12 byte column at a time, touching
// each 32-byte sector of the output ten times: 8.6 ms of a 10M step.
//
// Two passes, four threads a row in each, one float4 a thread, so that a
// warp's stores cover eight whole rows, 512 contiguous bytes:
//   pack    the state in state order into whole 64-byte records (the oid's
//           bits in pad1): every array read once, in order;
//   gather  the packed record of order[i] into row i, pad1 back to 0 and
//           the oid out: each random read is one whole aligned 64-byte row.
// Gathering each field from its own array (one pass) moved whole 32-byte
// sectors for every 4-12 useful bytes, about 330 bytes a row from nine
// arrays at random, and took 3.19 ms at 10M on an H100 (2.8x the 1.16 ms
// of those sectors at 3.35 TB/s). The two passes move 264 bytes a row, all
// in whole rows: pack reads 60 and writes 64, gather reads 8 + 64 and
// writes 68, 0.79 ms at 10M at 3.35 TB/s; what the records need at least
// (each input read once, each output written once) is 136 bytes a row,
// 0.41 ms. Each thread picks its sources by selects, not branches, so a
// warp's four quarters issue their loads together.
//
// Every field is a copy but otype, converted with the same round-to-nearest
// int-to-float conversion that torch's .to(torch.float32) runs, so the
// records are the plain version's bit for bit. sin_h and cos_h come in as
// torch.sin / torch.cos of the state's headings: an elementwise operation
// commutes with a gather, so they equal the plain version's sin of the
// sorted headings.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QUADS = 4;  // float4s a record

// rec[j] = the record of state row j, with the oid's bits in pad1
__global__ void __launch_bounds__(THREADS)
cell_records_pack(const float* __restrict__ pos,
                  const float* __restrict__ vel,
                  const float* __restrict__ acc,
                  const float* __restrict__ size,
                  const float* __restrict__ heading,
                  const int* __restrict__ otype,
                  const float* __restrict__ sin_h,
                  const float* __restrict__ cos_h,
                  const float* __restrict__ cls,
                  const int* __restrict__ oid, long long n,
                  float4* __restrict__ rec) {
  const long long t =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long j = t / QUADS;
  if (j >= n) return;
  const int q = static_cast<int>(t % QUADS);
  const long long j3 = 3 * j;
  // the sources of fields 4q .. 4q + 3
  const float* a0 = q == 0 ? pos + j3
                  : q == 1 ? vel + j3 + 1
                  : q == 2 ? acc + j3 + 2 : sin_h + j;
  const float* a1 = q == 0 ? pos + j3 + 1
                  : q == 1 ? vel + j3 + 2
                  : q == 2 ? size + j : cos_h + j;
  const float* a2 = q == 0 ? pos + j3 + 2
                  : q == 1 ? acc + j3
                  : q == 2 ? heading + j
                  : (cls != nullptr ? cls + j : nullptr);
  // the fourth is a float but for otype (q 2) and the oid (q 3)
  const uint32_t* a3 =
      q == 0 ? reinterpret_cast<const uint32_t*>(vel + j3)
    : q == 1 ? reinterpret_cast<const uint32_t*>(acc + j3 + 1)
    : q == 2 ? reinterpret_cast<const uint32_t*>(otype + j)
             : reinterpret_cast<const uint32_t*>(oid + j);
  float4 r;
  r.x = *a0;
  r.y = *a1;
  r.z = a2 != nullptr ? *a2 : 0.0f;
  const uint32_t b3 = *a3;
  r.w = q == 2 ? static_cast<float>(static_cast<int>(b3))
               : __uint_as_float(b3);
  rec[t] = r;
}

// fields[i] = rec[order[i]] with pad1 0; oid_out[i] = the oid in its pad1
__global__ void __launch_bounds__(THREADS)
cell_records_gather(const long long* __restrict__ order,
                    const float4* __restrict__ rec, long long n,
                    float4* __restrict__ fields, int* __restrict__ oid_out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long i = t / QUADS;
  if (i >= n) return;
  const int q = static_cast<int>(t % QUADS);
  float4 r = rec[order[i] * QUADS + q];
  if (q == QUADS - 1) {
    oid_out[i] = __float_as_int(r.w);
    r.w = 0.0f;
  }
  fields[t] = r;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// order [n] int64 (a permutation of 0 .. n-1); pos, vel, acc [n, 3] f32;
// size, heading, sin_h, cos_h [n] f32; otype, oid [n] int32; cls [n] f32 or
// null (the records' cls is then 0); work [n, 16] f32 scratch; outputs
// fields [n, 16] f32 and oid_out [n] int32. work and fields 16-byte aligned.
int tc_cell_records(const void* order, const void* pos, const void* vel,
                    const void* acc, const void* size, const void* heading,
                    const void* otype, const void* sin_h, const void* cos_h,
                    const void* cls, const void* oid, long long n,
                    void* work, void* fields, void* oid_out, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(work) % sizeof(float4) != 0 ||
      reinterpret_cast<uintptr_t>(fields) % sizeof(float4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = (n * QUADS + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  cell_records_pack<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const float*>(acc), static_cast<const float*>(size),
      static_cast<const float*>(heading), static_cast<const int*>(otype),
      static_cast<const float*>(sin_h), static_cast<const float*>(cos_h),
      static_cast<const float*>(cls), static_cast<const int*>(oid), n,
      static_cast<float4*>(work));
  cell_records_gather<<<grid, THREADS, 0, st>>>(
      static_cast<const long long*>(order),
      static_cast<const float4*>(work), n, static_cast<float4*>(fields),
      static_cast<int*>(oid_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
