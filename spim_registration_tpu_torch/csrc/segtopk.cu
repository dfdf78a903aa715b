// Per-segment top-`rounds` extraction of a -inf-padded score field, one
// read of the field:
//
//     for each segment s of `seg` floats (the field seen as (S, seg)):
//       counts[s] = #{ x > -inf }
//       repeat `rounds` times:
//         m   = max over the segment
//         am  = FIRST position holding m   (an all--inf segment gives the
//               first -inf position, i.e. 0 once nothing finite is left)
//         vals[s, r] = m ; idx[s, r] = s * seg + am
//         segment[am] = -inf               (mask by index, so exact
//                                            duplicates come out one per
//                                            round)
//
// Replaces spim_registration_tpu/ops/pallas/segtopk.py `_seg_topk_kernel`
// (the selection behind DoG peak picking, ops/extrema.py
// `_segmented_compact_topk`). It is a selection: the output equals the
// plain version `segment_topk_reference` (ops/kernels/segtopk.py) bit for
// bit, ties included.
//
// What bounds it on an H100: bytes. At 256^3 the field is 2^24 floats
// (67 MB) read once, against ~1.2 MB of outputs and a few compares per
// element: ~0.02 ms of HBM traffic. The design therefore reads the field
// once with 16-byte coalesced loads and keeps each segment in registers:
// one warp per segment, each lane holding seg/32 values (16 at seg = 512),
// loaded as float4 chunks so that a warp reads 512 contiguous bytes per
// chunk. Each round is a local first-max scan over the lane's registers
// (positions ascend with the register index) and a 5-step butterfly
// shuffle of (value, position) in which the larger value wins and, among
// equal values, the smaller position. The owner lane masks the winner in
// its registers. The finite count is a warp sum. No shared memory, 8
// warps per block, any number of segments.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <int VPL>  // values per lane: seg = 32 * VPL
__global__ void __launch_bounds__(THREADS)
seg_topk_kernel(const float* __restrict__ field, float* __restrict__ vals,
                int* __restrict__ idx, int* __restrict__ counts,
                long long S, int rounds) {
  constexpr int SEG = 32 * VPL;
  constexpr int CHUNKS = VPL / 4;  // float4 chunks per lane
  const int lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // whole warps exit together

  // register i = 4 * c + e holds segment position c * 128 + lane * 4 + e
  const float4* src =
      reinterpret_cast<const float4*>(field + s * SEG) + lane;
  float v[VPL];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const float4 q = src[c * 32];
    v[4 * c + 0] = q.x;
    v[4 * c + 1] = q.y;
    v[4 * c + 2] = q.z;
    v[4 * c + 3] = q.w;
  }

  int finite = 0;
#pragma unroll
  for (int i = 0; i < VPL; ++i) finite += (v[i] > -CUDART_INF_F) ? 1 : 0;
  finite = __reduce_add_sync(0xffffffffu, finite);
  if (lane == 0) counts[s] = finite;

  const int base = static_cast<int>(s) * SEG;
  for (int r = 0; r < rounds; ++r) {
    // first maximum among this lane's registers (ascending positions)
    float best = v[0];
    int bi = 0;
#pragma unroll
    for (int i = 1; i < VPL; ++i) {
      if (v[i] > best) {
        best = v[i];
        bi = i;
      }
    }
    int bpos = (bi >> 2) * 128 + lane * 4 + (bi & 3);
    // butterfly: larger value wins; equal values -> smaller position
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int op = __shfl_xor_sync(0xffffffffu, bpos, off);
      if (ov > best || (ov == best && op < bpos)) {
        best = ov;
        bpos = op;
      }
    }
    if (lane == 0) {
      vals[s * rounds + r] = best;
      idx[s * rounds + r] = base + bpos;
    }
    // the owner masks the winner by position
    if (((bpos & 127) >> 2) == lane) {
      const int own = (bpos >> 7) * 4 + (bpos & 3);
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (i == own) v[i] = -CUDART_INF_F;
    }
  }
}

}  // namespace

extern "C" {

// field: (S, seg) float32, contiguous, 16-byte aligned, seg in {128, 256,
// 512}; vals (S, rounds) float32, idx (S, rounds) int32, counts (S,)
// int32. Returns a cudaError_t.
int spim_segtopk(const void* field, void* vals, void* idx, void* counts,
                 long long S, int seg, int rounds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || rounds <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((S + WARPS - 1) / WARPS);
  const float* f = static_cast<const float*>(field);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  int* c = static_cast<int*>(counts);
  switch (seg) {
    case 128:
      seg_topk_kernel<4><<<grid, THREADS, 0, st>>>(f, v, i, c, S, rounds);
      break;
    case 256:
      seg_topk_kernel<8><<<grid, THREADS, 0, st>>>(f, v, i, c, S, rounds);
      break;
    case 512:
      seg_topk_kernel<16><<<grid, THREADS, 0, st>>>(f, v, i, c, S, rounds);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
