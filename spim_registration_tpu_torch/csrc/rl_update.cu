// The two elementwise passes of a sequential (OSEM) Richardson-Lucy view
// update (deconv/lucy_richardson.py `_rl_iterate`), each one pass over
// memory:
//
//   quotient: q = clamp(img / clamp_min(conv1, 1e-12), 0, 1e4), less 1 in
//             the delta form; written once, as float32 or as the bf16
//             operand of the next lowrank convolution;
//   update:   d   = conv2 in the delta form, conv2 - 1 otherwise
//             psi = psi * (1 + (osem * w) * d)
//             psi = psi / (1 + lam * psi)          (where lam is set)
//             psi = clamp_min(psi, min_value)
//             written in place, and once more as the bf16 operand of the
//             next view's convolution where that convolution reads bf16.
//
// Replaces no TPU kernel: the reference leaves this chain to XLA, which
// fuses it into the surrounding loop. On the card PyTorch runs it as one
// kernel an operation (12 a view, and two bf16 casts on the lowrank path),
// each reading and writing whole volumes. The plain versions are
// `rl_quotient_reference` and `rl_update_reference` (ops/kernels/
// rl_update.py), which are that chain; these kernels equal them bit for
// bit:
// - the same float32 operations in the chain's order, each rounded once
//   (__fmul_rn, __fadd_rn, __fdiv_rn: nothing contracts into an FMA the
//   chain does not form);
// - the host's scalars rounded to float32 as PyTorch rounds a Python
//   float operand (the C cast of the double);
// - the clamps as PyTorch's: a NaN passes through (an explicit test, since
//   fmaxf / fminf alone would drop it), else its own fmaxf / fminf, so a
//   signed zero comes out as it does there;
// - bf16 by round-to-nearest-even, PyTorch's float-to-bf16 cast on sm_90.
//
// What bounds them on an H100: bytes. A view of a 256^3 volume reads the
// image, conv1, conv2, the weight and psi once each (67 MB each in f32),
// writes psi once and the two bf16 operands (34 MB each): 470 MB, 0.14 ms
// at 3.35 TB/s, against ~10 flops a voxel. The design keeps every byte in
// one stream: a grid-stride loop over chunks of 8 voxels along x, sized
// from the SM count (`utils/device.sm_count`), 16-byte vector loads and
// stores where the pointers and rows are 16-byte aligned (two float4 a
// float32 chunk, one 16-byte store a bf16 chunk), element accesses for
// the masked tail of a row and for unaligned inputs. Contiguous operands
// are one flat row. The convolution's output may be a strided 3-D view
// with unit innermost stride (the FFT path's crop of its padded result):
// it is read in place through its strides, not copied.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // voxels a chunk, along x

// PyTorch rounds a Python float operand to float32 by the C cast.
constexpr float kConvFloor = static_cast<float>(1e-12);
constexpr float kQuotientCap = static_cast<float>(1e4);

// The volume as rows of X voxels: the contiguous operands hold row r at
// r * X, the convolution output at (r / Y) * s0 + (r % Y) * s1.
struct Rows {
  long long Y, X, s0, s1;
  long long per_row;  // chunks a row
  long long chunks;
};

__device__ __forceinline__ float clamp_min_(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void load(const float* p, float (&v)[VEC], int n,
                                     bool vec) {
  if (vec && n == VEC) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = i < n ? p[i] : 0.0f;
  }
}

__device__ __forceinline__ void store(float* p, const float (&v)[VEC], int n,
                                      bool vec) {
  if (vec && n == VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < n) p[i] = v[i];
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[VEC],
                                      int n, bool vec) {
  if (vec && n == VEC) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                   bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < n) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// Chunk c's offsets: in the contiguous operands, in the convolution
// output, and its voxel count (VEC, or fewer at a row's end).
struct Chunk {
  long long at, conv_at;
  int n;
};

__device__ __forceinline__ Chunk chunk(const Rows& g, long long c) {
  const long long r = c / g.per_row;
  const long long x = (c - r * g.per_row) * VEC;
  const long long rem = g.X - x;
  return {r * g.X + x, (r / g.Y) * g.s0 + (r % g.Y) * g.s1 + x,
          static_cast<int>(rem < VEC ? rem : VEC)};
}

template <typename Out>
__global__ void __launch_bounds__(THREADS)
    rl_quotient_kernel(const float* __restrict__ img,
                       const float* __restrict__ conv, Out* __restrict__ out,
                       Rows g, bool vec, bool minus_one) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long c = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       c < g.chunks; c += step) {
    const Chunk k = chunk(g, c);
    float a[VEC], b[VEC];
    load(img + k.at, a, k.n, vec);
    load(conv + k.conv_at, b, k.n, vec);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float q = clamp_(__fdiv_rn(a[i], clamp_min_(b[i], kConvFloor)), 0.0f,
                       kQuotientCap);
      a[i] = minus_one ? __fadd_rn(q, -1.0f) : q;
    }
    store(out + k.at, a, k.n, vec);
  }
}

template <bool COPY>
__global__ void __launch_bounds__(THREADS)
    rl_update_kernel(float* __restrict__ psi, const float* __restrict__ conv,
                     const float* __restrict__ w,
                     __nv_bfloat16* __restrict__ copy, Rows g, bool vec,
                     bool delta, float osem, bool has_lam, float lam,
                     float min_value) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long c = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       c < g.chunks; c += step) {
    const Chunk k = chunk(g, c);
    float p[VEC], d[VEC], wv[VEC];
    load(psi + k.at, p, k.n, vec);
    load(conv + k.conv_at, d, k.n, vec);
    load(w + k.at, wv, k.n, vec);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float di = delta ? d[i] : __fadd_rn(d[i], -1.0f);
      float v = __fmul_rn(
          p[i], __fadd_rn(1.0f, __fmul_rn(__fmul_rn(osem, wv[i]), di)));
      if (has_lam) v = __fdiv_rn(v, __fadd_rn(1.0f, __fmul_rn(lam, v)));
      p[i] = clamp_min_(v, min_value);
    }
    store(psi + k.at, p, k.n, vec);
    if (COPY) store(copy + k.at, p, k.n, vec);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The rows of a (Z, Y, X) volume; false for a bad shape or grid.
bool plan(long long Z, long long Y, long long X, long long s0, long long s1,
          int blocks, Rows* g) {
  if (Z <= 0 || Y <= 0 || X <= 0 || blocks <= 0) return false;
  g->Y = Y;
  g->X = X;
  g->s0 = s0;
  g->s1 = s1;
  g->per_row = (X + VEC - 1) / VEC;
  g->chunks = Z * Y * g->per_row;
  return true;
}

// Vector accesses need every chunk 16-byte aligned in every operand:
// aligned bases and, on more than one row, rows and convolution strides
// that keep it (X % 8 for the bf16 rows, strides % 4 for float32).
bool vector_ok(const Rows& g, long long rows, const void* a, const void* b,
               const void* c, const void* d) {
  return aligned16(a) && aligned16(b) && aligned16(c) && aligned16(d) &&
         (rows == 1 || (g.X % VEC == 0 && g.s0 % 4 == 0 && g.s1 % 4 == 0));
}

}  // namespace

extern "C" {

// img, out: contiguous (Z, Y, X); conv: (Z, Y, X) float32 with strides
// (s0, s1, 1); out float32, or bf16 where out_bf16. Returns a cudaError_t.
int spim_rl_quotient(const void* img, const void* conv, void* out,
                     long long Z, long long Y, long long X, long long s0,
                     long long s1, int minus_one, int out_bf16, int blocks,
                     void* stream) {
  Rows g;
  if (!plan(Z, Y, X, s0, s1, blocks, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vector_ok(g, Z * Y, img, conv, out, out);
  const float* i = static_cast<const float*>(img);
  const float* c = static_cast<const float*>(conv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    rl_quotient_kernel<<<blocks, THREADS, 0, st>>>(
        i, c, static_cast<__nv_bfloat16*>(out), g, vec, minus_one != 0);
  else
    rl_quotient_kernel<<<blocks, THREADS, 0, st>>>(
        i, c, static_cast<float*>(out), g, vec, minus_one != 0);
  return static_cast<int>(cudaGetLastError());
}

// psi, w: contiguous (Z, Y, X) float32, psi updated in place; conv as in
// spim_rl_quotient; copy: null, or a contiguous (Z, Y, X) bf16 that
// receives the new psi. Returns a cudaError_t.
int spim_rl_update(void* psi, const void* conv, const void* w, void* copy,
                   long long Z, long long Y, long long X, long long s0,
                   long long s1, int delta, float osem, int has_lam,
                   float lam, float min_value, int blocks, void* stream) {
  Rows g;
  if (!plan(Z, Y, X, s0, s1, blocks, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vector_ok(g, Z * Y, psi, conv, w, copy ? copy : psi);
  float* p = static_cast<float*>(psi);
  const float* c = static_cast<const float*>(conv);
  const float* wv = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (copy)
    rl_update_kernel<true><<<blocks, THREADS, 0, st>>>(
        p, c, wv, static_cast<__nv_bfloat16*>(copy), g, vec, delta != 0,
        osem, has_lam != 0, lam, min_value);
  else
    rl_update_kernel<false><<<blocks, THREADS, 0, st>>>(
        p, c, wv, nullptr, g, vec, delta != 0, osem, has_lam != 0, lam,
        min_value);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
