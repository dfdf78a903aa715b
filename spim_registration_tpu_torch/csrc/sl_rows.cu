// Fused y and x passes of the lowrank (folded-matrix) convolution, with
// the rank sum:
//
//     o[z, :, :] = sum_r  round(My[r] @ a[r, z]) @ Mx[r]^T
//
// a: (R, Z, Y, X), My: (R, Yo, Y), Mx: (R, Xo, X), all in the matrix
// dtype; o: (Z, Yo, Xo) float32. The y product accumulates in f32 and is
// rounded once to the matrix dtype; the x product and the rank sum stay
// in f32.
//
// Replaces spim_registration_tpu/ops/pallas/lowrank_conv.py
// `_sl_rows_kernel`. On the TPU the rank axis is a sequential grid
// dimension that accumulates into VMEM; on Hopper blocks run in no order,
// so the rank loop runs INSIDE the block: no atomics, a deterministic
// sum, and `o` written once.
//
// What bounds it on an H100: tensor-core operations. The dense
// formulation does 2*R*Z*(Yo*Y*X + Yo*X*Xo) flops, ~0.34 TFLOP per conv at
// 256^3 and rank 20, against ~0.75 GB of traffic (`a` read once, `o`
// written once). The design keeps both intermediates on chip: one block
// per (64-row Yo tile, z); per rank it
//   1. stages My[r, tile, :] in shared memory and computes the 64 x X
//      product b = My_tile @ a[r, z] with bf16 wmma (16x16x16, f32
//      fragments), streaming a[r, z] through shared memory in 64-row
//      chunks, and rounds b to bf16 into shared memory (64 x X);
//   2. accumulates acc += b @ Mx[r]^T into register fragments that live
//      across the whole rank loop, streaming Mx[r] in 64-column chunks.
// `o` is stored once, in f32, after the last rank. The y/x band windows
// of the TPU kernel (axes >= 384) are not used: the products are dense.
// No double buffering and no TMA/wgmma yet: a simple kernel first.
//
// Limits: Xo <= 512 (register fragments) and the shared-memory plan must
// fit the 227 KB a block may use; `spim_sl_rows_smem` reports the plan or
// -1, and the Python wrapper raises on -1.
//
// The float32 matrices take a plain SIMT kernel (8 Yo rows per block,
// both intermediates in shared memory): not the main path, kept exact.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TY = 64;        // Yo rows per block
constexpr int THREADS = 256;  // 8 warps
constexpr int KC = 64;        // stage-1 contraction (y) chunk
constexpr int CC = 64;        // stage-1 output column (x) chunk
constexpr int KX = 64;        // stage-2 contraction (x) chunk
constexpr int LDS1 = CC + 8;  // a-chunk stride (bf16)
constexpr int LDC1 = CC + 4;  // stage-1 f32 tile stride
constexpr int LDMX = KX + 8;  // Mx-chunk stride (bf16)
constexpr int MAX_SMEM = 232448;
constexpr int TYF = 8;        // Yo rows per block of the f32 kernel

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Plan {
  int ypad, xpad, xopad, ldm, ldb, union_bytes, bytes;
};

__host__ __device__ inline Plan make_plan(int Y, int X, int Xo) {
  Plan p;
  p.ypad = round_up(Y, KC);
  p.xpad = round_up(X, KX);
  p.xopad = round_up(Xo, 16);
  p.ldm = p.ypad + 8;
  p.ldb = p.xpad + 8;
  int u = KC * LDS1 * 2;
  if (TY * LDC1 * 4 > u) u = TY * LDC1 * 4;
  if (p.xopad * LDMX * 2 > u) u = p.xopad * LDMX * 2;
  p.union_bytes = u;
  p.bytes = TY * p.ldm * 2 + TY * p.ldb * 2 + u;
  const int epi = TY * (p.xopad + 4) * 4;
  if (epi > p.bytes) p.bytes = epi;
  return p;
}

// MAXNF: accumulator fragments per warp in stage 2 (Xo <= 32 * MAXNF).
template <int MAXNF>
__global__ void __launch_bounds__(THREADS, (MAXNF <= 8) ? 2 : 1)
sl_rows_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ my,
                    const __nv_bfloat16* __restrict__ mx,
                    float* __restrict__ out,
                    int R, int Z, int Y, int X, int Yo, int Xo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan p = make_plan(Y, X, Xo);
  __nv_bfloat16* Ms = reinterpret_cast<__nv_bfloat16*>(smem);   // TY x ldm
  __nv_bfloat16* Bs = Ms + TY * p.ldm;                            // TY x ldb
  unsigned char* U = smem + TY * p.ldm * 2 + TY * p.ldb * 2;
  __nv_bfloat16* As1 = reinterpret_cast<__nv_bfloat16*>(U);      // KC x LDS1
  float* Cs1 = reinterpret_cast<float*>(U);                       // TY x LDC1
  __nv_bfloat16* Mxs = reinterpret_cast<__nv_bfloat16*>(U);      // xopad x LDMX
  float* Cs2 = reinterpret_cast<float*>(smem);                    // epilogue

  const int y0 = blockIdx.x * TY;
  const int z = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp & 3;        // 16-row slab
  const int cg = warp >> 2;       // column group (0 / 1)
  const long long YX = static_cast<long long>(Y) * X;
  const bool vecY = (Y % 8) == 0;
  const bool vecX = (X % 8) == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const int nfx = p.xopad / 16;   // 16-wide output column fragments

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXNF];
#pragma unroll
  for (int i = 0; i < MAXNF; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int r = 0; r < R; ++r) {
    // ---- My[r, y0:y0+TY, :] -> Ms (zero beyond Yo rows / Y columns)
    const __nv_bfloat16* myr = my + static_cast<long long>(r) * Yo * Y;
    const int mchunks = TY * (p.ypad / 8);
    for (int c = tid; c < mchunks; c += THREADS) {
      const int row = c / (p.ypad / 8);
      const int col = (c % (p.ypad / 8)) * 8;
      const int yo = y0 + row;
      __nv_bfloat16* dst = Ms + row * p.ldm + col;
      if (vecY && yo < Yo && col + 8 <= Y) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            myr + static_cast<long long>(yo) * Y + col);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (yo < Yo && col + e < Y)
                       ? myr[static_cast<long long>(yo) * Y + col + e] : zero;
      }
    }
    // (Ms is first read after the barrier inside the chunk loop below)

    // ---- stage 1: Bs = round(Ms @ a[r, z]) in CC-column chunks
    const __nv_bfloat16* arz = a + (static_cast<long long>(r) * Z + z) * YX;
    for (int cc = 0; cc < p.xpad; cc += CC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> b1[2];
      wmma::fill_fragment(b1[0], 0.0f);
      wmma::fill_fragment(b1[1], 0.0f);
      for (int kc = 0; kc < p.ypad; kc += KC) {
        for (int c = tid; c < KC * CC / 8; c += THREADS) {
          const int row = c / (CC / 8);
          const int col = (c % (CC / 8)) * 8;
          const int y = kc + row;
          const int x = cc + col;
          __nv_bfloat16* dst = As1 + row * LDS1 + col;
          if (vecX && y < Y && x + 8 <= X) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
                arz + static_cast<long long>(y) * X + x);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dst[e] = (y < Y && x + e < X)
                           ? arz[static_cast<long long>(y) * X + x + e] : zero;
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::load_matrix_sync(fa, Ms + (wr * 16) * p.ldm + kc + kk, p.ldm);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fb, As1 + kk * LDS1 + cg * 32 + i * 16,
                                   LDS1);
            wmma::mma_sync(b1[i], fa, fb, b1[i]);
          }
        }
        __syncthreads();
      }
      // f32 chunk -> shared, then rounded once into Bs
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(Cs1 + (wr * 16) * LDC1 + cg * 32 + i * 16,
                                b1[i], LDC1, wmma::mem_row_major);
      __syncthreads();
      for (int c = tid; c < TY * CC; c += THREADS) {
        const int row = c / CC;
        const int col = c % CC;
        Bs[row * p.ldb + cc + col] = __float2bfloat16_rn(Cs1[row * LDC1 + col]);
      }
      __syncthreads();
    }

    // ---- stage 2: acc += Bs @ Mx[r]^T in KX-column chunks of x
    const __nv_bfloat16* mxr = mx + static_cast<long long>(r) * Xo * X;
    for (int kx = 0; kx < p.xpad; kx += KX) {
      for (int c = tid; c < p.xopad * (KX / 8); c += THREADS) {
        const int xo = c / (KX / 8);
        const int col = (c % (KX / 8)) * 8;
        const int x = kx + col;
        __nv_bfloat16* dst = Mxs + xo * LDMX + col;
        if (vecX && xo < Xo && x + 8 <= X) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
              mxr + static_cast<long long>(xo) * X + x);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (xo < Xo && x + e < X)
                         ? mxr[static_cast<long long>(xo) * X + x + e] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KX; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Bs + (wr * 16) * p.ldb + kx + kk, p.ldb);
#pragma unroll
        for (int i = 0; i < MAXNF; ++i) {
          const int cf = cg + 2 * i;
          if (cf < nfx) {
            // Mx chunk as a column-major K x N operand: (k, n) at n*LDMX+k
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> fb;
            wmma::load_matrix_sync(fb, Mxs + (cf * 16) * LDMX + kk, LDMX);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: fragments -> shared f32 tile -> o (written once)
  const int ldo = p.xopad + 4;
#pragma unroll
  for (int i = 0; i < MAXNF; ++i) {
    const int cf = cg + 2 * i;
    if (cf < nfx)
      wmma::store_matrix_sync(Cs2 + (wr * 16) * ldo + cf * 16, acc[i], ldo,
                              wmma::mem_row_major);
  }
  __syncthreads();
  float* oz = out + static_cast<long long>(z) * Yo * Xo;
  for (int c = tid; c < TY * Xo; c += THREADS) {
    const int row = c / Xo;
    const int col = c % Xo;
    if (y0 + row < Yo)
      oz[static_cast<long long>(y0 + row) * Xo + col] = Cs2[row * ldo + col];
  }
}

__global__ void __launch_bounds__(THREADS)
sl_rows_f32_kernel(const float* __restrict__ a, const float* __restrict__ my,
                   const float* __restrict__ mx, float* __restrict__ out,
                   int R, int Z, int Y, int X, int Yo, int Xo) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* bF = reinterpret_cast<float*>(smem_f32);   // TYF x X
  float* aF = bF + TYF * X;                     // TYF x Xo
  const int y0 = blockIdx.x * TYF;
  const int z = blockIdx.y;
  const int tid = threadIdx.x;
  const long long YX = static_cast<long long>(Y) * X;
  for (int c = tid; c < TYF * Xo; c += THREADS) aF[c] = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float* arz = a + (static_cast<long long>(r) * Z + z) * YX;
    const float* myr = my + static_cast<long long>(r) * Yo * Y;
    const float* mxr = mx + static_cast<long long>(r) * Xo * X;
    __syncthreads();  // bF of the previous rank fully consumed
    for (int c = tid; c < TYF * X; c += THREADS) {
      const int i = c / X;
      const int x = c % X;
      float s = 0.0f;
      if (y0 + i < Yo) {
        const float* m = myr + static_cast<long long>(y0 + i) * Y;
        for (int y = 0; y < Y; ++y)
          s = fmaf(m[y], arz[static_cast<long long>(y) * X + x], s);
      }
      bF[c] = s;
    }
    __syncthreads();
    for (int c = tid; c < TYF * Xo; c += THREADS) {
      const int i = c / Xo;
      const int xo = c % Xo;
      const float* m = mxr + static_cast<long long>(xo) * X;
      float s = 0.0f;
      for (int x = 0; x < X; ++x) s = fmaf(bF[i * X + x], m[x], s);
      aF[c] += s;
    }
  }
  __syncthreads();
  float* oz = out + static_cast<long long>(z) * Yo * Xo;
  for (int c = tid; c < TYF * Xo; c += THREADS) {
    const int i = c / Xo;
    if (y0 + i < Yo)
      oz[static_cast<long long>(y0 + i) * Xo + c % Xo] = aF[c];
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these axes, or -1 when it
// cannot take them. dtype: 0 = bfloat16, 1 = float32.
int spim_sl_rows_smem(int Y, int X, int Xo, int dtype) {
  if (Y <= 0 || X <= 0 || Xo <= 0) return -1;
  if (dtype == 1) {
    const long long b = static_cast<long long>(TYF) * (X + Xo) * 4;
    return b <= MAX_SMEM ? static_cast<int>(b) : -1;
  }
  if (dtype != 0 || Xo > 512) return -1;
  const Plan p = make_plan(Y, X, Xo);
  return p.bytes <= MAX_SMEM ? p.bytes : -1;
}

int spim_sl_rows(const void* a, const void* my, const void* mx, void* out,
                 int R, int Z, int Y, int X, int Yo, int Xo, int dtype,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = spim_sl_rows_smem(Y, X, Xo, dtype);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (dtype == 0) {
    dim3 grid((Yo + TY - 1) / TY, Z);
    const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
    const __nv_bfloat16* py = static_cast<const __nv_bfloat16*>(my);
    const __nv_bfloat16* px = static_cast<const __nv_bfloat16*>(mx);
    float* po = static_cast<float*>(out);
    if (Xo <= 256) {
      err = set_smem(sl_rows_bf16_kernel<8>, bytes);
      if (err) return err;
      sl_rows_bf16_kernel<8><<<grid, THREADS, bytes, s>>>(
          pa, py, px, po, R, Z, Y, X, Yo, Xo);
    } else {
      err = set_smem(sl_rows_bf16_kernel<16>, bytes);
      if (err) return err;
      sl_rows_bf16_kernel<16><<<grid, THREADS, bytes, s>>>(
          pa, py, px, po, R, Z, Y, X, Yo, Xo);
    }
  } else {
    dim3 grid((Yo + TYF - 1) / TYF, Z);
    err = set_smem(sl_rows_f32_kernel, bytes);
    if (err) return err;
    sl_rows_f32_kernel<<<grid, THREADS, bytes, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(my),
        static_cast<const float*>(mx), static_cast<float*>(out),
        R, Z, Y, X, Yo, Xo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
