// Stacked z pass of the lowrank (folded-matrix) convolution:
//
//     a[r, n, j] = sum_{k in window(n)} Mz[r, n, k] * vm[k, j]
//
// with j running over the flattened, contiguous y*x axis of the volume.
// Accumulates in f32 and rounds once to the matrix dtype on the store.
//
// Replaces spim_registration_tpu/ops/pallas/lowrank_conv.py
// `_zpass_banded_kernel` (the band-windowed form) and `_zpass_kernel`
// (the dense form): here both are one kernel driven by a per-tile window
// table. The dense form is the table with the window [0, P) on every tile;
// the banded form has each 64-row output tile contract only the columns
// its band can reach (see `band_blocks` in ops/kernels/lowrank_conv.py).
//
// What bounds it on an H100: bytes. At 256^3 and rank ~20 the kernel
// writes `a`, R*N*Y*X bf16 = ~0.7 GB, while the banded products are
// ~0.06 TFLOP — ~0.2 ms of HBM traffic against well under 0.1 ms of
// tensor-core time. The design therefore aims at streaming `a` out once:
// each block computes a 64 x 128 output tile with bf16 tensor cores
// (wmma 16x16x16, f32 fragments), contracting only its window, stages the
// f32 tile in shared memory and writes it out as 16-byte bf16 vectors.
// The volume `vm` (P*Y*X bf16, 33 MB at 256^3) fits in the 50 MB L2, so
// re-reading it per (rank, row tile) costs L2 and not HBM bandwidth.
// No double buffering and no TMA/wgmma yet: a simple kernel first.
//
// The float32 matrices (lowrank_dtype="float32") take a plain SIMT kernel
// with one thread per output element: not the main path, kept exact.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;        // output rows per block == window-table tile
constexpr int TN = 128;       // output columns (y*x) per block
constexpr int TK = 32;        // contraction chunk staged in shared memory
constexpr int THREADS = 256;  // 8 warps: 4 row slabs x 2 column halves
constexpr int LDA = TK + 8;   // bf16 row strides, +8 staggers the banks
constexpr int LDB = TN + 8;
constexpr int LDC = TN + 4;   // f32 epilogue tile stride
constexpr int SMEM_BYTES = TM * LDC * 4;  // epilogue tile >= A + B stages
static_assert(TM * LDA * 2 + TK * LDB * 2 <= SMEM_BYTES, "stage size");

__global__ void __launch_bounds__(THREADS)
zpass_bf16_kernel(const __nv_bfloat16* __restrict__ mz,
                  const __nv_bfloat16* __restrict__ vm,
                  __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ win,
                  int N, int P, long long J, int n_tiles) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + TM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tile = blockIdx.y % n_tiles;
  const int r = blockIdx.y / n_tiles;
  const int n0 = tile * TM;
  const long long j0 = static_cast<long long>(blockIdx.x) * TN;
  const int k0 = win[2 * tile];
  const int k1 = win[2 * tile + 1];
  const __nv_bfloat16* A = mz + static_cast<long long>(r) * N * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp & 3;           // 16-row slab of the tile
  const int wc = (warp >> 2) * 64;   // 64-column half of the tile
  const bool vecA = (P % 8) == 0;    // 16-byte row chunks are aligned
  const bool vecJ = (J % 8) == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int kc = k0; kc < k1; kc += TK) {
    {  // A chunk: TM x TK, one 8-element chunk per thread
      const int row = tid >> 2;
      const int col = (tid & 3) * 8;
      const int n = n0 + row;
      const int k = kc + col;
      __nv_bfloat16* dst = As + row * LDA + col;
      if (vecA && n < N && k + 8 <= k1) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            A + static_cast<long long>(n) * P + k);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (n < N && k + e < k1)
                       ? A[static_cast<long long>(n) * P + k + e] : zero;
      }
    }
    // B chunk: TK x TN rows of the volume, two 8-element chunks per thread
    for (int c = tid; c < TK * TN / 8; c += THREADS) {
      const int row = c / (TN / 8);
      const int col = (c % (TN / 8)) * 8;
      const int k = kc + row;
      const long long j = j0 + col;
      __nv_bfloat16* dst = Bs + row * LDB + col;
      if (vecJ && k < k1 && j + 8 <= J) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(vm + static_cast<long long>(k) * J + j);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (k < k1 && j + e < J)
                       ? vm[static_cast<long long>(k) * J + j + e] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + (wr * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * LDB + wc + i * 16, LDB);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(Cs + (wr * 16) * LDC + wc + i * 16, acc[i], LDC,
                            wmma::mem_row_major);
  __syncthreads();

  __nv_bfloat16* O = out + static_cast<long long>(r) * N * J;
  for (int c = tid; c < TM * TN / 8; c += THREADS) {
    const int row = c / (TN / 8);
    const int col = (c % (TN / 8)) * 8;
    const int n = n0 + row;
    const long long j = j0 + col;
    if (n >= N) continue;
    const float* src = Cs + row * LDC + col;
    __nv_bfloat16* dst = O + static_cast<long long>(n) * J + j;
    if (vecJ && j + 8 <= J) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(src[e]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < 8 && j + e < J; ++e)
        dst[e] = __float2bfloat16_rn(src[e]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
zpass_f32_kernel(const float* __restrict__ mz, const float* __restrict__ vm,
                 float* __restrict__ out, const int* __restrict__ win,
                 int N, int P, long long J) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const int n = blockIdx.y % N;
  const int r = blockIdx.y / N;
  if (j >= J) return;
  const int tile = n / TM;
  const float* row = mz + (static_cast<long long>(r) * N + n) * P;
  float acc = 0.0f;
  for (int k = win[2 * tile]; k < win[2 * tile + 1]; ++k)
    acc = fmaf(row[k], vm[static_cast<long long>(k) * J + j], acc);
  out[(static_cast<long long>(r) * N + n) * J + j] = acc;
}

}  // namespace

extern "C" {

// Rows of the output per window-table entry (the band table's tile).
int spim_zpass_tile_rows(void) { return TM; }

// dtype: 0 = bfloat16, 1 = float32. `win` holds (k0, k1) int32 pairs, one
// per TM-row tile of N, on the device. Returns a cudaError_t.
int spim_zpass(const void* mz, const void* vm, void* out, const int* win,
               int R, int N, int P, long long J, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + TM - 1) / TM;
  if (dtype == 0) {
    dim3 grid(static_cast<unsigned>((J + TN - 1) / TN),
              static_cast<unsigned>(R * n_tiles));
    zpass_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(mz),
        static_cast<const __nv_bfloat16*>(vm),
        static_cast<__nv_bfloat16*>(out), win, N, P, J, n_tiles);
  } else if (dtype == 1) {
    dim3 grid(static_cast<unsigned>((J + THREADS - 1) / THREADS),
              static_cast<unsigned>(R * N));
    zpass_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(mz), static_cast<const float*>(vm),
        static_cast<float*>(out), win, N, P, J);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
