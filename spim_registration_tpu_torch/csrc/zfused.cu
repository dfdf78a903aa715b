// Fully fused z + y + x lowrank (folded-matrix) convolution with the rank
// sum:
//
//     a[r]   = round(Mz[r] x_z vm)          (z pass, f32 sums, one rounding)
//     b[r]   = round(My[r] x_y a[r])        (y pass, f32 sums, one rounding)
//     o      = sum_r  Mx[r] x_x b[r]        (x pass and rank sum in f32)
//
// vm: (Z, Y, X) bf16; Mz (R, Z, Z), My (R, Y, Y), Mx (R, X, X) bf16 band
// matrices (mirror folds inside the band, half-supports hz, hy, hx);
// o: (Z, Y, X) float32. The roundings are those of
// `ops.separable.conv_lowrank_folded`.
//
// Replaces spim_registration_tpu/ops/pallas/lowrank_conv.py
// `_zfused_kernel` (called from `conv_lowrank_folded_zfused`). The Pallas
// kernel DMAs a (tz + 2 hz)-row window of the whole (Y, X) cross-section
// into VMEM once per z block and reuses it across the rank axis (a
// sequential grid dimension accumulating into the VMEM output). One 256^2
// bf16 row alone is 128 KB, so on Hopper the window is tiled in y and x
// too, and the rank loop runs INSIDE the block: no atomics, a
// deterministic sum, `o` written once.
//
// What bounds it on an H100: tensor-core operations. Per voxel and rank
// the band products need 2 (2hz+1 + 2hy+1 + 2hx+1) flops (~42 GFLOP at
// 256^3, rank 22 and half-supports 9: 0.042 ms at 989 TFLOP/s) against
// 33.5 MB of bf16 volume read and 67 MB of f32 output written (0.030 ms).
// The design:
//   one block of 16 warps per output tile of at most 16 x 16 x 16 voxels.
//   Per axis the tile's rows reach the columns [t0 - h, t0 + t + h) of
//   their band matrix (mirror folds stay inside); the block holds that
//   window of the volume, W_z x W_y x W_x with each W a multiple of 16
//   (the MMA depth) and the window clamped into the axis as at
//   lowrank_conv.py:446, in shared memory for the whole rank loop (loaded
//   with 16 loads in flight per thread), so the volume is read once per
//   tile and neither `a` nor `b` ever reaches device memory. Per rank:
//   1. the band rows of the tile (16 x W per axis) are in shared memory,
//      double-buffered: the next rank's rows are fetched into registers
//      while this rank computes;
//   2. z pass: A (16 z x W_y x W_x) = Mz_band @ V, bf16 wmma 16x16x16 with
//      f32 fragments (two independent ones per warp at a time), each
//      rounded to bf16 in registers and stored;
//   3. per warp, for its z row: the y pass B (16 y x W_x) = My_band @
//      A[z], rounded alike into the warp's own tile, then the x pass
//      acc += B @ Mx_band^T into an f32 fragment that lives in registers
//      across the rank loop (no barrier between the two passes).
// The tile's real extent per axis is t = min(16, W - 2h) (14 at h = 9,
// W = 32); rows past it are computed on zero band rows and not stored.
// An axis no longer than its window is taken whole (tile 16, window from
// 0, zero-filled past the end). The kernel is latency-bound (one block
// of 16 warps an SM, two barriers a rank): no TMA/wgmma and no
// warp-specialised pipeline yet. A plan whose shared memory does not fit
// raises (`spim_zfused_smem` returns -1); the rank is never cut.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 16;       // compute rows per axis (wmma 16x16x16)
constexpr int THREADS = 512;   // 16 warps: one z row each
constexpr int WARPS = THREADS / 32;
constexpr int ZPW = TILE / WARPS;  // z rows (and band rows) per warp
constexpr int PAD = 8;         // bf16 row padding (16 bytes): bank stagger
constexpr int MAXC = 4;        // band columns per lane: windows <= 128
constexpr int MAX_SMEM = 232448;

struct Axis {
  int n;      // axis length
  int h;      // band half-support
  int w;      // window (multiple of 16)
  int t;      // real output rows per tile
  int tiles;  // tiles along the axis
};

struct Plan {
  Axis z, y, x;
  int ldv, lda, ldb, ldz, ldy, ldx;
  int off_a, off_b, off_bz, off_by, off_bx, band_bytes, bytes;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int align128(int v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline Axis make_axis(int n, int h) {
  Axis a;
  a.n = n;
  a.h = h;
  const int w = round16(2 * h + 8);
  if (n <= w) {          // the whole axis is one window
    a.w = round16(n);
    a.t = TILE;
  } else {
    a.w = w;
    a.t = w - 2 * h < TILE ? w - 2 * h : TILE;
  }
  a.tiles = (n + a.t - 1) / a.t;
  return a;
}

__host__ __device__ inline Plan make_plan(int Z, int Y, int X, int hz,
                                          int hy, int hx) {
  Plan p;
  p.z = make_axis(Z, hz);
  p.y = make_axis(Y, hy);
  p.x = make_axis(X, hx);
  p.ldv = p.y.w * p.x.w + PAD;
  p.lda = p.x.w + PAD;
  p.ldb = p.x.w + PAD;
  p.ldz = p.z.w + PAD;
  p.ldy = p.y.w + PAD;
  p.ldx = p.x.w + PAD;
  int off = align128(p.z.w * p.ldv * 2);                     // V
  p.off_a = off;
  off = align128(off + TILE * p.y.w * p.lda * 2);            // A
  p.off_b = off;
  off = align128(off + WARPS * TILE * p.ldb * 2);            // B per warp
  // the three band tiles, twice (double buffer)
  p.off_bz = off;
  p.off_by = p.off_bz + align128(TILE * p.ldz * 2);
  p.off_bx = p.off_by + align128(TILE * p.ldy * 2);
  p.band_bytes = p.off_bx + align128(TILE * p.ldx * 2) - off;
  p.bytes = off + 2 * p.band_bytes;
  return p;
}

// First window column of the tile whose rows start at t0.
__device__ inline int win_start(const Axis& a, int t0) {
  if (a.n <= a.w) return 0;
  int s = t0 - a.h;
  if (s < 0) s = 0;
  if (s > a.n - a.w) s = a.n - a.w;
  return s;
}

// Band rows [t0, t0 + t) x window columns [s, s + w) of M[r] (n x n),
// fetched into registers (ZPW rows and MAXC columns per thread); zero
// outside the tile's rows and past the axis.
struct BandRegs {
  __nv_bfloat16 v[ZPW][MAXC];
};

__device__ inline void fetch_band(BandRegs& b,
                                  const __nv_bfloat16* __restrict__ m,
                                  const Axis& a, int t0, int s, int warp,
                                  int lane) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < ZPW; ++i) {
    const int row = warp + WARPS * i;
    const int gr = t0 + row;
    const bool live = row < a.t && gr < a.n;
    const __nv_bfloat16* src = m + static_cast<long long>(gr) * a.n + s;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int col = lane + 32 * j;
      b.v[i][j] = (live && col < a.w && s + col < a.n) ? src[col] : zero;
    }
  }
}

__device__ inline void put_band(__nv_bfloat16* dst, int ld,
                                const BandRegs& b, const Axis& a, int warp,
                                int lane) {
#pragma unroll
  for (int i = 0; i < ZPW; ++i)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int col = lane + 32 * j;
      if (col < a.w) dst[(warp + WARPS * i) * ld + col] = b.v[i][j];
    }
}

// One warp: its f32 accumulator fragment rounded to bf16 at dst (row
// stride ld). The m16n16k16 f32 accumulator holds, in lane l, element i
// at row l / 4 + 8 ((i / 2) % 2) and column 2 (l % 4) + i % 2 + 8 (i / 4)
// (the two m16n8 tiles of mma.sync); the kernel check against the plain
// chain on the card guards this layout.
__device__ inline void round_store(
    const wmma::fragment<wmma::accumulator, 16, 16, 16, float>& f,
    __nv_bfloat16* dst, int ld, int lane) {
  const int r0 = lane >> 2;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = c0 + 8 * (i >> 2);
    *reinterpret_cast<__nv_bfloat162*>(dst + row * ld + col) =
        __floats2bfloat162_rn(f.x[i], f.x[i + 1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
zfused_kernel(const __nv_bfloat16* __restrict__ vm,
              const __nv_bfloat16* __restrict__ mz,
              const __nv_bfloat16* __restrict__ my,
              const __nv_bfloat16* __restrict__ mx,
              float* __restrict__ out, int R, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* V = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + p.off_a);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  __nv_bfloat16* Bw = reinterpret_cast<__nv_bfloat16*>(smem + p.off_b) +
                      warp * TILE * p.ldb;

  const int Z = p.z.n, Y = p.y.n, X = p.x.n;
  const int WZ = p.z.w, WY = p.y.w, WX = p.x.w;
  const int z0 = blockIdx.z * p.z.t;
  const int y0 = blockIdx.y * p.y.t;
  const int x0 = blockIdx.x * p.x.t;
  const int sz = win_start(p.z, z0);
  const int sy = win_start(p.y, y0);
  const int sx = win_start(p.x, x0);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // the volume window, once for all ranks (zero past the volume), 16
  // loads in flight per thread
  {
    const int total = WZ * WY * WX;
    for (int base = 0; base < total; base += THREADS * 16) {
      __nv_bfloat16 v[16];
      int at[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = base + u * THREADS + tid;
        const int x = i % WX;
        const int t = i / WX;
        const int y = t % WY;
        const int z = t / WY;
        const int gz = sz + z, gy = sy + y, gx = sx + x;
        at[u] = i < total ? z * p.ldv + y * WX + x : -1;
        v[u] = (i < total && gz < Z && gy < Y && gx < X)
                   ? vm[(static_cast<long long>(gz) * Y + gy) * X + gx]
                   : zero;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (at[u] >= 0) V[at[u]] = v[u];
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[ZPW];
#pragma unroll
  for (int j = 0; j < ZPW; ++j) wmma::fill_fragment(acc[j], 0.0f);

  BandRegs bz, by, bx;
  const __nv_bfloat16* mz_r = mz;
  const __nv_bfloat16* my_r = my;
  const __nv_bfloat16* mx_r = mx;
  fetch_band(bz, mz_r, p.z, z0, sz, warp, lane);
  fetch_band(by, my_r, p.y, y0, sy, warp, lane);
  fetch_band(bx, mx_r, p.x, x0, sx, warp, lane);
  put_band(reinterpret_cast<__nv_bfloat16*>(smem + p.off_bz), p.ldz, bz, p.z,
           warp, lane);
  put_band(reinterpret_cast<__nv_bfloat16*>(smem + p.off_by), p.ldy, by, p.y,
           warp, lane);
  put_band(reinterpret_cast<__nv_bfloat16*>(smem + p.off_bx), p.ldx, bx, p.x,
           warp, lane);
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    const int buf = (r & 1) * p.band_bytes;
    const __nv_bfloat16* BZ =
        reinterpret_cast<const __nv_bfloat16*>(smem + p.off_bz + buf);
    const __nv_bfloat16* BY =
        reinterpret_cast<const __nv_bfloat16*>(smem + p.off_by + buf);
    const __nv_bfloat16* BX =
        reinterpret_cast<const __nv_bfloat16*>(smem + p.off_bx + buf);
    const bool next = r + 1 < R;
    if (next) {   // the next rank's band rows, in flight during this rank
      mz_r += static_cast<long long>(Z) * Z;
      my_r += static_cast<long long>(Y) * Y;
      mx_r += static_cast<long long>(X) * X;
      fetch_band(bz, mz_r, p.z, z0, sz, warp, lane);
      fetch_band(by, my_r, p.y, y0, sy, warp, lane);
      fetch_band(bx, mx_r, p.x, x0, sx, warp, lane);
    }

    // z pass: A[z][y][x] over the (y, x) window, 16 columns per task,
    // two independent tasks per warp at a time
    const int nchunks = WY * WX / 16;
    for (int c = warp; c < nchunks; c += 2 * WARPS) {
      const int c2 = c + WARPS;
      const bool two = c2 < nchunks;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> f0, f1;
      wmma::fill_fragment(f0, 0.0f);
      wmma::fill_fragment(f1, 0.0f);
      for (int k = 0; k < WZ; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb0, fb1;
        wmma::load_matrix_sync(fa, BZ + k, p.ldz);
        wmma::load_matrix_sync(fb0, V + k * p.ldv + c * 16, p.ldv);
        if (two) wmma::load_matrix_sync(fb1, V + k * p.ldv + c2 * 16, p.ldv);
        wmma::mma_sync(f0, fa, fb0, f0);
        if (two) wmma::mma_sync(f1, fa, fb1, f1);
      }
      const int yy = c * 16 / WX;
      round_store(f0, A + yy * p.lda + (c * 16 - yy * WX), WY * p.lda,
                  lane);
      if (two) {
        const int y2 = c2 * 16 / WX;
        round_store(f1, A + y2 * p.lda + (c2 * 16 - y2 * WX), WY * p.lda,
                    lane);
      }
    }
    __syncthreads();

    // y pass then x pass, per warp for its z rows (warp, warp + WARPS, ..)
    const int xcn = WX / 16;
#pragma unroll
    for (int j = 0; j < ZPW; ++j) {
      const int zt = warp + WARPS * j;
      for (int xc = 0; xc < xcn; xc += 2) {
        const bool two = xc + 1 < xcn;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f0, f1;
        wmma::fill_fragment(f0, 0.0f);
        wmma::fill_fragment(f1, 0.0f);
        for (int k = 0; k < WY; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb0, fb1;
          const __nv_bfloat16* ak = A + (zt * WY + k) * p.lda + xc * 16;
          wmma::load_matrix_sync(fa, BY + k, p.ldy);
          wmma::load_matrix_sync(fb0, ak, p.lda);
          if (two) wmma::load_matrix_sync(fb1, ak + 16, p.lda);
          wmma::mma_sync(f0, fa, fb0, f0);
          if (two) wmma::mma_sync(f1, fa, fb1, f1);
        }
        round_store(f0, Bw + xc * 16, p.ldb, lane);
        if (two) round_store(f1, Bw + xc * 16 + 16, p.ldb, lane);
      }
      __syncwarp();
      for (int k = 0; k < WX; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        // the band as a column-major K x N operand: (k, n) at n * ldx + k
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Bw + k, p.ldb);
        wmma::load_matrix_sync(fb, BX + k, p.ldx);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
      __syncwarp();
    }
    if (next) {   // into the other buffer, last read in the previous rank
      const int nb = p.band_bytes - buf;
      put_band(reinterpret_cast<__nv_bfloat16*>(smem + p.off_bz + nb), p.ldz,
               bz, p.z, warp, lane);
      put_band(reinterpret_cast<__nv_bfloat16*>(smem + p.off_by + nb), p.ldy,
               by, p.y, warp, lane);
      put_band(reinterpret_cast<__nv_bfloat16*>(smem + p.off_bx + nb), p.ldx,
               bx, p.x, warp, lane);
    }
    __syncthreads();
  }

  // epilogue: the tile's real rows, written once in f32 straight from the
  // fragments (the accumulator layout of round_store)
#pragma unroll
  for (int j = 0; j < ZPW; ++j) {
    const int zt = warp + WARPS * j;
    const int gz = z0 + zt;
    if (zt >= p.z.t || gz >= Z) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int yo = (lane >> 2) + 8 * ((i >> 1) & 1);
      const int xo = 2 * (lane & 3) + (i & 1) + 8 * (i >> 2);
      const int gy = y0 + yo;
      const int gx = x0 + xo;
      if (yo < p.y.t && xo < p.x.t && gy < Y && gx < X)
        out[(static_cast<long long>(gz) * Y + gy) * X + gx] = acc[j].x[i];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of the kernel's plan for this volume and these
// band half-supports, or -1 when it cannot take them.
int spim_zfused_smem(int Z, int Y, int X, int hz, int hy, int hx) {
  if (Z < 1 || Y < 1 || X < 1 || hz < 0 || hy < 0 || hx < 0) return -1;
  const Plan p = make_plan(Z, Y, X, hz, hy, hx);
  if (p.z.tiles > 65535 || p.y.tiles > 65535) return -1;
  if (p.z.w > 32 * MAXC || p.y.w > 32 * MAXC || p.x.w > 32 * MAXC) return -1;
  return p.bytes <= MAX_SMEM ? p.bytes : -1;
}

// Returns a cudaError_t.
int spim_zfused(const void* vm, const void* mz, const void* my,
                const void* mx, void* out, int R, int Z, int Y, int X,
                int hz, int hy, int hx, void* stream) {
  const int bytes = spim_zfused_smem(Z, Y, X, hz, hy, hx);
  if (bytes < 0 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(Z, Y, X, hz, hy, hx);
  cudaError_t e = cudaFuncSetAttribute(
      zfused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(p.x.tiles, p.y.tiles, p.z.tiles);
  zfused_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(vm),
      static_cast<const __nv_bfloat16*>(mz),
      static_cast<const __nv_bfloat16*>(my),
      static_cast<const __nv_bfloat16*>(mx), static_cast<float*>(out), R, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
