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
// What bounds it on an H100: bytes, and almost all of them are the output.
// At 256^3 and rank 22 the kernel writes `a`, R*N*Y*X bf16 = 738 MB, reads
// vm (34 MB) and Mz (3 MB): 0.23 ms at 3.35 TB/s, while the window
// products are ~0.065 TFLOP. So the design keeps the write stream busy
// and moves everything else off its path. One warpgroup (128 threads) a
// block; a block owns one 64-row tile and `ct` TN-column tiles:
//
// 1. The rank loop is inside the block. The block loads its volume
//    windows vm[k0:k1, j0:j0+ct*TN] into shared memory once and reuses
//    them for all R ranks, so vm is read from L2 once per tile instead of
//    once per (rank, tile); with ct > 1 each rank's matrix tile serves ct
//    column tiles, which halves the L2 reads of Mz at ct = 2.
// 2. The matrix tile of rank r+1, Mz[r+1, n0:n0+64, k0:k1], is fetched
//    with cp.async 16-byte copies into the other slot of a two-slot ring
//    while rank r's products run. The whole window (<= 560 deep) is in
//    shared memory before a rank's products start, so there is one block
//    barrier per (rank, column tile) step and none inside the contraction.
// 3. The products are wgmma m64nTNk16 (bf16 in, f32 accumulators in
//    registers), read straight from shared memory in the no-swizzle
//    core-matrix layouts the copies write: the matrix tile K-major, the
//    volume window MN-major (transposed operand), so neither is shuffled.
//    They run asynchronously while the threads move the previous step's
//    tile out.
// 4. The epilogue rounds the accumulators to bf16 in registers (the
//    wgmma accumulator layout is the PTX ISA's m64nNk16 fragment) and
//    stages them in one of two bf16 output tiles, 128-byte swizzled so the
//    staging stores do not conflict. One thread sends each staged tile out
//    with a TMA tensor store (a 3-D map of `a`, which clips the ragged N
//    and J edges), awaited only before that buffer is staged again: the
//    output leaves through the TMA engine, not through the threads' load
//    and store pipe, and overlaps the next step's products and copies.
//    A J that is not a multiple of 8 (or an unaligned output) has no
//    tensor map; its tiles go out through masked per-thread stores.
//
// TN (128 or 64) is a template parameter; TN and ct are picked on the
// host from the widest window so that a block fits shared memory, two to
// an SM where they can (`zpass_plan` in ops/kernels/lowrank_conv.py).
// The copies zero-fill past ragged N, J and window edges. Mz is read at a
// row stride `ldm` of its own, a multiple of 8 elements from a 16-byte
// aligned base, so every matrix-tile row starts on 16 bytes whatever P
// is: where P % 8 != 0 (a band matrix over a slab's halo rows has P = n +
// taps - 1, P % 8 == 2 at 19 taps) the wrapper hands over a copy with
// padded rows (`zpass_mz_rows` in ops/kernels/lowrank_conv.py).
// Volume rows (J) that are not 16-byte aligned take synchronous
// element-wise copies inside the same kernel.
//
// The float32 matrices (lowrank_dtype="float32") take a plain SIMT kernel
// with one thread per output element (any R * N): not the main path, kept
// exact.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;            // output rows per block == window-table tile
constexpr int THREADS = 128;      // one warpgroup
constexpr int F32_THREADS = 256;
constexpr int HALF = 64;          // columns of one swizzled TMA box (128 B)
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory, sm_90
constexpr int MAX_CT = 2;         // column tiles per block

// Shared-memory bytes of one block: 1 KB to align the swizzled output
// tiles, two output tiles (TM x tn), ct volume windows (kpad x tn) and the
// two-slot matrix ring (TM x kpad each), all bf16.
__host__ __device__ constexpr int smem_bytes(int tn, int kpad, int ct) {
  return 1024 + 2 * (2 * TM * tn + ct * kpad * tn + 2 * TM * kpad);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy reading `bytes` (0..16) of src; the rest is zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One 16-byte piece of a row: its first `left` elements from src (none
// when left <= 0), zeros after. `vec`: src is 16-byte aligned, so the copy
// is asynchronous (committed by the caller; `safe` is a valid address for
// the empty copies); otherwise synchronous and element-wise.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src,
                                      long long left, bool vec,
                                      const void* safe) {
  if (vec) {
    const int n = left <= 0 ? 0 : (left >= 8 ? 16 : 2 * static_cast<int>(left));
    cp_async16(dst, n ? static_cast<const void*>(src) : safe, n);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < left ? src[e] : __float2bfloat16(0.0f);
  }
}

// wgmma shared-memory descriptor, no swizzle: start address, the byte
// stride between core matrices along K (lbo) and along M or N (sbo).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d += A (64 x 16, K-major) * B (16 x N, MN-major), both from shared-memory
// descriptors, f32 accumulators in the m64nNk16 fragment layout.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int TN>
__device__ __forceinline__ void wgmma(float (&d)[TN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (TN == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n64(d, da, db);
}

// Byte offset of element (row, col) in a staged output tile: TN / 64
// boxes of 64 rows x 128 B, 16-byte chunks XOR-swizzled by row % 8 (the
// TMA's 128-byte swizzle).
__device__ __forceinline__ int tile_offset(int row, int col) {
  return (col / HALF) * (TM * 128) + row * 128 +
         ((((col % HALF) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

template <int TN>
__global__ void __launch_bounds__(THREADS)
zpass_bf16_kernel(const __grid_constant__ CUtensorMap out_map,
                  const __nv_bfloat16* __restrict__ mz,
                  const __nv_bfloat16* __restrict__ vm,
                  __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ win,
                  int R, int N, int ldm, long long J, int kpad, int ct,
                  int use_tma) {
  constexpr int NACC = TN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Cs = smem;                      // 2 tiles of TM x TN
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + 4 * TM * TN);
  __nv_bfloat16* As = Bs + ct * kpad * TN;       // 2 slots of TM x kpad

  const int tile = blockIdx.y;
  const int n0 = tile * TM;
  const long long j0 = static_cast<long long>(blockIdx.x) * ct * TN;
  const int k0 = win[2 * tile];
  const int width = win[2 * tile + 1] - k0;
  const int nk = (width + 15) / 16;              // 16-deep wgmma steps
  const int kg = nk * 2;                         // 8-deep core-matrix groups
  const int rows = min(TM, N - n0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool vecJ = J % 8 == 0 && (reinterpret_cast<uintptr_t>(vm) & 15) == 0;
  const long long mz_rank = static_cast<long long>(N) * ldm;
  const __nv_bfloat16* A0 = mz + static_cast<long long>(n0) * ldm + k0;

  // One rank's matrix tile, K-major core matrices: the 16-byte piece of
  // row m and 8-deep group kb at element ((kb * 8 + m / 8) * 8 + m % 8) * 8,
  // so core matrices step 128 B along M and 1 KB along K.
  auto stage_a = [&](__nv_bfloat16* dst, const __nv_bfloat16* src) {
    for (int c = tid; c < TM * kg; c += THREADS) {
      const int m = c / kg;
      const int kb = c - m * kg;
      copy8(dst + ((kb * 8 + (m >> 3)) * 8 + (m & 7)) * 8,
            src + static_cast<long long>(m) * ldm + kb * 8,
            m < rows ? width - kb * 8 : 0, true, mz);
    }
  };
  // The ct volume windows, MN-major core matrices: the 16-byte piece of
  // row k and 8-column group nb at (((k / 8) * (TN / 8) + nb) * 8 + k % 8) * 8,
  // so core matrices step 128 B along N and TN * 16 B along K. Rank 0's
  // matrix tile joins their group.
  for (int h = 0; h < ct; ++h) {
    const long long jh = j0 + h * TN;
    for (int c = tid; c < nk * 16 * (TN / 8); c += THREADS) {
      const int k = c / (TN / 8);
      const int nb = c % (TN / 8);
      copy8(Bs + h * kpad * TN + (((k >> 3) * (TN / 8) + nb) * 8 + (k & 7)) * 8,
            vm + static_cast<long long>(k0 + k) * J + jh + nb * 8,
            k < width ? J - jh - nb * 8 : 0, vecJ, vm);
    }
  }
  stage_a(As, A0);
  cp_async_commit();
  if (use_tma && tid == 0)
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&out_map)) : "memory");

  // Step s computes rank r = s / ct on column tile h = s % ct.
  float d[NACC];
  for (int s = 0, r = 0, h = 0; s <= R * ct; ++s) {
    if (h == 0) cp_async_wait_all();
    if (use_tma && tid == 0)  // step s-2's tile has left buffer s & 1
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    // This thread's copies and staging stores, visible to the async proxy
    // (wgmma, TMA) once every thread passes the barrier. After it: rank
    // r's tile has landed, step s-1's products are done (at h == 0, rank
    // r-1's ring slot is free) and its tile is staged; buffer s & 1 is
    // free.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (h == 0 && r + 1 < R) {  // rank r+1 into rank r-1's slot
      stage_a(As + ((r + 1) & 1) * TM * kpad, A0 + (r + 1) * mz_rank);
      cp_async_commit();
    }
    if (s < R * ct) {  // start step s's products; they run asynchronously
#pragma unroll
      for (int i = 0; i < NACC; ++i) d[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_operand(d[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const __nv_bfloat16* Ab = As + (r & 1) * TM * kpad;
      const __nv_bfloat16* Bb = Bs + h * kpad * TN;
      for (int ks = 0; ks < nk; ++ks)
        wgmma<TN>(d, smem_desc(Ab + ks * 1024, 1024, 128),
                  smem_desc(Bb + ks * 16 * TN, TN * 16, 128));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_operand(d[i]);
    }
    if (s > 0) {  // step s-1's tile out
      const int rp = (s - 1) / ct;
      const long long jp = j0 + (s - 1 - rp * ct) * TN;
      const unsigned char* C = Cs + ((s - 1) & 1) * (2 * TM * TN);
      if (use_tma) {
        if (tid == 0) {
          for (int b = 0; b < TN / HALF; ++b)
            asm volatile(
                "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
                " [%0, {%2, %3, %4}], [%1];\n"
                :: "l"(reinterpret_cast<uint64_t>(&out_map)),
                   "r"(smem_addr(C + b * TM * 128)),
                   "r"(static_cast<int>(jp) + b * HALF), "r"(n0), "r"(rp)
                : "memory");
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      } else {
        __nv_bfloat16* O = out + (static_cast<long long>(rp) * N + n0) * J + jp;
        for (int c = tid; c < rows * TN; c += THREADS) {
          const int row = c / TN;
          const int col = c % TN;
          if (jp + col < J)
            O[static_cast<long long>(row) * J + col] =
                *reinterpret_cast<const __nv_bfloat16*>(C + tile_offset(row, col));
        }
      }
    }
    if (s == R * ct) break;

    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < NACC; ++i) fence_operand(d[i]);
    // Round in registers and stage: in warp w, thread (g, t) = (lane / 4,
    // lane % 4) holds columns 8i + 2t, 8i + 2t + 1 of rows 16w + g and
    // 16w + g + 8 in d[4i .. 4i + 3].
    unsigned char* C = Cs + (s & 1) * (2 * TM * TN);
    const int row = warp * 16 + (lane >> 2);
    const int col = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(C + tile_offset(row, 8 * i + col)) =
          __floats2bfloat162_rn(d[4 * i], d[4 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(C + tile_offset(row + 8, 8 * i + col)) =
          __floats2bfloat162_rn(d[4 * i + 2], d[4 * i + 3]);
    }
    if (++h == ct) {
      h = 0;
      ++r;
    }
  }
  if (use_tma && tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One thread per output element; blockIdx.y strides over the R * N rows
// (more than the grid's 65535 take several rows a block).
__global__ void __launch_bounds__(F32_THREADS)
zpass_f32_kernel(const float* __restrict__ mz, const float* __restrict__ vm,
                 float* __restrict__ out, const int* __restrict__ win,
                 int R, int N, int ldm, long long J) {
  const long long j = static_cast<long long>(blockIdx.x) * F32_THREADS +
                      threadIdx.x;
  if (j >= J) return;
  for (int rn = blockIdx.y; rn < R * N; rn += gridDim.y) {
    const int tile = (rn % N) / TM;
    const float* row = mz + static_cast<long long>(rn) * ldm;
    float acc = 0.0f;
    for (int k = win[2 * tile]; k < win[2 * tile + 1]; ++k)
      acc = fmaf(row[k], vm[static_cast<long long>(k) * J + j], acc);
    out[static_cast<long long>(rn) * J + j] = acc;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The 3-D tensor map (x: J, y: N, z: R) of the output `a` with 64 x 64
// boxes in the 128-byte swizzle. Errors: cudaErrorInvalidValue when J or
// the address does not allow one (J % 8 != 0, unaligned) or
// cuTensorMapEncodeTiled refuses it, cudaErrorSymbolNotFound when the
// driver has no cuTensorMapEncodeTiled.
cudaError_t out_tensor_map(CUtensorMap* map, void* out, int R, int N,
                           long long J) {
  static EncodeTiled encode = nullptr;
  if (J % 8 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(J),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(J) * 2,
                                 static_cast<cuuint64_t>(J) * N * 2};
  const cuuint32_t box[3] = {HALF, TM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int TN>
int launch_bf16(const void* mz, const void* vm, void* out, const int* win,
                int R, int N, int ldm, long long J, int kpad, int ct,
                int use_tma, cudaStream_t s) {
  // The shared-memory limits, once per device (a host call that would
  // otherwise sit in front of every launch).
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(zpass_bf16_kernel<TN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          zpass_bf16_kernel<TN>, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) ready[dev] = true;
  }
  const int bytes = smem_bytes(TN, kpad, ct);
  CUtensorMap map = {};
  if (use_tma) {
    err = out_tensor_map(&map, out, R, N, J);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>((J + ct * TN - 1) / (ct * TN)),
            static_cast<unsigned>((N + TM - 1) / TM));
  zpass_bf16_kernel<TN><<<grid, THREADS, bytes, s>>>(
      map, static_cast<const __nv_bfloat16*>(mz),
      static_cast<const __nv_bfloat16*>(vm),
      static_cast<__nv_bfloat16*>(out), win, R, N, ldm, J, kpad, ct, use_tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of the output per window-table entry (the band table's tile).
int spim_zpass_tile_rows(void) { return TM; }

// Shared-memory bytes of the bf16 kernel with TN = tn columns, ct column
// tiles a block and windows padded to kpad (a multiple of 16) rows; -1
// when no instance takes them.
int spim_zpass_smem(int tn, int kpad, int ct) {
  if ((tn != 128 && tn != 64) || kpad < 16 || kpad % 16 || ct < 1 ||
      ct > MAX_CT)
    return -1;
  const int bytes = smem_bytes(tn, kpad, ct);
  return bytes <= MAX_SMEM ? bytes : -1;
}

// dtype: 0 = bfloat16, 1 = float32. `win` holds (k0, k1) int32 pairs, one
// per TM-row tile of N, on the device; k0 % 16 == 0 and k1 - k0 <= kpad.
// ldm: the row stride of Mz in elements (rank r's rows start at r * N *
// ldm), at least P; for bfloat16 a multiple of 8 with Mz 16-byte aligned.
// tn / kpad / ct: the bf16 kernel's column tile, padded window depth and
// column tiles a block (from `zpass_plan`); tma: 1 to store through a TMA
// tensor map (J % 8 == 0, `out` 16-byte aligned; an error when the map
// cannot be built), 0 for per-thread stores. All four are ignored for
// float32. Returns a cudaError_t.
int spim_zpass(const void* mz, const void* vm, void* out, const int* win,
               int R, int N, int P, int ldm, long long J, int dtype, int tn,
               int kpad, int ct, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ldm < P) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (spim_zpass_smem(tn, kpad, ct) < 0 || ldm % 8 ||
        reinterpret_cast<uintptr_t>(mz) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return tn == 128 ? launch_bf16<128>(mz, vm, out, win, R, N, ldm, J, kpad,
                                        ct, tma, s)
                     : launch_bf16<64>(mz, vm, out, win, R, N, ldm, J, kpad,
                                       ct, tma, s);
  }
  if (dtype == 1) {
    if (R <= 0 || N <= 0 || static_cast<long long>(R) * N > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(static_cast<unsigned>((J + F32_THREADS - 1) / F32_THREADS),
              static_cast<unsigned>(R * N < 65535 ? R * N : 65535));
    zpass_f32_kernel<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(mz), static_cast<const float*>(vm),
        static_cast<float*>(out), win, R, N, ldm, J);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
