// Fused y and x passes of the lowrank (folded-matrix) convolution, with
// the rank sum:
//
//     o[z, :, :] = sum_r  round(My[r] @ a[r, z]) @ Mx[r]^T
//
// a: (R, Z, Y, X), My: (R, Yo, Y), Mx: (R, Xo, X), all in the matrix
// dtype; o: (Z, Yo, Xo) float32. The y product accumulates in f32 and is
// rounded once (to nearest even) to the matrix dtype; the x product and
// the rank sum stay in f32; `o` is written once, without atomics.
//
// Replaces spim_registration_tpu/ops/pallas/lowrank_conv.py
// `_sl_rows_kernel` (dense and band-windowed). On the TPU the rank axis
// is a sequential grid dimension that accumulates into VMEM; on Hopper
// blocks run in no order, so the rank loop runs INSIDE the block and the
// sum over ranks is deterministic.
//
// What bounds it on an H100: bytes. At rank 22 and 256^3 the kernel must
// read `a` (738 MB bf16) and the bands of My and Mx, and write `o` (67 MB
// f32): 0.2405 ms at 3.35 TB/s. The folded matrices are band matrices
// (half-support 9 on the main path): the products that matter are
// ~2.1e10 flop, while dense products would be ~3.8e11 flop (0.38 ms at
// 989 TFLOP/s), above the byte bound.
// Tiles re-read from L2 are what this design trades against that bound:
//
// 1. Band windows on y and x. A block owns one 64-row Yo tile and one
//    64-column Xo tile of up to four z-slices, one warpgroup a slice. Each
//    tile contracts only its y window of `a` (the `ywin` table,
//    `band_blocks` in ops/kernels/lowrank_conv.py) and produces only the x
//    window of the y product that its Xo tile reads (`xwin`): 96 x 96 of
//    `a` a tile on the main path instead of 256 x 256. A window table of
//    [0, Y) / [0, X) on every tile is the dense form.
// 2. The rank loop is inside the block, with each slice's 64 x 64 f32
//    output accumulators in registers across all ranks. Each rank stages
//    in shared memory My's 64 x ky band tile and Mx's 64 x kx band tile
//    (never the whole Mx[r]), shared by the block's slices, and one ky x kx
//    window of `a[r, z]` a slice: 24 KB of L2 reads a tile and rank
//    instead of 42 KB with one slice a block.
// 3. One thread loads rank r+1's tiles by TMA (32-column boxes, 64-byte
//    swizzle, an mbarrier a slot) into the other slot of a two-slot ring
//    while every warpgroup runs rank r's products; one block barrier a
//    rank. Boxes with 16-byte rows (the no-swizzle core-matrix layout)
//    moved tiles at about half the rate on the card. Windows wider than
//    a block holds are walked in pieces through the same ring (below).
// 4. The products are wgmma (bf16 in, f32 accumulators in registers) from
//    the 64-byte swizzled layouts: stage 1 (My tile @ a window, m64n32k16)
//    with A K-major and B MN-major, in 32-column chunks of the x window;
//    stage 2 (b @ Mx tile^T, m64n64k16) with B K-major. Each chunk's
//    accumulators are rounded to bf16 in registers and fed straight to
//    stage 2 as its register A operand: the m64nNk16 accumulator layout is
//    the A fragment layout, so the y product never goes through shared
//    memory.
// 5. Blocks are ordered Xo tile, Yo tile, z-group: the 16 tiles of one
//    z-group run side by side and read the shared window rows of `a` from
//    L2, so `a` leaves HBM about once.
//
// Pieces: the ring's unit is a piece of a rank's windows, kp y columns
// by xp x columns (multiples of the 32-column slab; the plan,
// `spim_sl_rows_smem`, is mirrored by `sl_rows_plan` in
// ops/kernels/lowrank_conv.py and checked against it at load). On the
// main path's 96-column band windows a piece is the whole window, so a
// unit is a rank. A y window wider than kp (<= 256, the TMA box's rows)
// is cut into pieces of kp, each with one 32-column x chunk, and stage 1
// accumulates across them before the rounding; an x window wider than xp
// is cut into pieces of xp. So every window is taken: band windows of any
// width and dense planes of any Y and X. Z <= 65535. A TMA box may run
// past an axis (zero-filled). Inputs whose rows are not a multiple of 16
// bytes take every thread's cp.async copies into the same layout
// (element-wise) instead of TMA.
//
// The float32 matrices take a plain SIMT kernel (8 Yo rows and 512 Xo
// columns a block, the y product in 512-column pieces of x, both in
// shared memory, windows not used): not the main path, kept exact.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;            // Yo rows and Xo columns per block
constexpr int XC = 32;            // x columns per stage-1 chunk and per
                                  // 64-byte swizzle slab (y and x)
constexpr int WG = 128;           // threads of a warpgroup, one per z-slice
constexpr int MAX_TZ = 4;         // z-slices (warpgroups) per block
constexpr int MAX_KP = 256;       // y columns of a piece: a TMA box's rows
constexpr int F32_THREADS = 256;
constexpr int TYF = 8;            // Yo rows per block of the f32 kernel
constexpr int TXF = 512;          // Xo columns per block, and x columns of
                                  // a piece of the y product, f32 kernel
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory, sm_90
constexpr int ALIGN = 1024;       // the swizzle pattern's alignment
constexpr int BARS = 16;          // bytes of the ring's two mbarriers

// bf16 elements of one ring slot: My tile (TM x kp), tz windows of a
// (kp x xp), Mx tile (TM x xp).
__host__ __device__ constexpr long long slot_elems(int kp, int xp, int tz) {
  return static_cast<long long>(TM) * kp +
         static_cast<long long>(tz) * kp * xp +
         static_cast<long long>(TM) * xp;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// A TMA tile load into shared memory, completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(bar) : "memory");
}

// One 16-byte piece of a row: its first `left` elements from src (none
// when left <= 0), zeros after. `vec`: src is 16-byte aligned, so the copy
// is asynchronous (`safe` is a valid address for the empty copies);
// otherwise synchronous and element-wise.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int left,
                                      bool vec, const void* safe) {
  if (vec) {
    const int n = left <= 0 ? 0 : (left >= 8 ? 16 : 2 * left);
    cp_async16(dst, n ? static_cast<const void*>(src) : safe, n);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < left ? src[e] : __float2bfloat16(0.0f);
  }
}

// Copies a tile of `rows` (a multiple of 8) rows x `groups` (even) 8-wide
// column groups of a row-major source (row stride `ld`) into shared
// memory; `left(row, group)` is the number of valid elements of the piece
// and `dst(row, group)` its element offset. Thread pairs read 32
// contiguous bytes; with `sw64`'s swizzle the 8 rows that 16 threads
// write land in 8 different 16-byte bank groups, so the stores conflict
// at most two ways.
template <typename Dst, typename Left>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* base,
                                           const __nv_bfloat16* src,
                                           long long ld, int rows,
                                           int groups, bool vec,
                                           const void* safe, Dst dst,
                                           Left left) {
  const int pairs = groups >> 1;
  for (int c = threadIdx.x; c < rows * groups; c += blockDim.x) {
    const int rest = c >> 4;
    const int row = (rest / pairs) * 8 + ((c >> 1) & 7);
    const int g = (rest % pairs) * 2 + (c & 1);
    copy8(base + dst(row, g), src + row * ld + g * 8, left(row, g), vec,
          safe);
  }
}

// Element offset of row `row`, 8-wide column group g of a tile whose
// columns are cut into 32-wide slabs of `rows` rows x 64 bytes, the four
// 16-byte chunks of each row XOR-swizzled by (row / 2) % 4: the layout a
// TMA box of 32 columns writes with the 64-byte swizzle, from a
// 1024-byte aligned base.
__device__ __forceinline__ int sw64(int rows, int row, int g) {
  return (g >> 2) * rows * 32 + row * 32 + (((g & 3) ^ ((row >> 1) & 3)) << 3);
}

// wgmma shared-memory descriptor of a 64-byte swizzled operand: start
// address, the byte strides between 32-column slabs along M or N (lbo,
// for MN-major operands) and between 8-row groups (sbo).
__device__ __forceinline__ uint64_t sw64_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma region.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Stage 1: d (=|+=) A (64 x 16, K-major) * B (16 x 32, MN-major), both
// from shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Stage 2: d += A (64 x 16, bf16 fragments in registers) * B (16 x 64,
// K-major in shared memory).
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// PIECES false: every window is one piece (the host's plan says so), so a
// unit is a rank and each chunk's stage-1 accumulators live only in it.
template <bool PIECES>
__global__ void __launch_bounds__(WG * MAX_TZ, 1)
sl_rows_bf16_kernel(const __grid_constant__ CUtensorMap my_map,
                    const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap mx_map,
                    const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ my,
                    const __nv_bfloat16* __restrict__ mx,
                    float* __restrict__ out, const int* __restrict__ ywin,
                    const int* __restrict__ xwin, int R, int Z, int Y, int X,
                    int Yo, int Xo, int kp, int xp, int tz, int use_tma) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(
      smem_raw +
      ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1)));
  const int slot = static_cast<int>(slot_elems(kp, xp, tz));

  const int xt = blockIdx.x;
  const int yt = blockIdx.y;
  const int z0 = blockIdx.z * tz;
  const int zn = min(tz, Z - z0);         // z-slices of this block
  const int wg = threadIdx.x / WG;        // this warpgroup's slice z0 + wg
  const int z = z0 + wg;
  const int y0 = yt * TM;
  const int x0 = xt * TM;
  const int ky0 = ywin[2 * yt];
  const int kyw = ywin[2 * yt + 1] - ky0;
  const int kx0 = xwin[2 * xt];
  const int kxw = xwin[2 * xt + 1] - kx0;
  // The tile's pieces: y in nyp pieces of kp columns, x in nxp pieces of
  // xpb; a y window in pieces takes one 32-column x chunk a piece, so that
  // stage 1's accumulators carry from one y piece to the next.
  const int nyp = PIECES && kyw > kp ? (kyw + kp - 1) / kp : 1;
  const int xpb = PIECES && nyp > 1 ? XC : xp;
  const int nxp = PIECES && kxw > xpb ? (kxw + xpb - 1) / xpb : 1;
  const int units = R * nxp * nyp;        // ring units: y pieces fastest
  const int rows = min(TM, Yo - y0);
  const int cols = min(TM, Xo - x0);
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x % WG) >> 5;  // warp of the warpgroup
  const bool vecY = Y % 8 == 0 && (reinterpret_cast<uintptr_t>(my) & 15) == 0;
  const bool vecX = X % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(mx) & 15) == 0;
  // after the ring: one mbarrier a slot (TMA loads)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * slot);

  // Unit u: rank r, y columns [ky, ky + kw), x columns [kx, kx + xw) (kw
  // and xw 0 for an empty window), and whether it is the tile's first and
  // last y piece.
  struct Piece {
    int r, ky, kw, kx, xw;
    bool first, last;
  };
  auto piece = [&](int u) {
    Piece p{u, ky0, kyw, kx0, kxw, true, true};
    if (!PIECES) return p;
    const int per = nxp * nyp;
    p.r = u / per;
    const int xi = (u - p.r * per) / nyp;
    const int yj = u - p.r * per - xi * nyp;
    p.ky = ky0 + yj * kp;
    p.kw = min(kp, kyw - yj * kp);
    p.kx = kx0 + xi * xpb;
    p.xw = min(xpb, kxw - xi * xpb);
    p.first = yj == 0;
    p.last = yj == nyp - 1;
    return p;
  };

  // Unit u's tiles into ring slot s: My's, the block's zn windows of a,
  // Mx's, each in 32-column slabs of 64-byte rows, swizzled (`sw64`): My
  // and Mx K-major (slabs of y or x, rows of Yo or Xo), the windows of a
  // MN-major (slabs of x, rows of y). By every thread's cp.async copies,
  // which zero everything past a piece's width or the tile's rows...
  auto stage = [&](const Piece& p, int s) {
    __nv_bfloat16* As = smem + s * slot;
    __nv_bfloat16* Bs = As + TM * kp;
    __nv_bfloat16* Ms = Bs + tz * kp * xp;
    const int nky = (p.kw + 15) / 16;
    const int xg = (nky ? (p.xw + XC - 1) / XC : 0) * (XC / 8);
    stage_tile(
        As, my + (static_cast<long long>(p.r) * Yo + y0) * Y + p.ky, Y, TM,
        2 * nky, vecY, my, [](int m, int g) { return sw64(TM, m, g); },
        [&](int m, int g) { return m < rows ? p.kw - g * 8 : 0; });
    for (int h = 0; h < zn; ++h)
      stage_tile(
          Bs + h * kp * xp,
          a + ((static_cast<long long>(p.r) * Z + z0 + h) * Y + p.ky) * X +
              p.kx,
          X, 16 * nky, xg, vecX, a,
          [&](int k, int g) { return sw64(kp, k, g); },
          [&](int k, int g) { return k < p.kw ? p.xw - g * 8 : 0; });
    stage_tile(
        Ms, mx + (static_cast<long long>(p.r) * Xo + x0) * X + p.kx, X, TM,
        xg, vecX, mx, [](int n, int g) { return sw64(TM, n, g); },
        [&](int n, int g) { return n < cols ? p.xw - g * 8 : 0; });
  };
  // ... or by one thread's TMA loads of whole 32-column boxes of the
  // padded piece (`sl_rows_maps`), out-of-bounds elements zero: the
  // band's zeros in My and Mx cancel whatever lies past a window.
  auto load = [&](int u, int s) {
    const Piece p = piece(u);
    if (!use_tma) {
      stage(p, s);
      cp_async_commit();
      return;
    }
    if (threadIdx.x != 0) return;
    __nv_bfloat16* As = smem + s * slot;
    __nv_bfloat16* Bs = As + TM * kp;
    __nv_bfloat16* Ms = Bs + tz * kp * xp;
    const uint32_t bar = smem_addr(bars + s);
    mbar_expect_tx(bar, 2u * (TM * kp + zn * kp * xpb + TM * xpb));
    for (int i = 0; i < kp / XC; ++i)
      tma_load_3d(As + i * TM * XC, &my_map, p.ky + i * XC, y0, p.r, bar);
    for (int h = 0; h < zn; ++h)
      for (int i = 0; i < xpb / XC; ++i)
        tma_load_3d(Bs + h * kp * xp + i * kp * XC, &a_map, p.kx + i * XC,
                    p.ky, p.r * Z + z0 + h, bar);
    for (int i = 0; i < xpb / XC; ++i)
      tma_load_3d(Ms + i * TM * XC, &mx_map, p.kx + i * XC, x0, p.r, bar);
  };
  // Waits until unit u's tiles are in slot s = u % 2 (each slot's k-th
  // load completes its barrier's phase k % 2).
  auto landed = [&](int u, int s) {
    if (use_tma) {
      mbar_wait(smem_addr(bars + s), (u >> 1) & 1);
    } else {
      cp_async_wait_all();
      // this thread's copies, visible to wgmma once all pass the barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float dc[16];  // stage 1's accumulators, carried across y pieces
#pragma unroll
  for (int i = 0; i < 16; ++i) dc[i] = 0.0f;
  uint32_t fa[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) fa[i] = 0u;

  if (use_tma && threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(smem_addr(bars + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load(0, 0);
  for (int u = 0; u < units; ++u) {
    const int s = u & 1;
    landed(u, s);
    // after the barrier, unit u-1's products are done in every warpgroup,
    // so its slot is free for unit u+1
    __syncthreads();
    if (u + 1 < units) load(u + 1, s ^ 1);
    const Piece p = piece(u);
    const int nky = (p.kw + 15) / 16;       // stage-1 16-deep steps
    // 32-column chunks of the x piece (none for an empty y window)
    const int nxc = nky ? (p.xw + XC - 1) / XC : 0;
    const __nv_bfloat16* As = smem + s * slot;
    const __nv_bfloat16* Bs = As + TM * kp + wg * kp * xp;
    const __nv_bfloat16* Ms = As + TM * kp + tz * kp * xp;
    // a warpgroup without a slice (the last z-group) only stages and waits
    for (int c = 0; c < (wg < zn ? nxc : 0); ++c) {
      float dl[16];
      float (&d)[16] = PIECES ? dc : dl;
      // stage 1: d (+)= My piece @ a piece, x columns [32c, 32c + 32): the
      // k-th 16-deep step reads My's slab k / 2 at byte 32 (k % 2) and 16
      // rows of a's slab c; a y piece after the first adds to d
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_operand(d[i]);
      wgmma_fence();
      for (int ks = 0; ks < nky; ++ks)
        wgmma_n32_ss(d,
                     sw64_desc(As + (ks >> 1) * TM * XC + (ks & 1) * 16, 16,
                               512),
                     sw64_desc(Bs + c * kp * XC + ks * 16 * XC, kp * 64,
                               512),
                     p.first ? ks > 0 : 1);
      wgmma_commit();
      // also retires the previous chunk's stage 2, which reads fa
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_operand(d[i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_operand(fa[i]);
      if (!p.last) continue;  // the next y piece adds to d
      // Round once, in registers: the accumulator of columns 16j..16j+15
      // (d[8j .. 8j+7]: rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9)
      // is the A fragment of a 16-deep step.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        fa[4 * j + 0] = pack_bf16(d[8 * j + 0], d[8 * j + 1]);
        fa[4 * j + 1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
        fa[4 * j + 2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
        fa[4 * j + 3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
      }
      // stage 2: acc += b chunk @ Mx tile^T over the chunk's 32 x columns
      // (Mx's slab c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_n64_rs(acc, fa[4 * j], fa[4 * j + 1], fa[4 * j + 2],
                     fa[4 * j + 3],
                     sw64_desc(Ms + c * TM * XC + j * 16, 16, 512));
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_operand(fa[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
    }
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) fence_operand(fa[i]);
  }

  // Epilogue: in warp w, thread (g, t) = (lane / 4, lane % 4) holds
  // columns 8i + 2t, 8i + 2t + 1 of rows 16w + g and 16w + g + 8 in
  // acc[4i .. 4i + 3]; `o` is written once.
  if (wg >= zn) return;
  float* oz = out + (static_cast<long long>(z) * Yo + y0) * Xo + x0;
  const bool vecO = Xo % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const int row = warp * 16 + (lane >> 2);
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h;
      const int cc = 8 * i + col;
      if (rr >= rows) continue;
      float* p = oz + static_cast<long long>(rr) * Xo + cc;
      const float v0 = acc[4 * i + 2 * h];
      const float v1 = acc[4 * i + 2 * h + 1];
      if (vecO && cc + 1 < cols) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        if (cc < cols) p[0] = v0;
        if (cc + 1 < cols) p[1] = v1;
      }
    }
  }
}

__global__ void __launch_bounds__(F32_THREADS)
sl_rows_f32_kernel(const float* __restrict__ a, const float* __restrict__ my,
                   const float* __restrict__ mx, float* __restrict__ out,
                   int R, int Z, int Y, int X, int Yo, int Xo) {
  __shared__ float bF[TYF * TXF];  // the y product, TYF x (a piece of X)
  __shared__ float aF[TYF * TXF];  // the output, TYF x (this block's Xo)
  const int y0 = blockIdx.x * TYF;
  const int xo0 = blockIdx.y * TXF;
  const int xon = min(TXF, Xo - xo0);
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const long long YX = static_cast<long long>(Y) * X;
  for (int c = tid; c < TYF * xon; c += F32_THREADS) aF[c] = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float* arz = a + (static_cast<long long>(r) * Z + z) * YX;
    const float* myr = my + static_cast<long long>(r) * Yo * Y;
    const float* mxr = mx + static_cast<long long>(r) * Xo * X;
    for (int x0 = 0; x0 < X; x0 += TXF) {
      const int xn = min(TXF, X - x0);
      __syncthreads();  // bF of the previous piece fully consumed
      for (int c = tid; c < TYF * xn; c += F32_THREADS) {
        const int i = c / xn;
        const int x = x0 + c % xn;
        float s = 0.0f;
        if (y0 + i < Yo) {
          const float* m = myr + static_cast<long long>(y0 + i) * Y;
          for (int y = 0; y < Y; ++y)
            s = fmaf(m[y], arz[static_cast<long long>(y) * X + x], s);
        }
        bF[c] = s;
      }
      __syncthreads();
      for (int c = tid; c < TYF * xon; c += F32_THREADS) {
        const int i = c / xon;
        const float* m = mxr + static_cast<long long>(xo0 + c % xon) * X + x0;
        float s = 0.0f;
        for (int x = 0; x < xn; ++x) s = fmaf(bF[i * xn + x], m[x], s);
        aF[c] += s;
      }
    }
  }
  __syncthreads();
  float* oz = out + static_cast<long long>(z) * Yo * Xo + xo0;
  for (int c = tid; c < TYF * xon; c += F32_THREADS) {
    const int i = c / xon;
    if (y0 + i < Yo)
      oz[static_cast<long long>(y0 + i) * Xo + c % xon] = aF[c];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 3-D bf16 tensor map (x, y, z) of a row-major tensor with boxes of 32
// x 64-byte swizzled rows, as `sw64` lays them out.
cudaError_t encode_map(CUtensorMap* map, const void* base, int x, int y,
                       long long z, int box_y) {
  static EncodeTiled encode = nullptr;
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
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(x),
                              static_cast<cuuint64_t>(y),
                              static_cast<cuuint64_t>(z)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(x) * 2,
                                 static_cast<cuuint64_t>(x) * y * 2};
  const cuuint32_t box[3] = {XC, static_cast<cuuint32_t>(box_y), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The tensor maps of the TMA loads: My (R, Yo, Y) in boxes of 32 y x 64
// rows, a (R, Z, Y, X) in boxes of 32 x x kp rows, Mx (R, Xo, X) in boxes
// of 32 x x 64 rows. Needs Y % 8 == X % 8 == 0 and 16-byte aligned bases
// (the wrapper's `sl_rows_tma_load`).
cudaError_t sl_rows_maps(CUtensorMap* maps, const void* a, const void* my,
                         const void* mx, int R, int Z, int Y, int X, int Yo,
                         int Xo, int kp) {
  cudaError_t err = encode_map(&maps[0], my, Y, Yo, R, TM);
  if (err == cudaSuccess)
    err = encode_map(&maps[1], a, X, Y, static_cast<long long>(R) * Z, kp);
  if (err == cudaSuccess) err = encode_map(&maps[2], mx, X, Xo, R, TM);
  return err;
}

// Shared-memory limits, once per device and kernel (a host call that
// would otherwise sit in front of every launch).
template <typename K>
cudaError_t allow_smem(K kernel, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// Yo rows and Xo columns of a block (the window tables' tile).
int spim_sl_rows_tile(void) { return TM; }

// Columns of a swizzle slab and stage-1 chunk (both windows pad to it).
int spim_sl_rows_chunk(void) { return XC; }

// Shared-memory bytes of the bf16 kernel with pieces of kp y columns
// (at most MAX_KP) and xp x columns, both multiples of XC, and tz
// z-slices a block; -1 when no block can hold them.
int spim_sl_rows_smem(int kp, int xp, int tz) {
  if (kp < XC || kp % XC || kp > MAX_KP || xp < XC || xp % XC || tz < 1 ||
      tz > MAX_TZ)
    return -1;
  const long long bytes = ALIGN + BARS + 2LL * 2 * slot_elems(kp, xp, tz);
  return bytes <= MAX_SMEM ? static_cast<int>(bytes) : -1;
}

// dtype: 0 = bfloat16, 1 = float32. `win` (on the device) holds the
// (k0, k1) int32 pairs of the y windows, one per 64-row tile of Yo, then
// those of the x windows, one per 64-column tile of Xo; k0 % 16 == 0.
// kp / xp / tz: the bf16 plan (`sl_rows_plan`); pieces: 0 when every
// window is one piece (at most kp by xp), else 1; tma: 1 to load by TMA
// (`sl_rows_tma_load`). The float32 kernel ignores the windows and the
// plan. Returns a cudaError_t.
int spim_sl_rows(const void* a, const void* my, const void* mx, void* out,
                 const int* win, int R, int Z, int Y, int X, int Yo, int Xo,
                 int dtype, int kp, int xp, int tz, int pieces, int tma,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || Z <= 0 || Z > 65535 || Y <= 0 || X <= 0 || Yo <= 0 ||
      Xo <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    static bool ready[2][64] = {};
    const int bytes = spim_sl_rows_smem(kp, xp, tz);
    if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel =
        pieces ? sl_rows_bf16_kernel<true> : sl_rows_bf16_kernel<false>;
    cudaError_t err = allow_smem(kernel, ready[pieces ? 1 : 0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    CUtensorMap maps[3] = {};
    if (tma) {
      err = sl_rows_maps(maps, a, my, mx, R, Z, Y, X, Yo, Xo, kp);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int nyt = (Yo + TM - 1) / TM;
    // Xo tiles fastest: the tiles of one z-group run side by side
    dim3 grid((Xo + TM - 1) / TM, nyt, (Z + tz - 1) / tz);
    kernel<<<grid, WG * tz, bytes, s>>>(
        maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(my),
        static_cast<const __nv_bfloat16*>(mx), static_cast<float*>(out), win,
        win + 2 * nyt, R, Z, Y, X, Yo, Xo, kp, xp, tz, tma);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    dim3 grid((Yo + TYF - 1) / TYF, (Xo + TXF - 1) / TXF, Z);
    sl_rows_f32_kernel<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(my),
        static_cast<const float*>(mx), static_cast<float*>(out), R, Z, Y, X,
        Yo, Xo);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
