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
// What bounds it on an H100. The band products need 2 (2hz+1 + 2hy+1 +
// 2hx+1) flops a voxel and rank (~42 GFLOP at 256^3, rank 22, half-supports
// 9: 0.042 ms at 989 TFLOP/s) against 33.5 MB of volume read and 67 MB of
// output written (0.030 ms). The tensor cores take dense 64-row tiles, so
// a block computes each pass densely over its windows: the z pass over
// the y/x halo of its tile, the y pass over the x halo. The plan
// (`zfused_plan` in ops/kernels/lowrank_conv.py, checked here) at
// half-supports 9 takes an output tile of 14 z x 14 y x 24 x voxels with
// windows of 32 x 32 x 48: 786,432 + 393,216 + 294,912 = 1,474,560 MACs a
// rank, 313 a voxel (57 useful; the first port's 16^3 tiles: 334). At the
// small wgmma widths of these tiles (N = 16 and 24) the operands come from
// shared memory: ~200 KB a tile and rank with the transposed stores
// between the stages, ~1,600 cycles at 128 bytes a cycle against ~720
// for the MACs at the bf16 peak. So shared-memory bandwidth bounds it;
// with one block an SM the waits and the two barriers of a rank are not
// hidden by other work, and every plain shared-memory load or store
// queues behind the wgmma operand reads. On an H100 at 700 W it runs at
// about twice that bound (PERF.md). The design:
//
// 1. One block of four warpgroups a tile loads the tile's volume window
//    into shared memory once: by TMA, one box of 8 x columns x Wz planes x
//    Wy rows a column group (a tensor map over (x, z, y), so z is the
//    box's middle axis), landing in the no-swizzle core-matrix layout of a
//    transposed (MN-major) operand: core matrices of 8 z planes x 8 x
//    columns.
// 2. Per rank, three wgmma stages, all bf16 in, f32 accumulators:
//    z: a^T (positions x 16 z rows) = V^T (64 positions, an 8 y x 8 x
//       patch) @ Mz tile^T (K-major), K = Wz;
//    y: b^T ((x, z) rows x ty) = a^T (MN-major) @ My tile^T, K = Wy;
//    x: o ((z, y) rows x tx) += b (K-major) @ Mx tile^T, K = Wx;
//    each of the first two rounds its accumulators to bf16 in registers
//    and writes them transposed (`stmatrix ... .trans`) straight into the
//    core-matrix layout the next stage reads (`a` padded so that those
//    stores do not conflict); the x stage's accumulators stay in registers
//    across the whole rank loop (each warpgroup owns the same 64-row
//    chunks of o at every rank).
// 3. The band tiles of a rank (Mz 16 x Wz, My ty x Wy, Mx tx x Wx) come by
//    one TMA box each, row-major, into a staging slot on an mbarrier, two
//    ranks ahead; `settle` lays them out as K-major core matrices in a
//    three-slot ring, one 16-byte row a thread. A TMA box must start on 16
//    bytes, so the plan starts every x window on an 8-column group (x
//    tiles of a multiple of 8 from an origin offset); the Mz and My boxes
//    start at the group below their windows, and `settle` shifts them.
// 4. Two block barriers a rank: after the z stage (a complete) and after
//    the y stage (b complete); `a` and `b` are single buffers.
// 5. The main path's windows are a template instance with every count a
//    compile-time constant and the same work in every warpgroup, so that
//    the wgmma of a stage are issued back to back (the x stage's run on
//    into the next rank's z stage). It keeps V^T, the z stage's A operand,
//    in registers for the whole rank loop (one transposed ldmatrix a patch
//    and 16 planes), so the z stage reads only the Mz tile from shared
//    memory. Other plans take an instance with run-time windows, in which
//    the compiler serializes the wgmma (correct, slower).
//
// Windows start at t0 - h, clamped into the axis (an axis no longer than
// its window is one window from 0), so the window covers every band
// column of the tile's rows; rows and columns computed past the tile or
// the axis are finite (zero-filled loads) and never stored. Inputs whose
// rows are not a multiple of 16 bytes (Z, Y or X not a multiple of 8) or
// unaligned take every thread's element copies into the same layouts
// instead of TMA (`zfused_tma_load` on the host). A plan whose shared
// memory does not fit is refused (`spim_zfused_smem` returns -1).
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WGS = 4;            // warpgroups a block
constexpr int THREADS = 128 * WGS;
constexpr int ZN = 16;            // z rows of the z stage (its wgmma N)
constexpr int NY = 16;            // y rows of the y stage (its wgmma N)
constexpr int SLOTS = 3;          // band-tile ring
constexpr int STAGES = 2;         // staging slots of the band boxes
constexpr int MAX_XCH = 2;        // x-stage 64-row chunks a warpgroup
constexpr int MAX_WIN = 256;      // a TMA box's rows
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory, sm_90
constexpr int ALIGN = 1024;
constexpr int BARS = 64;          // bytes of the mbarriers (1 + STAGES)

struct Axis {
  int n;  // axis length
  int h;  // band half-support
  int w;  // window (a multiple of 16)
  int t;  // output rows a tile
  int c;  // origin offset: tile k holds rows [k t - c, k t - c + t)
};

struct Plan {
  Axis z, y, x;
  int R;
};

// bf16 elements of one ring slot: Mz tile (16 x wz), My (16 x wy), Mx
// (nx x wx).
__host__ __device__ constexpr int slot_elems(int wz, int wy, int wx,
                                             int nx) {
  return ZN * wz + NY * wy + nx * wx;
}

// bf16 elements of one staging slot: a rank's Mz, My and Mx boxes, row-
// major, Mz's and My's one 8-column group wider than their windows.
__host__ __device__ constexpr int stage_elems(int wz, int wy, int wx,
                                              int nx) {
  return ZN * (wz + 8) + NY * (wy + 8) + nx * wx;
}

__host__ __device__ constexpr long long smem_bytes(int wz, int wy, int wx,
                                                   int nx) {
  return ALIGN + BARS +
         2LL * (static_cast<long long>(wz) * wy * wx   // V
                + ZN * (wy + 1) * wx                   // a
                + ZN * NY * wx                         // b
                + SLOTS * slot_elems(wz, wy, wx, nx)
                + STAGES * stage_elems(wz, wy, wx, nx));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for phase `parity` of mbarrier `bar`. The loop is the compiler's
// own, and the warp leaves it converged: the wgmma and stmatrix that
// follow are warp-aligned.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  __syncwarp();
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

// This thread's shared-memory writes, visible to the async proxy (wgmma)
// of every thread after the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, the byte
// stride between core matrices along K (lbo) and along M or N (sbo).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma region.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
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

// d (=|+=) A (64 x 16, MN-major if TA else K-major) * B (16 x N, K-major),
// both from shared memory; scale_d 0 overwrites d.
template <int TA>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_n24(float (&d)[12], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, %15, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// d += A (64 x 16, bf16 fragments in registers) * B (16 x 16, K-major in
// shared memory).
__device__ __forceinline__ void wgmma_n16_rs(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Four 8 x 8 bf16 matrices loaded transposed: lane l gives the address of
// stored row l % 8 of matrix l / 8, and receives in r[j] stored rows
// 2 (l % 4), 2 (l % 4) + 1 of column l / 4 of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

template <int N, int TA>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (N == 16)
    wgmma_n16<TA>(d, da, db, scale_d);
  else
    wgmma_n24<TA>(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(d[i]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 fragments stored transposed: lane l gives the address of
// stored row l % 8 of matrix l / 8, which receives column l % 8 of that
// fragment (its 8 rows, 16 contiguous bytes).
__device__ __forceinline__ void stmatrix_x4_trans(void* p, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(smem_addr(p)), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// Columns [8 g + d, 8 g + d + 8) of a bf16 row (16-byte aligned, d in
// [0, 8)) from its two 16-byte groups g and g + 1.
__device__ __forceinline__ uint4 shifted8(const __nv_bfloat16* row, int g,
                                          int d) {
  const uint4 q0 = reinterpret_cast<const uint4*>(row)[g];
  const uint4 q1 = reinterpret_cast<const uint4*>(row)[g + 1];
  const unsigned long long w0 = q0.x | static_cast<unsigned long long>(q0.y)
                                           << 32;
  const unsigned long long w1 = q0.z | static_cast<unsigned long long>(q0.w)
                                           << 32;
  const unsigned long long w2 = q1.x | static_cast<unsigned long long>(q1.y)
                                           << 32;
  const unsigned long long w3 = q1.z | static_cast<unsigned long long>(q1.w)
                                           << 32;
  const int b = 16 * (d & 3);  // bits within the 64-bit word
  const unsigned long long a0 = d < 4 ? w0 : w1, a1 = d < 4 ? w1 : w2,
                           a2 = d < 4 ? w2 : w3;
  const unsigned long long lo = b ? (a0 >> b) | (a1 << (64 - b)) : a0;
  const unsigned long long hi = b ? (a1 >> b) | (a2 << (64 - b)) : a1;
  return make_uint4(static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
                    static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32));
}

// First window column of the tile whose rows start at t0: t0 - h clamped
// into the axis; 0 where the axis is one window.
__device__ __forceinline__ int win_start(const Axis& a, int t0) {
  if (a.n <= a.w) return 0;
  return min(max(t0 - a.h, 0), a.n - a.w);
}

// Element copies of a band tile into the core-matrix layout of a K-major
// operand: element (n, k) of rows [t0, t0 + rows) x columns [s, s + w) of
// M (n x n) at ((k / 8) * rows + n) * 8 + k % 8; zero past the axis.
__device__ __forceinline__ void copy_band(__nv_bfloat16* dst,
                                          const __nv_bfloat16* m, int n,
                                          int t0, int s, int rows, int w) {
  for (int e = threadIdx.x; e < rows * w; e += THREADS) {
    const int i = e & 7;
    const int rest = e >> 3;
    const int row = rest % rows;
    const int col = s + (rest / rows) * 8 + i;
    const int gr = t0 + row;
    dst[e] = gr < n && col < n ? m[static_cast<long long>(gr) * n + col]
                               : __float2bfloat16(0.0f);
  }
}

// KZ, KY, KX: the windows' 16-deep wgmma steps (wz / 16, ...) as compile-
// time constants, or 0 for any plan's windows at run time. With constant
// windows every loop of the rank is unrolled to the same work in each
// warpgroup (the y stage over all 16 z rows), so the wgmma accumulators
// stay in fixed registers and the compiler does not serialize the wgmma
// (the run-time instance waits after each one).
template <int NX, int KZ, int KY, int KX>
__global__ void __launch_bounds__(THREADS, 1)
zfused_kernel(const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap mz_map,
              const __grid_constant__ CUtensorMap my_map,
              const __grid_constant__ CUtensorMap mx_map,
              const __nv_bfloat16* __restrict__ vm,
              const __nv_bfloat16* __restrict__ mz,
              const __nv_bfloat16* __restrict__ my,
              const __nv_bfloat16* __restrict__ mx,
              float* __restrict__ out, Plan p, int use_tma) {
  constexpr bool FIXED = KZ > 0;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw +
      ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1)));
  const int Z = p.z.n, Y = p.y.n, X = p.x.n;
  const int WZ = FIXED ? 16 * KZ : p.z.w;
  const int WY = FIXED ? 16 * KY : p.y.w;
  const int WX = FIXED ? 16 * KX : p.x.w;
  const int NXG = WX / 8;  // 8-column groups of the x window
  // Vs: [x group][y][z][8]; As: [x group][z row][y][8] (16 z rows), each
  // (x group, z row) padded by one 16-byte row so that the 8 z rows a
  // transposed store writes fall in 8 different bank groups; Bs: [x
  // group][16 z rows x NY y rows][8]; then the ring, the staging slots and
  // the barriers (the volume's, then one a staging slot)
  const int LA = WY + 1;   // 16-byte rows of an As group
  __nv_bfloat16* As = Vs + WZ * WY * WX;
  __nv_bfloat16* Bs = As + ZN * LA * WX;
  __nv_bfloat16* Ring = Bs + ZN * NY * WX;
  const int slot = slot_elems(WZ, WY, WX, NX);
  __nv_bfloat16* Stage = Ring + SLOTS * slot;
  const int stage = stage_elems(WZ, WY, WX, NX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(Stage + STAGES * stage);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;   // warp of the warpgroup
  const int lane = tid & 31;
  const int z0 = blockIdx.z * p.z.t;
  const int y0 = blockIdx.y * p.y.t;
  const int x0 = blockIdx.x * p.x.t - p.x.c;
  const int sz = win_start(p.z, z0);
  const int sy = win_start(p.y, y0);
  const int sx = win_start(p.x, x0);
  const int tz = p.z.t;

  // A TMA box's innermost start must lie on 16 bytes: the x window starts
  // on an 8-column group (the plan's x origin), the z and y windows
  // anywhere, so the Mz and My boxes start at the group below the window,
  // dz and dy columns early and one group wider, and are shifted into
  // place.
  const int dz = sz & 7, dy = sy & 7;

  // Rank r's band tiles into ring slot r % SLOTS: by three TMA boxes (the
  // tile's rows x the window's columns, row-major, into staging slot
  // r % STAGES, laid out as K-major core matrices by `settle`) that the
  // last warpgroup's first thread issues (it tends to finish the z stage
  // first), or every thread's element copies straight into the ring.
  auto load_band = [&](int r) {
    __nv_bfloat16* Bz = Ring + (r % SLOTS) * slot;
    __nv_bfloat16* By = Bz + ZN * WZ;
    __nv_bfloat16* Bx = By + NY * WY;
    if (!use_tma) {
      copy_band(Bz, mz + static_cast<long long>(r) * Z * Z, Z, z0, sz, ZN,
                WZ);
      copy_band(By, my + static_cast<long long>(r) * Y * Y, Y, y0, sy, NY,
                WY);
      copy_band(Bx, mx + static_cast<long long>(r) * X * X, X, x0, sx, NX,
                WX);
      return;
    }
    if (tid != THREADS - 128) return;
    __nv_bfloat16* Sz = Stage + (r % STAGES) * stage;
    __nv_bfloat16* Sy = Sz + ZN * (WZ + 8);
    __nv_bfloat16* Sx = Sy + NY * (WY + 8);
    const uint32_t bar = smem_addr(bars + 1 + r % STAGES);
    mbar_expect_tx(bar, 2u * stage);
    tma_load_3d(Sz, &mz_map, sz - dz, z0, r, bar);
    tma_load_3d(Sy, &my_map, sy - dy, y0, r, bar);
    tma_load_3d(Sx, &mx_map, sx, x0, r, bar);
  };
  // Rank r's boxes, once landed, into the ring's K-major core matrices
  // (a slot is Mz's, My's and Mx's tiles back to back, each [column
  // group][row][8]): one 16-byte core-matrix row a thread, Mz's and My's
  // columns shifted by dz / dy (TMA route). Its shared-memory loads and
  // stores queue behind the other warpgroups' wgmma operand reads, so it
  // takes as few as it can.
  auto settle = [&](int r) {
    mbar_wait(smem_addr(bars + 1 + r % STAGES), (r / STAGES) & 1);
    const __nv_bfloat16* Sz = Stage + (r % STAGES) * stage;
    const __nv_bfloat16* Sy = Sz + ZN * (WZ + 8);
    const uint4* Sx = reinterpret_cast<const uint4*>(Sy + NY * (WY + 8));
    uint4* B = reinterpret_cast<uint4*>(Ring + (r % SLOTS) * slot);
    const int nz = ZN * WZ / 8, nzy = nz + NY * WY / 8, n = nzy + NX * NXG;
    for (int e = tid; e < n; e += THREADS) {
      uint4 v;
      if (e < nz) {
        v = shifted8(Sz + e % ZN * (WZ + 8), e / ZN, dz);
      } else if (e < nzy) {
        const int f = e - nz;
        v = shifted8(Sy + f % NY * (WY + 8), f / NY, dy);
      } else {
        const int f = e - nzy;
        v = Sx[f % NX * NXG + f / NX];
      }
      B[e] = v;
    }
  };

  if (use_tma && tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(smem_addr(bars + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const CUtensorMap* maps[4] = {&v_map, &mz_map, &my_map, &mx_map};
    for (const CUtensorMap* m : maps)
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(m)) : "memory");
  }
  __syncthreads();
  // the volume window, once for all ranks
  if (use_tma) {
    if (tid < 32) {
      const uint32_t bar = smem_addr(bars);
      if (lane == 0) mbar_expect_tx(bar, 2u * WZ * WY * WX);
      __syncwarp();
      for (int g = lane; g < NXG; g += 32)
        tma_load_3d(Vs + g * WY * WZ * 8, &v_map, sx + 8 * g, sz, sy, bar);
    }
  } else {
    for (int e = tid; e < WZ * WY * WX; e += THREADS) {
      const int i = e & 7;
      int rest = e >> 3;
      const int z = rest % WZ;
      rest /= WZ;
      const int y = rest % WY;
      const int gx = sx + (rest / WY) * 8 + i;
      const int gz = sz + z, gy = sy + y;
      Vs[e] = gz < Z && gy < Y && gx < X
                  ? vm[(static_cast<long long>(gz) * Y + gy) * X + gx]
                  : __float2bfloat16(0.0f);
    }
  }
  for (int r = 0; r < 2 && r < p.R; ++r) load_band(r);
  if (use_tma) {
    settle(0);
    mbar_wait(smem_addr(bars), 0);
  }
  fence_async_smem();
  __syncthreads();

  // Chunks of each stage: the warpgroup takes chunks wg, wg + WGS, ...; a
  // constant plan computes the y stage for all 16 z rows, so that every
  // count is a multiple of WGS.
  const int nzc = (WY / 8) * NXG;                        // 8 x 8 patches
  const int zc = FIXED ? 2 : (tz + 7) / 8;  // 8-row z groups of `a` used
  const int nyc = zc * NXG;                  // 8 (x group, z row) groups
  const int nxc = ((FIXED ? ZN : tz) * NY + 63) / 64;    // 64 rows
  const int kz = WZ / 16, ky = WY / 16, kx = WX / 16;
  // x-stage chunks a warpgroup owns (a constant plan: 16 z rows x NY)
  constexpr int XCH = FIXED ? ZN * NY / 64 / WGS : MAX_XCH;
  float acc[XCH][NX / 2];
#pragma unroll
  for (int i = 0; i < XCH; ++i)
#pragma unroll
    for (int j = 0; j < NX / 2; ++j) acc[i][j] = 0.0f;
  // A constant plan keeps the z stage's A operand, V^T of the warpgroup's
  // ZPW patches, in registers for the whole rank loop (one transposed
  // ldmatrix per patch and 16 z planes), so its wgmma read only the Mz
  // tile from shared memory.
  constexpr int ZPW = FIXED ? 4 * KY * KX / WGS : 1;
  uint32_t vf[ZPW][FIXED ? KZ : 1][4];
  if constexpr (FIXED) {
    const int mj = lane >> 3;
#pragma unroll
    for (int k = 0; k < ZPW; ++k)
#pragma unroll
      for (int ks = 0; ks < KZ; ++ks) {
        const int c = wg + WGS * k;
        ldmatrix_x4_trans(
            vf[k][ks],
            Vs + (((c % NXG) * WY + 8 * (c / NXG) + 2 * warp + (mj & 1)) * WZ +
                  16 * ks + 8 * (mj >> 1) + (lane & 7)) * 8);
      }
  }

  // z stage, one chunk: the 8 x 8 patch c (y rows 8 (c / NXG).., x group
  // c % NXG) of positions, all 16 z rows; k: the warpgroup's k-th chunk.
  auto z_chunk = [&](float (&d)[8], const __nv_bfloat16* Bz, int c, int k) {
    if constexpr (FIXED) {
#pragma unroll
      for (int ks = 0; ks < KZ; ++ks)
        wgmma_n16_rs(d, vf[k][ks],
                     smem_desc(Bz + ks * 2 * ZN * 8, ZN * 16, 128));
    } else {
      const __nv_bfloat16* v =
          Vs + ((c % NXG) * WY + 8 * (c / NXG)) * WZ * 8;
#pragma unroll 4
      for (int ks = 0; ks < kz; ++ks)
        wgmma<16, 1>(d, smem_desc(v + ks * 128, 128, WZ * 16),
                     smem_desc(Bz + ks * 2 * ZN * 8, ZN * 16, 128), 1);
    }
  };
  // ... and its rounding into `a`: fragment (rows y = 8 (c / NXG) + 2 warp +
  // {0, 1} x the 8 columns of the group; columns z rows) stored transposed,
  // each z row's 8 x values in 16 bytes.
  auto z_store = [&](const float (&d)[8], int c) {
    const int mi = lane >> 3;
    const int zr = 8 * (mi >> 1) + (lane & 7);
    const int y = 8 * (c / NXG) + 2 * warp + (mi & 1);
    stmatrix_x4_trans(As + (((c % NXG) * ZN + zr) * LA + y) * 8,
                      pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]),
                      pack_bf16(d[4], d[5]), pack_bf16(d[6], d[7]));
  };
  // y stage, one chunk: x group c / zc, z rows 8 (c % zc) .. + 7 (row
  // group g = (x group) * 16 + z row), the tile's NY y rows.
  auto y_rows = [&](int c) { return (c / zc) * ZN + 8 * (c % zc); };
  auto y_chunk = [&](float (&d)[NY / 2], const __nv_bfloat16* By, int c) {
#pragma unroll 4
    for (int ks = 0; ks < ky; ++ks)
      wgmma<NY, 1>(d, smem_desc(As + (y_rows(c) * LA + 16 * ks) * 8, 128,
                                LA * 16),
                   smem_desc(By + ks * 2 * NY * 8, NY * 16, 128), 1);
  };
  auto y_store = [&](const float (&d)[NY / 2], int c) {
    const int mi = lane >> 3;
    const int g = y_rows(c) + 2 * warp + (mi & 1);
    __nv_bfloat16* row = Bs + g * NY * 8;
#pragma unroll
    for (int jb = 0; jb < NY / 16; ++jb) {
      const int j = 2 * jb;
      stmatrix_x4_trans(row + (8 * (j + (mi >> 1)) + (lane & 7)) * 8,
                        pack_bf16(d[4 * j], d[4 * j + 1]),
                        pack_bf16(d[4 * j + 2], d[4 * j + 3]),
                        pack_bf16(d[4 * j + 4], d[4 * j + 5]),
                        pack_bf16(d[4 * j + 6], d[4 * j + 7]));
    }
  };
  // The warpgroup's chunks c = wg + WGS k of a stage of n chunks, GS in
  // flight, with NA accumulators each: run(d, c, k) issues chunk c's
  // products into d, put(d, c) rounds and stores them. A constant plan's
  // counts are multiples of WGS, so every branch below is settled at
  // compile time.
  auto stage_loop = [&](auto gs, auto na, int n, auto run, auto put) {
    constexpr int GS = decltype(gs)::value;
    constexpr int NA = decltype(na)::value;
    const int per = FIXED ? n / WGS : (n - wg + WGS - 1) / WGS;
#pragma unroll
    for (int i = 0; i < per; i += GS) {
      float d[GS][NA];
#pragma unroll
      for (int g = 0; g < GS; ++g) {
#pragma unroll
        for (int j = 0; j < NA; ++j) d[g][j] = 0.0f;
        fence_all(d[g]);
      }
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < GS; ++g)
        if (i + g < per) run(d[g], wg + WGS * (i + g), i + g);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        fence_all(d[g]);
        if (i + g < per) put(d[g], wg + WGS * (i + g));
      }
    }
  };
  // chunks a warpgroup keeps in flight in the z and y stages (128
  // registers a thread at 512 threads, 48 of them V^T's, bound both)
  constexpr int ZGS = 2;
  constexpr int YGS = 2;

  for (int r = 0; r < p.R; ++r) {
    const __nv_bfloat16* Bz = Ring + (r % SLOTS) * slot;
    const __nv_bfloat16* By = Bz + ZN * WZ;
    const __nv_bfloat16* Bx = By + NY * WY;

#pragma unroll
    for (int i = 0; i < XCH; ++i) fence_all(acc[i]);
    stage_loop(std::integral_constant<int, ZGS>{},
               std::integral_constant<int, 8>{}, nzc,
               [&](float (&d)[8], int c, int k) { z_chunk(d, Bz, c, k); },
               z_store);
#pragma unroll
    for (int i = 0; i < XCH; ++i) fence_all(acc[i]);
    if (use_tma) {
      // staging slot r % STAGES was settled in rank r - 1; ring slot
      // (r + 1) % SLOTS was last read by rank r - 2
      if (r + 2 < p.R) load_band(r + 2);
      if (r + 1 < p.R) settle(r + 1);
    }
    fence_async_smem();
    // `a` complete; every x stage of rank r - 1 done: `b` and the ring
    // slot of rank r - 1 are free
    __syncthreads();
    if (!use_tma && r + 2 < p.R) load_band(r + 2);

    stage_loop(std::integral_constant<int, YGS>{},
               std::integral_constant<int, NY / 2>{}, nyc,
               [&](float (&d)[NY / 2], int c, int) { y_chunk(d, By, c); },
               y_store);
    fence_async_smem();
    // `b` complete; `a` read
    __syncthreads();

    // x stage: this warpgroup's chunks of o, rows (z row, y row) = (m / NY,
    // m % NY), accumulating over ranks
#pragma unroll
    for (int i = 0; i < XCH; ++i) fence_all(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = wg + i * WGS;
      if (!FIXED && c >= nxc) continue;
#pragma unroll 4
      for (int ks = 0; ks < kx; ++ks)
        wgmma<NX, 0>(acc[i],
                     smem_desc(Bs + (2 * ks * ZN * NY + 64 * c) * 8,
                               ZN * NY * 16, 128),
                     smem_desc(Bx + ks * 2 * NX * 8, NX * 16, 128), 1);
    }
    wgmma_commit();
    // A constant plan's x stage runs on into the next rank's z stage,
    // whose wait retires it. With run-time windows it is retired here: the
    // compiler moves the accumulators across the loop's back edge and
    // would serialize every wgmma around it.
    if constexpr (!FIXED) wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < XCH; ++i) fence_all(acc[i]);
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < XCH; ++i) fence_all(acc[i]);

  // Epilogue: in warp w, thread (g, t) = (lane / 4, lane % 4) holds
  // columns 8j + 2t, 8j + 2t + 1 of rows 16w + g and 16w + g + 8 of its
  // chunk in acc[.][4j .. 4j + 3]. Each chunk goes through shared memory
  // (the stages' buffers are free), and its (z, y) rows of tx values
  // leave with consecutive threads on consecutive columns; `o` is written
  // once.
  __syncthreads();
  float* Os = reinterpret_cast<float*>(Vs) + wg * 64 * NX;
  const int wtid = tid & 127;
#pragma unroll
  for (int i = 0; i < XCH; ++i) {
    const int c = wg + i * WGS;
    if (c >= nxc) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NX / 8; ++j)
        *reinterpret_cast<float2*>(
            Os + (16 * warp + (lane >> 2) + 8 * h) * NX + 8 * j +
            2 * (lane & 3)) =
            make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    for (int e = wtid; e < 64 * p.x.t; e += 128) {
      const int row = e / p.x.t, col = e - row * p.x.t;
      const int m = 64 * c + row;
      const int zr = m / NY, yr = m % NY;
      const int gz = z0 + zr, gy = y0 + yr, gx = x0 + col;
      if (zr < tz && yr < p.y.t && gz < Z && gy < Y && gx >= 0 && gx < X)
        out[(static_cast<long long>(gz) * Y + gy) * X + gx] =
            Os[row * NX + col];
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 3-D bf16 tensor map, no swizzle: dims[0] contiguous, the byte strides
// of dims 1 and 2, and the box.
cudaError_t encode_map(CUtensorMap* map, const void* base,
                       const cuuint64_t (&dims)[3],
                       const cuuint64_t (&strides)[2],
                       const cuuint32_t (&box)[3]) {
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
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The tensor maps of the TMA loads: the volume as (x, z, y), so that a box
// of 8 x columns x wz planes x wy rows lands as [y][z][8]; each band stack
// (R, n, n) as (column, row, rank) with boxes of the window's columns (Mz
// and My one 8-column group wider: `settle`) x the tile's rows. Needs Z,
// Y, X multiples of 8 and 16-byte aligned bases.
cudaError_t zfused_maps(CUtensorMap* maps, const void* vm, const void* mz,
                        const void* my, const void* mx, const Plan& p,
                        int nx) {
  const cuuint64_t Z = p.z.n, Y = p.y.n, X = p.x.n, R = p.R;
  cudaError_t err = encode_map(
      &maps[0], vm, {X, Z, Y}, {Y * X * 2, X * 2},
      {8, static_cast<cuuint32_t>(p.z.w), static_cast<cuuint32_t>(p.y.w)});
  const struct {
    const void* m;
    cuuint64_t n;
    int rows, cols;
  } band[3] = {{mz, Z, ZN, p.z.w + 8}, {my, Y, NY, p.y.w + 8},
               {mx, X, nx, p.x.w}};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    const cuuint64_t n = band[i].n;
    err = encode_map(&maps[1 + i], band[i].m, {n, n, R}, {n * 2, n * n * 2},
                     {static_cast<cuuint32_t>(band[i].cols),
                      static_cast<cuuint32_t>(band[i].rows), 1});
  }
  return err;
}

bool axis_ok(const Axis& a, int n_max) {
  return a.n >= 1 && a.h >= 0 && a.w >= 16 && a.w % 16 == 0 &&
         a.w <= MAX_WIN && a.t >= 1 && a.t <= n_max && a.c >= 0 &&
         a.c < 8 && (a.t + 2 * a.h <= a.w || a.n <= a.w);
}

// The TMA route's boxes start on 16 bytes: rows of Z, Y, X a multiple of
// 8 elements, and every x window on an 8-column group (one window, or
// tiles of a multiple of 8 whose origin puts t0 - h on a group).
bool tma_ok(const Plan& p) {
  return p.z.n % 8 == 0 && p.y.n % 8 == 0 && p.x.n % 8 == 0 &&
         (p.x.n <= p.x.w || (p.x.t % 8 == 0 && (p.x.c + p.x.h) % 8 == 0));
}

template <int NX, int KZ, int KY, int KX>
int launch(const void* vm, const void* mz, const void* my, const void* mx,
           void* out, const Plan& p, int bytes, int tma, cudaStream_t s) {
  // shared-memory limits, once per device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(zfused_kernel<NX, KZ, KY, KX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(zfused_kernel<NX, KZ, KY, KX>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) ready[dev] = true;
  }
  CUtensorMap maps[4] = {};
  if (tma) {
    err = zfused_maps(maps, vm, mz, my, mx, p, NX);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((p.x.n + p.x.c + p.x.t - 1) / p.x.t, (p.y.n + p.y.t - 1) / p.y.t,
            (p.z.n + p.z.t - 1) / p.z.t);
  zfused_kernel<NX, KZ, KY, KX><<<grid, THREADS, bytes, s>>>(
      maps[0], maps[1], maps[2], maps[3],
      static_cast<const __nv_bfloat16*>(vm),
      static_cast<const __nv_bfloat16*>(mz),
      static_cast<const __nv_bfloat16*>(my),
      static_cast<const __nv_bfloat16*>(mx), static_cast<float*>(out), p,
      tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block with windows (wz, wy, wx) and x tiles
// of nx rows (16 or 24), or -1 when no block can hold them.
int spim_zfused_smem(int wz, int wy, int wx, int nx) {
  if (nx != 16 && nx != 24) return -1;
  const int ws[3] = {wz, wy, wx};
  for (int w : ws)
    if (w < 16 || w % 16 || w > MAX_WIN) return -1;
  const long long bytes = smem_bytes(wz, wy, wx, nx);
  return bytes <= MAX_SMEM ? static_cast<int>(bytes) : -1;
}

// The plan (`zfused_plan`): per axis its window w and tile rows t (z and
// y rows at most 16, x at most nx) and the x tiles' origin offset cx;
// tma: 1 to load by TMA (`zfused_tma_load`). Returns a cudaError_t.
int spim_zfused(const void* vm, const void* mz, const void* my,
                const void* mx, void* out, int R, int Z, int Y, int X,
                int hz, int hy, int hx, int wz, int wy, int wx, int tz,
                int ty, int tx, int cx, int nx, int tma, void* stream) {
  const int bytes = spim_zfused_smem(wz, wy, wx, nx);
  const Plan p{{Z, hz, wz, tz, 0}, {Y, hy, wy, ty, 0}, {X, hx, wx, tx, cx},
               R};
  if (bytes < 0 || R < 1 || !axis_ok(p.z, ZN) || !axis_ok(p.y, NY) ||
      !axis_ok(p.x, nx) || (Z + tz - 1) / tz > 65535 ||
      (Y + ty - 1) / ty > 65535 || (tma && !tma_ok(p)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the main path's plan (half-supports 9) has its constant instance
  if (nx == 24 && wz == 32 && wy == 32 && wx == 48)
    return launch<24, 2, 2, 3>(vm, mz, my, mx, out, p, bytes, tma, s);
  if (nx == 24)
    return launch<24, 0, 0, 0>(vm, mz, my, mx, out, p, bytes, tma, s);
  return launch<16, 0, 0, 0>(vm, mz, my, mx, out, p, bytes, tma, s);
}

}  // extern "C"
