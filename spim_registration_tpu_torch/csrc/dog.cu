// Fused Difference-of-Gaussian of a float32 volume:
//
//     out = G(s1) * vol - G(s2) * vol
//
// with each Gaussian a separable 3-D blur (per-axis 1-D taps, mirror
// boundary without repeating the edge sample, i.e. the reflection of
// period 2(n-1) that `ops.gaussian.mirror_pad` produces for any radius),
// both blurs and their difference in one pass, f32 accumulation.
//
// Replaces spim_registration_tpu/ops/pallas/dog.py `dog_pallas` (its inner
// `kernel`). The Pallas kernel DMAs a mirror-padded (z, y) slab with its
// halo into VMEM once and runs both blurs from it; the padding is made on
// the host. Here the mirror is an index reflection inside the kernel: the
// volume is read as it is, and nothing padded is ever stored.
//
// What bounds it on an H100: at the detection configuration (256^3,
// sigma 1.8 and 1.8 * 2^(1/4), radii 6 and 7 on every axis) the volume is
// read once and the DoG written once, 134 MB = 0.040 ms at 3.35 TB/s,
// while the 2 x (13 + 15) taps per axis are ~84 FMA per voxel = 2.8
// GFLOP = 0.042 ms at 67 TFLOP/s f32: the two bounds are about equal, so
// the design spends its instruction slots on FMAs and keeps every
// intermediate on chip.
//
// One block of 512 threads owns a (TY = 16 V) x 32 (y, x) output tile and
// a chunk of tz planes in z (`dog_plan` picks tz so that the grid fills
// the card once), and marches through the chunk's planes plus the z halo:
// - A ring of STAGES = 4 plane windows ((TY + 2R) x (32 + 2H) floats, H =
//   R rounded up to 4) in shared memory, each completing on an mbarrier, so
//   the next planes load while one computes. Where rows are a multiple of
//   16 bytes (X % 4 == 0) a window is one TMA tiled copy a plane, also on
//   the volume's faces: the box lands with its cells outside the volume
//   zero-filled, and once it has landed the block fills them from their
//   mirror images, cells of the same window (reflected row and column
//   tables built once per block), before the barrier that precedes their
//   use. Per-thread copies cost an issue slot apiece, and on the face
//   tiles ~1000 a plane (4-byte ones for the mirrored columns) held every
//   block back. Other tiles (X % 4 != 0, or a volume so small that a face
//   mirrors cells outside the window) take every thread's cp.async copies
//   through the same tables. The z mirror is the plane index of the copy.
// - x pass, both sigmas from one read: a thread makes 4 neighbouring
//   outputs of a window row from H / 2 + 1 float4 loads; the taps are
//   symmetric, so each pair of mirrored inputs is added once and feeds
//   both sigmas (R adds and 2 (R + 1) FMAs an output for both blurs).
// - y pass: a thread makes V neighbouring rows of one column from V + 2R
//   loads per sigma (a sliding register window, ~1/4 of a load per FMA).
// - z pass: the difference k1z b1 - k2z b2 of each y-pass output is
//   scattered into 2R + 1 accumulators a voxel held in registers; the
//   oldest is complete, written once (streaming store) and reused for
//   the plane 2R + 1 ahead. Accumulators do not move: the slot of each
//   tap rotates with the plane, the plane loop dispatching to one of
//   2R + 1 unrolled bodies.
// - One barrier a plane: the x pass of plane q and the y/z pass of plane
//   q - 1 run between the same two barriers, on two x-pass buffers.
// R is a template parameter (taps zero-padded to it: 2, 4, 7, 11, 15), so
// every tap loop is unrolled with the weights in the constant bank. A
// radius above 15 raises (`spim_dog_radius` returns -1).
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;               // output columns (x) per block = lanes
constexpr int THREADS = 512;         // 16 warps
constexpr int ROW_GROUPS = THREADS / TX;
constexpr int MAX_TAPS = 32;         // host table per sigma and axis
constexpr int RADII[] = {2, 4, 7, 11, 15};  // compiled radii
constexpr int STAGES = 4;            // plane windows in the ring
constexpr int ALIGN = 128;           // a TMA destination's alignment
constexpr int MAX_SMEM = 232448;     // a block's dynamic shared memory

struct Taps {
  float k[2][3][MAX_TAPS];  // [sigma][axis z, y, x][tap], centred at R
};

// Rows a thread owns: its z accumulators are (2R + 1) x V registers.
__host__ __device__ constexpr int rows_per_thread(int R) {
  return R <= 7 ? 4 : 2;
}
__host__ __device__ constexpr int tile_rows(int R) {
  return ROW_GROUPS * rows_per_thread(R);
}
__host__ __device__ constexpr int halo_x(int R) { return (R + 3) & ~3; }
__host__ __device__ constexpr int win_rows(int R) { return tile_rows(R) + 2 * R; }
__host__ __device__ constexpr int win_cols(int R) { return TX + 2 * halo_x(R); }
__host__ __device__ constexpr int slot_bytes(int R) {
  return (win_rows(R) * win_cols(R) * 4 + ALIGN - 1) / ALIGN * ALIGN;
}
// ring, two x-pass buffers of both sigmas, mbarriers, reflect tables
__host__ __device__ constexpr int smem_bytes(int R) {
  return ALIGN + STAGES * slot_bytes(R) + 4 * win_rows(R) * TX * 4 +
         STAGES * 8 + (win_rows(R) + win_cols(R)) * 4;
}
static_assert(smem_bytes(15) <= MAX_SMEM, "a block's ring does not fit");

// Single-boundary mirror of index i into [0, n): period 2(n - 1).
__device__ __forceinline__ int reflect(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int p = 2 * n - 2;
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_plane(void* dst, const CUtensorMap* map,
                                          int x, int y, int z, uint32_t bar,
                                          uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(z), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// The mbarrier's phase counts this thread once its earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// The z pass of one y-pass plane for phase P = (plane index) mod T: the
// plane's contribution to the 2R + 1 outputs within reach; the output of
// slot P is then complete and leaves.
template <int R, int V, int P>
__device__ __forceinline__ void z_scatter(float (&acc)[2 * R + 1][V],
                                          const float (&b1)[V],
                                          const float (&b2)[V],
                                          const Taps& taps, float* dst,
                                          long long row_stride, int rows,
                                          bool store) {
  constexpr int T = 2 * R + 1;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const int s = (P + j) % T;   // a constant once unrolled
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc[s][i] = fmaf(taps.k[0][0][2 * R - j], b1[i], acc[s][i]);
      acc[s][i] = fmaf(-taps.k[1][0][2 * R - j], b2[i], acc[s][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (store && i < rows) __stcs(dst + i * row_stride, acc[P][i]);
    acc[P][i] = 0.0f;
  }
}

template <int R, int V, int P>
__device__ __forceinline__ void z_dispatch(int phase,
                                           float (&acc)[2 * R + 1][V],
                                           const float (&b1)[V],
                                           const float (&b2)[V],
                                           const Taps& taps, float* dst,
                                           long long row_stride, int rows,
                                           bool store) {
  if constexpr (P < 2 * R + 1) {
    if (phase == P)
      z_scatter<R, V, P>(acc, b1, b2, taps, dst, row_stride, rows, store);
    else
      z_dispatch<R, V, P + 1>(phase, acc, b1, b2, taps, dst, row_stride,
                              rows, store);
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
dog_kernel(const __grid_constant__ CUtensorMap map,
           const float* __restrict__ vol, float* __restrict__ out, int Z,
           int Y, int X, int tz, int tma, int vec,
           const __grid_constant__ Taps taps) {
  constexpr int V = rows_per_thread(R);
  constexpr int T = 2 * R + 1;
  constexpr int TY = tile_rows(R);
  constexpr int H = halo_x(R);
  constexpr int WY = win_rows(R);
  constexpr int WX = win_cols(R);
  constexpr int SLOT = slot_bytes(R) / 4;   // floats
  constexpr int NV4 = H / 2 + 1;           // float4 loads of an x unit
  constexpr int UNITS = WY * (TX / 4);     // x-pass units (4 outputs)
  constexpr int GROUPS = WY * (WX / 4);    // 16-byte groups of a window

  // offsets from the shared array itself, so that every access below
  // stays a shared-memory one (LDS/STS, not generic loads)
  extern __shared__ __align__(ALIGN) float smem[];
  float* ring =
      smem + ((ALIGN - (smem_addr(smem) & (ALIGN - 1))) & (ALIGN - 1)) / 4;
  float* xp = ring + STAGES * SLOT;         // [buffer][sigma][WY][TX]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xp + 4 * WY * TX);
  int* ry = reinterpret_cast<int*>(bars + STAGES);
  int* rx = ry + WY;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * tz;
  const int z1 = min(z0 + tz, Z);
  const int planes = z1 - z0 + 2 * R;
  const long long YX = static_cast<long long>(Y) * X;
  // the window's origin, and its rows [ya, yb) and columns [xa, xb) that
  // lie inside the volume
  const int oy = y0 - R, ox = x0 - H;
  const int ya = min(max(-oy, 0), WY), yb = max(min(Y - oy, WY), ya);
  const int xa = min(max(-ox, 0), WX), xb = max(min(X - ox, WX), xa);

  bool inside = true;  // every reflected cell's source lies in the window
  for (int i = tid; i < WY; i += THREADS) {
    ry[i] = reflect(oy + i, Y);
    inside &= ry[i] - oy >= 0 && ry[i] - oy < WY;
  }
  for (int i = tid; i < WX; i += THREADS) {
    rx[i] = reflect(ox + i, X);
    inside &= rx[i] - ox >= 0 && rx[i] - ox < WX;
  }
  // TMA for every tile whose faces mirror cells of its own window: the
  // box lands with its out-of-volume cells zero-filled, `mirror` fills them
  const bool use_tma = __syncthreads_and(tma && inside);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      mbar_init(smem_addr(bars + s), use_tma ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // plane n of the march (volume plane z0 - R + n, reflected) into slot s
  auto load = [&](int n, int s) {
    const int pz = reflect(z0 - R + n, Z);
    float* w = ring + s * SLOT;
    const uint32_t bar = smem_addr(bars + s);
    if (use_tma) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        tma_plane(w, &map, x0 - H, y0 - R, pz, bar, WY * WX * 4);
      }
      return;
    }
    const float* plane = vol + pz * YX;
    for (int g = tid; g < GROUPS; g += THREADS) {
      const int wy = g / (WX / 4);
      const int c = g - wy * (WX / 4);
      const float* row = plane + static_cast<long long>(ry[wy]) * X;
      float* d = w + wy * WX + 4 * c;
      const int xs = x0 - H + 4 * c;
      if (vec && xs >= 0 && xs + 4 <= X) {
        cp_async16(d, row + xs);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(d + e, row + rx[4 * c + e]);
      }
    }
    cp_async_arrive(bar);
  };
  // A landed TMA window of slot s: its cells outside the volume (rows
  // [0, ya) and [yb, WY) whole, then the columns [0, xa) and [xb, WX) of
  // the other rows) from their mirror images, all of them cells inside
  // the volume, so one pass in any order.
  const int rows_out = ya + WY - yb;
  const int cols_out = xa + WX - xb;
  auto mirror = [&](int s) {
    float* w = ring + s * SLOT;
    for (int e = tid; e < rows_out * WX; e += THREADS) {
      const int k = e / WX, wx = e - k * WX;
      const int wy = k < ya ? k : yb + (k - ya);
      w[wy * WX + wx] = w[(ry[wy] - oy) * WX + rx[wx] - ox];
    }
    for (int e = tid; e < (yb - ya) * cols_out; e += THREADS) {
      const int k = e / cols_out, c = e - k * cols_out;
      const int wy = ya + k, wx = c < xa ? c : xb + (c - xa);
      w[wy * WX + wx] = w[wy * WX + rx[wx] - ox];
    }
  };

  float acc[T][V];
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.0f;

  // the y/z pass's rows and column: V rows from r0 of the tile
  const int r0 = (tid >> 5) * V;
  const int gy = y0 + r0;
  const int gx = x0 + lane;
  const int rows = (gx < X) ? min(V, Y - gy) : 0;
  float* dst0 = out + static_cast<long long>(gy) * X + gx;

  for (int n = 0; n < STAGES - 1 && n < planes; ++n) load(n, n);
  // plane n is complete in its slot, faces mirrored, for every thread
  // after the barrier that follows `landed(n)`. Each thread's mirror
  // writes go through the generic proxy and the slot's next TMA copy
  // through the async proxy, so each thread fences its own writes before
  // that barrier (the fence orders only the executing thread's accesses).
  int wslot = 0, wparity = 0;
  auto landed = [&]() {
    mbar_wait(smem_addr(bars + wslot), wparity);
    if (use_tma) {
      mirror(wslot);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (++wslot == STAGES) {
      wslot = 0;
      wparity ^= 1;
    }
  };
  landed();
  __syncthreads();
  int slot = 0, phase = 0;
  for (int it = 0; it <= planes; ++it) {
    // the slot plane it - 1 used is free: every thread passed the barrier
    // after its x pass
    const int ahead = it + STAGES - 1;
    if (ahead < planes) load(ahead, ahead % STAGES);
    if (it < planes) {
      // x pass of plane it, both sigmas: window rows -> xp[it & 1]
      const float* w = ring + slot * SLOT;
      float* o1 = xp + (it & 1) * 2 * WY * TX;
      float* o2 = o1 + WY * TX;
      for (int u = tid; u < UNITS; u += THREADS) {
        const int row = u / (TX / 4);
        const int c0 = (u - row * (TX / 4)) * 4;
        float v[4 * NV4];
        const float4* src = reinterpret_cast<const float4*>(w + row * WX + c0);
#pragma unroll
        for (int m = 0; m < NV4; ++m) {
          const float4 q = src[m];
          v[4 * m] = q.x;
          v[4 * m + 1] = q.y;
          v[4 * m + 2] = q.z;
          v[4 * m + 3] = q.w;
        }
        float s1[4], s2[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = v[H + j];
          s1[j] = taps.k[0][2][R] * c;
          s2[j] = taps.k[1][2][R] * c;
#pragma unroll
          for (int d = 1; d <= R; ++d) {
            const float p = v[H + j - d] + v[H + j + d];
            s1[j] = fmaf(taps.k[0][2][R + d], p, s1[j]);
            s2[j] = fmaf(taps.k[1][2][R + d], p, s2[j]);
          }
        }
        *reinterpret_cast<float4*>(o1 + row * TX + c0) =
            make_float4(s1[0], s1[1], s1[2], s1[3]);
        *reinterpret_cast<float4*>(o2 + row * TX + c0) =
            make_float4(s2[0], s2[1], s2[2], s2[3]);
      }
      if (++slot == STAGES) slot = 0;
    }
    if (it >= 1) {
      // y pass of plane it - 1 for this thread's V rows and column
      const float* i1 = xp + ((it - 1) & 1) * 2 * WY * TX + r0 * TX + lane;
      const float* i2 = i1 + WY * TX;
      float b1[V], b2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) b1[i] = b2[i] = 0.0f;
#pragma unroll
      for (int t = 0; t < V + 2 * R; ++t) {
        const float a1 = i1[t * TX];
        const float a2 = i2[t * TX];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int k = t - i;
          if (k >= 0 && k <= 2 * R) {
            b1[i] = fmaf(taps.k[0][1][k], a1, b1[i]);
            b2[i] = fmaf(taps.k[1][1][k], a2, b2[i]);
          }
        }
      }
      // z pass; output plane z0 - 2R + (it - 1) is complete
      const int zo = z0 - 2 * R + it - 1;
      const bool store = zo >= z0;
      z_dispatch<R, V, 0>(phase, acc, b1, b2, taps,
                          store ? dst0 + zo * YX : dst0, X, rows, store);
      if (++phase == T) phase = 0;
    }
    if (it + 1 < planes) landed();
    __syncthreads();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The 3-D float32 tensor map (x, y, z) of the volume with boxes of one
// plane window (WX x WY x 1), unswizzled.
cudaError_t encode_map(CUtensorMap* map, const void* base, int Z, int Y,
                       int X, int wx, int wy) {
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
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(Y),
                              static_cast<cuuint64_t>(Z)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(X) * 4,
                                 static_cast<cuuint64_t>(X) * Y * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(wx),
                             static_cast<cuuint32_t>(wy), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int R>
int launch(const float* vol, float* out, int Z, int Y, int X, int tz,
           bool tma, const Taps& t, cudaStream_t s) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = smem_bytes(R);
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(dog_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) ready[dev] = true;
  }
  CUtensorMap map = {};
  if (tma) {
    err = encode_map(&map, vol, Z, Y, X, win_cols(R), win_rows(R));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = (X % 4 == 0) && (reinterpret_cast<uintptr_t>(vol) % 16 == 0);
  dim3 grid((X + TX - 1) / TX, (Y + tile_rows(R) - 1) / tile_rows(R),
            (Z + tz - 1) / tz);
  dog_kernel<R><<<grid, THREADS, bytes, s>>>(map, vol, out, Z, Y, X, tz,
                                             tma ? 1 : 0, vec, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The compiled radius the kernel runs for a largest radius `r` (taps
// zero-padded to it), or -1 when none is large enough.
int spim_dog_radius(int r) {
  for (int R : RADII)
    if (r <= R) return R;
  return -1;
}

// Taps per sigma and axis of the host table.
int spim_dog_max_taps(void) { return MAX_TAPS; }

// Output rows (y) of a block at compiled radius R (32 columns, 512
// threads), or -1 for a radius that is not compiled.
int spim_dog_tile_rows(int R) {
  return spim_dog_radius(R) == R ? tile_rows(R) : -1;
}

// Dynamic shared memory of a block at compiled radius R, or -1 for a
// radius that is not compiled.
int spim_dog_smem(int R) {
  return spim_dog_radius(R) == R ? smem_bytes(R) : -1;
}

// taps: 2 x 3 x MAX_TAPS floats on the host ([sigma][axis z, y, x][tap],
// each centred at its own radius); radii: 2 x 3 ints. `tz` output planes
// per block along z (`dog_plan`);
// tma: 1 to load the windows of tiles that touch no y/x face by TMA (needs
// X % 4 == 0 and a 16-byte aligned volume). Returns a cudaError_t.
int spim_dog(const float* vol, float* out, int Z, int Y, int X, int tz,
             int tma, const float* taps, const int* radii, void* stream) {
  int r = 0;
  for (int i = 0; i < 6; ++i) r = radii[i] > r ? radii[i] : r;
  const int R = spim_dog_radius(r);
  if (R < 0 || tz < 1 || Z < 1 || Y < 1 || X < 1 ||
      (tma && (X % 4 || reinterpret_cast<uintptr_t>(vol) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t = {};
  for (int s = 0; s < 2; ++s)
    for (int a = 0; a < 3; ++a) {
      const int ra = radii[s * 3 + a];
      for (int d = -ra; d <= ra; ++d)
        t.k[s][a][R + d] = taps[(s * 3 + a) * MAX_TAPS + ra + d];
    }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 2: return launch<2>(vol, out, Z, Y, X, tz, tma, t, s);
    case 4: return launch<4>(vol, out, Z, Y, X, tz, tma, t, s);
    case 7: return launch<7>(vol, out, Z, Y, X, tz, tma, t, s);
    case 11: return launch<11>(vol, out, Z, Y, X, tz, tma, t, s);
    default: return launch<15>(vol, out, Z, Y, X, tz, tma, t, s);
  }
}

}  // extern "C"
