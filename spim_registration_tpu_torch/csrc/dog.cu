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
// the host (three `mirror_pad` concatenations plus an edge pad to the TPU's
// 128-lane width). Here the mirror is an index reflection inside the
// kernel: the volume is read as it is, and nothing padded is ever stored.
//
// What bounds it on an H100: at the detection configuration (256^3,
// sigma 1.8 and 1.8 * 2^(1/4), radii 6 and 7 on every axis) the volume is
// read once and the DoG written once, 134 MB = 0.040 ms at 3.35 TB/s,
// while the 2 x (13 + 15) taps per axis are ~84 FMA per voxel = 2.8
// GFLOP = 0.042 ms at 67 TFLOP/s f32: the two bounds are about equal.
// The design keeps every intermediate on chip:
//   one block of 32 x 16 threads per 32 x 32 (y, x) tile and z chunk
//   marches through z; per input plane (the chunk's rows plus the z halo,
//   reflected) it
//   1. loads the plane's (32 + 2R) x (32 + 2R) window, reflected at the
//      volume's faces, into shared memory (R = the largest radius);
//   2. runs the x pass of both sigmas over the window's rows;
//   3. runs the y pass of both sigmas for the tile's columns (two per
//      thread) and adds k1z[t] * b1 - k2z[t] * b2 into 2R + 1 output
//      accumulators per column held in registers; the oldest is complete
//      and written once, coalesced, and the accumulators shift by one.
// R is a template parameter (taps zero-padded to it), so every tap loop
// is unrolled with the weights in the constant bank and the accumulators
// stay in registers. The halo re-reads (up to 2.1x a plane window, and
// 2R planes per z chunk) come from L2. A radius above 15 raises
// (`spim_dog_radius` returns -1).
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TY = 32;         // output rows (y) per block
constexpr int TX = 32;         // output columns (x) per block = lanes
constexpr int WARPS = 16;      // threads = 32 x 16; two rows per thread
constexpr int MAX_TAPS = 32;   // host table per sigma and axis: radius <= 15
constexpr int RADII[] = {2, 4, 7, 11, 15};  // compiled radii

struct Taps {
  float k[2][3][MAX_TAPS];  // [sigma][axis z, y, x][tap], centred at R
};

// Single-boundary mirror of index i into [0, n): period 2(n - 1).
__device__ __forceinline__ int reflect(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int p = 2 * n - 2;
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

template <int R>
__global__ void __launch_bounds__(TX * WARPS)
dog_kernel(const float* __restrict__ vol, float* __restrict__ out,
           int Z, int Y, int X, int tz, Taps taps) {
  constexpr int T = 2 * R + 1;
  constexpr int WY = TY + 2 * R;
  constexpr int WX = TX + 2 * R;
  __shared__ float W[WY][WX];   // reflected input window of one plane
  __shared__ float X1[WY][TX];  // x pass, sigma 1
  __shared__ float X2[WY][TX];  // x pass, sigma 2

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * tz;
  const int z1 = min(z0 + tz, Z);
  const long long YX = static_cast<long long>(Y) * X;
  const int gx = x0 + lane;

  float acc[2][T];  // output planes q - R .. q + R, per owned row
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[c][j] = 0.0f;

  for (int q = z0 - R; q < z1 + R; ++q) {
    // 1. the reflected input window of plane q
    const float* plane = vol + reflect(q, Z) * YX;
    for (int wy = warp; wy < WY; wy += WARPS) {
      const float* row = plane + static_cast<long long>(
          reflect(y0 - R + wy, Y)) * X;
      for (int wx = lane; wx < WX; wx += TX)
        W[wy][wx] = __ldg(row + reflect(x0 - R + wx, X));
    }
    __syncthreads();
    // 2. x pass of both sigmas over every window row
    for (int wy = warp; wy < WY; wy += WARPS) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float w = W[wy][lane + t];
        s1 = fmaf(taps.k[0][2][t], w, s1);
        s2 = fmaf(taps.k[1][2][t], w, s2);
      }
      X1[wy][lane] = s1;
      X2[wy][lane] = s2;
    }
    __syncthreads();
    // 3. y pass, z accumulation in registers, the finished plane out
    const int zo = q - R;   // the plane acc[.][0] completes now
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int cy = warp + WARPS * c;
      float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        b1 = fmaf(taps.k[0][1][t], X1[cy + t][lane], b1);
        b2 = fmaf(taps.k[1][1][t], X2[cy + t][lane], b2);
      }
#pragma unroll
      for (int j = 0; j < T; ++j)
        acc[c][j] = fmaf(-taps.k[1][0][T - 1 - j], b2,
                         fmaf(taps.k[0][0][T - 1 - j], b1, acc[c][j]));
      const int gy = y0 + cy;
      if (zo >= z0 && gy < Y && gx < X)
        out[zo * YX + static_cast<long long>(gy) * X + gx] = acc[c][0];
#pragma unroll
      for (int j = 0; j + 1 < T; ++j) acc[c][j] = acc[c][j + 1];
      acc[c][T - 1] = 0.0f;
    }
    // the next window load reuses W; X1/X2 are rewritten only after the
    // barrier that follows it
  }
}

template <int R>
int launch(const float* vol, float* out, int Z, int Y, int X, int tz,
           const Taps& t, cudaStream_t s) {
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (Z + tz - 1) / tz);
  dog_kernel<R><<<grid, dim3(TX, WARPS), 0, s>>>(vol, out, Z, Y, X, tz, t);
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

// taps: 2 x 3 x MAX_TAPS floats on the host ([sigma][axis z, y, x][tap],
// each centred at its own radius); radii: 2 x 3 ints. `tz` output planes
// per block along z. Returns a cudaError_t.
int spim_dog(const float* vol, float* out, int Z, int Y, int X, int tz,
             const float* taps, const int* radii, void* stream) {
  int r = 0;
  for (int i = 0; i < 6; ++i) r = radii[i] > r ? radii[i] : r;
  const int R = spim_dog_radius(r);
  if (R < 0 || tz < 1 || Z < 1 || Y < 1 || X < 1)
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
    case 2: return launch<2>(vol, out, Z, Y, X, tz, t, s);
    case 4: return launch<4>(vol, out, Z, Y, X, tz, t, s);
    case 7: return launch<7>(vol, out, Z, Y, X, tz, t, s);
    case 11: return launch<11>(vol, out, Z, Y, X, tz, t, s);
    default: return launch<15>(vol, out, Z, Y, X, tz, t, s);
  }
}

}  // extern "C"
