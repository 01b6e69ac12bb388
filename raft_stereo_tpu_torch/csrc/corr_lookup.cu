// Correlation-pyramid window lookup for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels raft_stereo_tpu/kernels/corr_lookup.py
// _fwd_kernel_multi (all levels in one launch) and _fwd_kernel (one level
// per launch): for every pyramid level l and tap k the volume row of pixel
// (r, w1) is sampled at x = c/2^l + k - R with linear interpolation, zero
// outside [0, W2_l - 1].  Output is level-major, (rows, W1, L*(2R+1)).
// Levels are fp32 or bf16 (the mixed-precision volume is stored in bf16);
// the arithmetic is fp32 and the output is rounded once to the level
// dtype, as the TPU kernel does.  The quantized tier's levels are int8 or
// float8_e4m3fn codes (the 1-byte pyramid of lookup_pyramid_fused_q):
// each bin is upcast to fp32 exactly on load, the output is fp32, and
// the caller multiplies each level's taps by its scale (sampling is
// linear, so scaling after it is the dequantization).
//
// Bound: memory.  Each (pixel, level) reads the 2R+2 neighbouring bins
// its window touches and writes 2R+1 values; there is no arithmetic to
// speak of: 2.65 us at the KITTI shape (96 rows x 312, W2 312/156/78/39,
// R 4, fp32: the touched bins, the centers and 4.3 MB of output).  The TPU
// kernel sweeps a hat function over the whole W2 axis because the TPU
// vector unit has no gather; here each output is a direct 2-bin gather,
// as in the original CUDA sampler.
//
// Design.  An earlier kernel ran one thread per output value: a 64-bit
// divide and modulo per output, the center and then the bins as dependent
// loads per output, and scalar stores; by CUDA-graph replay it took 0.0446
// ms at the KITTI shape, slower than F.grid_sample over the four levels.
// Now one thread takes one (pixel, level) with 32-bit index arithmetic
// (64-bit only in pointer offsets): the L threads of a pixel are adjacent
// lanes, so its center is one load for all of them; c/2^l is an exact
// multiplication by 2^-l (as ldexpf, and as the plain version's division);
// the window's 2R+4 bins (tap 0's x0 - 1 to tap 2R's x0 + 2: the fp32 sum
// c/2^l + k - R may move a tap's x0 by one) are loaded together before any
// tap is formed, each tap taking its two bins by a compile-time select; the
// block stages its pixels' L*(2R+1) outputs in shared memory and writes
// them as 16-byte vectors (a block covers a multiple of 16 pixels, so its
// output starts 16-byte aligned).  All levels go in one launch: their
// pointers and widths travel by value in the kernel's parameter block.
// By graph replay it takes 0.017 ms at the KITTI shape (H100 80GB HBM3,
// 700 W, chip_smoke.py phase 4), 2.5x faster than F.grid_sample over the
// four levels; a replay of one one-element kernel alone reads 0.014 ms
// there.
//
// The backward (corr_lookup_bwd_kernel) replaces the TPU kernels
// _bwd_kernel_multi (all levels in one launch) and _bwd_kernel (one level
// per launch): the transpose of the forward, dV_l[x] = sum_k g_k *
// hat_k(x), with no gradient for the centers.  The TPU builds the hat
// field over every W2 bin and multiply-accumulates it, because it has no
// scatter.  Here each pixel owns its dV row at every level, so there are no
// atomics: tap k adds (1-t)*g_k to bin x0 and t*g_k to bin x0+1 (the same
// x0, t as the forward), bins outside [0, W2_l - 1] are dropped, and every
// other bin of the row is written as zero.  One warp per pixel: lanes 0..2R
// compute their tap's x0, t and g into shared memory, then the lanes stride
// over the row's bins, so the writes are coalesced, and a bin inside the
// window sums its (at most two) taps in tap order, in fp32, rounded once to
// the level dtype.
//
// Bound: memory.  The kernel must write every bin of every dV row
// (W2_0 + ... + W2_{L-1} values per pixel) and read only 2R+1 cotangents
// and one center per pixel and level: at the default training shape
// (640 rows x 180 pixels, W2 180/90/45/22) that is 155 MB written.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kMaxRadius = 8;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kMaxBins = 2 * kMaxRadius + 4;  // the forward's window
constexpr int kBwdWarps = kThreads / 32;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline float to_float(int8_t x) { return (float)x; }
__device__ inline float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
struct Levels {
  const T* vol[kMaxLevels];
  int w2[kMaxLevels];
};

// Pixels per forward block: a multiple of 16 with levels x pixels <= 256.
inline int fwd_block_pixels(int levels) {
  return (kThreads / levels) / 16 * 16;
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(const __grid_constant__ Levels<T> lv, int levels,
                   const float* __restrict__ coords, OutT* __restrict__ out,
                   int pixels, int radius, int block_pixels) {
  // The block's outputs, pixel-major as in `out` (at most 256 (pixel,
  // level) pairs of at most 2R+1 taps).
  __shared__ __align__(16) OutT staged[kThreads * kMaxTaps];
  const int taps = 2 * radius + 1;
  const int per_pixel = levels * taps;
  const int p0 = blockIdx.x * block_pixels;
  const int np = min(block_pixels, pixels - p0);
  const int lp = threadIdx.x / levels;
  const int l = threadIdx.x - lp * levels;
  if (lp < np) {
    const int p = p0 + lp;
    const int w2 = lv.w2[l];
    // c / 2^l, exact in fp32 (2^-l built from its exponent bits).
    const float xc = __ldg(coords + p) * __int_as_float((127 - l) << 23);
    OutT* o = staged + lp * per_pixel + l * taps;
    if (!(xc > -(float)(radius + 2) && xc < (float)(w2 + radius + 1))) {
      // The window lies wholly outside [0, W2 - 1].
      for (int k = 0; k < taps; ++k) store(o + k, 0.f);
    } else {
      const T* row = lv.vol[l] + (long long)p * w2;
      const int base = (int)floorf(xc + (float)(-radius)) - 1;
      float b[kMaxBins];
#pragma unroll
      for (int j = 0; j < kMaxBins; ++j) {
        const int bin = base + j;
        b[j] = (j < taps + 3 && bin >= 0 && bin < w2) ? to_float(row[bin])
                                                      : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kMaxTaps; ++k) {
        if (k < taps) {
          const float x = xc + (float)(k - radius);
          const float x0 = floorf(x);
          const float t = x - x0;
          // x0 - base - k is 0, 1 or 2: fp32 rounding moves a tap's x0
          // by at most one from floor(c/2^l - R) + k.
          const int d = (int)x0 - base - k;
          const float v0 = d == 0 ? b[k] : d == 1 ? b[k + 1] : b[k + 2];
          const float v1 =
              d == 0 ? b[k + 1] : d == 1 ? b[k + 2] : b[k + 3];
          store(o + k, v0 * (1.f - t) + v1 * t);
        }
      }
    }
  }
  __syncthreads();
  // The block's outputs are one contiguous, 16-byte aligned run of `out`.
  constexpr int kV = 16 / sizeof(OutT);
  const int n = max(np, 0) * per_pixel;
  OutT* dst = out + (long long)p0 * per_pixel;
  for (int i = threadIdx.x; i < n / kV; i += kThreads)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(staged)[i];
  for (int i = n / kV * kV + threadIdx.x; i < n; i += kThreads)
    dst[i] = staged[i];
}

template <typename T, typename OutT = T>
int launch(const void* const* vols, const int* w2s, int levels,
           const float* coords, void* out, long long pixels, int radius,
           void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || pixels > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Levels<T> lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.vol[l] = static_cast<const T*>(vols[l]);
    lv.w2[l] = w2s[l];
  }
  if (pixels == 0) return (int)cudaSuccess;
  const int block_pixels = fwd_block_pixels(levels);
  const long long blocks = (pixels + block_pixels - 1) / block_pixels;
  corr_lookup_kernel<T, OutT><<<(unsigned)blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      lv, levels, coords, static_cast<OutT*>(out), (int)pixels, radius,
      block_pixels);
  return (int)cudaGetLastError();
}

template <typename T>
struct GradLevels {
  T* dvol[kMaxLevels];
  int w2[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_bwd_kernel(GradLevels<T> lv, int levels,
                       const float* __restrict__ coords,
                       const T* __restrict__ g, long long pixels,
                       int radius) {
  __shared__ float s_x0[kBwdWarps][kMaxTaps];
  __shared__ float s_t[kBwdWarps][kMaxTaps];
  __shared__ float s_g[kBwdWarps][kMaxTaps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p = (long long)blockIdx.x * kBwdWarps + warp;
  if (p >= pixels) return;  // no block-wide barrier follows
  const int taps = 2 * radius + 1;
  const float c = coords[p];
  const T* gp = g + p * (long long)(levels * taps);
  for (int l = 0; l < levels; ++l) {
    const int w2 = lv.w2[l];
    if (lane < taps) {
      // c / 2^l is exact in fp32, as in the forward and the plain version.
      const float x = ldexpf(c, -l) + (float)(lane - radius);
      const float x0 = floorf(x);
      s_x0[warp][lane] = x0;
      s_t[warp][lane] = x - x0;
      s_g[warp][lane] = to_float(gp[l * taps + lane]);
    }
    __syncwarp();
    // The window's bins: from the smallest x0 to the largest x0 + 1.
    float lo = s_x0[warp][0], hi = s_x0[warp][0];
    for (int k = 1; k < taps; ++k) {
      lo = fminf(lo, s_x0[warp][k]);
      hi = fmaxf(hi, s_x0[warp][k]);
    }
    hi += 1.f;
    T* row = lv.dvol[l] + p * (long long)w2;
    for (int b = lane; b < w2; b += 32) {
      const float fb = (float)b;
      float acc = 0.f;
      if (fb >= lo && fb <= hi) {
        for (int k = 0; k < taps; ++k) {
          const float x0 = s_x0[warp][k];
          if (x0 == fb) {
            acc += (1.f - s_t[warp][k]) * s_g[warp][k];
          } else if (x0 + 1.f == fb) {
            acc += s_t[warp][k] * s_g[warp][k];
          }
        }
      }
      store(row + b, acc);
    }
    __syncwarp();  // the next level rewrites this warp's taps
  }
}

template <typename T>
int launch_bwd(void* const* dvols, const int* w2s, int levels,
               const float* coords, const void* g, long long pixels,
               int radius, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius)
    return (int)cudaErrorInvalidValue;
  GradLevels<T> lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.dvol[l] = static_cast<T*>(dvols[l]);
    lv.w2[l] = w2s[l];
  }
  if (pixels == 0) return (int)cudaSuccess;
  const long long blocks = (pixels + kBwdWarps - 1) / kBwdWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  corr_lookup_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      lv, levels, coords, static_cast<const T*>(g), pixels, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// vols: host array of `levels` device pointers, each (rows, w1, w2s[l])
// contiguous, all of one dtype; coords (rows, w1) fp32; out (rows, w1,
// levels*(2*radius+1)) in the levels' dtype.
extern "C" int raft_corr_lookup(const void* const* vols, const int* w2s,
                                int levels, const float* coords, void* out,
                                long long pixels, int radius, void* stream) {
  return launch<float>(vols, w2s, levels, coords, out, pixels, radius,
                       stream);
}

extern "C" int raft_corr_lookup_bf16(const void* const* vols, const int* w2s,
                                     int levels, const float* coords,
                                     void* out, long long pixels, int radius,
                                     void* stream) {
  return launch<__nv_bfloat16>(vols, w2s, levels, coords, out, pixels,
                               radius, stream);
}

// Quantized levels: int8 or float8_e4m3fn codes, out fp32 (raw samples of
// the codes; the caller applies the per-level scales).
extern "C" int raft_corr_lookup_q_int8(const void* const* vols,
                                       const int* w2s, int levels,
                                       const float* coords, void* out,
                                       long long pixels, int radius,
                                       void* stream) {
  return launch<int8_t, float>(vols, w2s, levels, coords, out, pixels,
                               radius, stream);
}

extern "C" int raft_corr_lookup_q_fp8(const void* const* vols,
                                      const int* w2s, int levels,
                                      const float* coords, void* out,
                                      long long pixels, int radius,
                                      void* stream) {
  return launch<__nv_fp8_e4m3, float>(vols, w2s, levels, coords, out,
                                      pixels, radius, stream);
}

// Backward: g (rows, w1, levels*(2*radius+1)) and coords (rows, w1) fp32
// -> dvols, a host array of `levels` device pointers, level l (rows, w1,
// w2s[l]), every bin written.  g and the levels share one dtype.
extern "C" int raft_corr_lookup_bwd(void* const* dvols, const int* w2s,
                                    int levels, const float* coords,
                                    const void* g, long long pixels,
                                    int radius, void* stream) {
  return launch_bwd<float>(dvols, w2s, levels, coords, g, pixels, radius,
                           stream);
}

extern "C" int raft_corr_lookup_bwd_bf16(void* const* dvols, const int* w2s,
                                         int levels, const float* coords,
                                         const void* g, long long pixels,
                                         int radius, void* stream) {
  return launch_bwd<__nv_bfloat16>(dvols, w2s, levels, coords, g, pixels,
                                   radius, stream);
}
