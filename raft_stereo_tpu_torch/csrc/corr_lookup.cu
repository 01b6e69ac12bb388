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
// Bound: memory.  Each pixel reads about 2R+2 neighbouring bins per level
// and writes L*(2R+1) values; there is no arithmetic to speak of.  The TPU
// kernel sweeps a hat function over the whole W2 axis because the TPU
// vector unit has no gather; here each output is a direct 2-bin gather,
// as in the original CUDA sampler.  One thread computes one output value,
// and neighbouring threads take neighbouring taps of the same pixel, so a
// warp reads a few contiguous runs of bins and writes contiguous output.
// Every level goes in one launch: the level pointers travel by value in
// the kernel's parameter block.
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
constexpr int kMaxRadius = 8;  // the backward keeps one warp's taps in lanes
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
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

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Levels<T> lv, int levels, const float* __restrict__ coords,
                   OutT* __restrict__ out, long long pixels, int radius) {
  const int taps = 2 * radius + 1;
  const int per_pixel = levels * taps;
  const long long total = pixels * per_pixel;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / per_pixel;
    const int j = (int)(i - p * per_pixel);
    const int l = j / taps;
    const int k = j - l * taps;
    const int w2 = lv.w2[l];
    const T* row = lv.vol[l] + p * (long long)w2;
    // c / 2^l is exact in fp32, as in the plain version.
    const float x = ldexpf(coords[p], -l) + (float)(k - radius);
    const float x0 = floorf(x);
    const float t = x - x0;
    const float hi = (float)(w2 - 1);
    const float v0 =
        (x0 >= 0.f && x0 <= hi) ? to_float(row[(int)x0]) : 0.f;
    const float v1 = (x0 + 1.f >= 0.f && x0 + 1.f <= hi)
                         ? to_float(row[(int)x0 + 1])
                         : 0.f;
    store(out + i, v0 * (1.f - t) + v1 * t);
  }
}

template <typename T, typename OutT = T>
int launch(const void* const* vols, const int* w2s, int levels,
           const float* coords, void* out, long long pixels, int radius,
           void* stream) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels<T> lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.vol[l] = static_cast<const T*>(vols[l]);
    lv.w2[l] = w2s[l];
  }
  const long long total = pixels * levels * (2 * radius + 1);
  if (total == 0) return (int)cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  corr_lookup_kernel<T, OutT><<<(unsigned)blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      lv, levels, coords, static_cast<OutT*>(out), pixels, radius);
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
