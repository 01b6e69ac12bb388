// Correlation-pyramid window lookup for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels raft_stereo_tpu/kernels/corr_lookup.py
// _fwd_kernel_multi (all levels in one launch) and _fwd_kernel (one level
// per launch): for every pyramid level l and tap k the volume row of pixel
// (r, w1) is sampled at x = c/2^l + k - R with linear interpolation, zero
// outside [0, W2_l - 1].  Output is level-major, (rows, W1, L*(2R+1)).
// Levels are fp32 or bf16 (the mixed-precision volume is stored in bf16);
// the arithmetic is fp32 and the output is rounded once to the level
// dtype, as the TPU kernel does.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Levels<T> lv, int levels, const float* __restrict__ coords,
                   T* __restrict__ out, long long pixels, int radius) {
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

template <typename T>
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
  corr_lookup_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lv, levels, coords, static_cast<T*>(out), pixels, radius);
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
