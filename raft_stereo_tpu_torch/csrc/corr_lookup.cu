// Correlation-pyramid window lookup for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels raft_stereo_tpu/kernels/corr_lookup.py
// _fwd_kernel_multi (all levels in one launch) and _fwd_kernel (one level
// per launch): for every pyramid level l and tap k the volume row of pixel
// (r, w1) is sampled at x = c/2^l + k - R with linear interpolation, zero
// outside [0, W2_l - 1].  Output is level-major, (rows, W1, L*(2R+1)).
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  const float* vol[kMaxLevels];
  int w2[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Levels lv, int levels, const float* __restrict__ coords,
                   float* __restrict__ out, long long pixels, int radius) {
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
    const float* row = lv.vol[l] + p * (long long)w2;
    // c / 2^l is exact in fp32, as in the plain version.
    const float x = ldexpf(coords[p], -l) + (float)(k - radius);
    const float x0 = floorf(x);
    const float t = x - x0;
    const float hi = (float)(w2 - 1);
    const float v0 = (x0 >= 0.f && x0 <= hi) ? row[(int)x0] : 0.f;
    const float v1 = (x0 + 1.f >= 0.f && x0 + 1.f <= hi) ? row[(int)x0 + 1]
                                                          : 0.f;
    out[i] = v0 * (1.f - t) + v1 * t;
  }
}

}  // namespace

// vols: host array of `levels` device pointers, each (rows, w1, w2s[l])
// fp32 contiguous; coords (rows, w1); out (rows, w1, levels*(2*radius+1)).
extern "C" int raft_corr_lookup(const void* const* vols, const int* w2s,
                                int levels, const float* coords, float* out,
                                long long pixels, int radius, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.vol[l] = static_cast<const float*>(vols[l]);
    lv.w2[l] = w2s[l];
  }
  const long long total = pixels * levels * (2 * radius + 1);
  if (total == 0) return (int)cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  corr_lookup_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lv, levels, coords, out, pixels, radius);
  return (int)cudaGetLastError();
}
