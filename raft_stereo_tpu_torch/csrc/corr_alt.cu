// No-volume ("alt") window correlation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels raft_stereo_tpu/kernels/corr_alt.py
// _fwd_multi_kernel (all levels in one launch, entry alt_lookup_fused) and
// _fwd_kernel (one level per launch, via _alt_level).  For every level l of
// the W-pooled right-feature pyramid and every tap k of pixel p:
//
//     out[p, l*K + k] = (1-t) * s*<f1[p], f2_l[x0]> + t * s*<f1[p], f2_l[x0+1]>
//
// with x = c[p]/2^l + k - R, x0 = floor(x), t = x - x0, s = 1/sqrt(D), and a
// bin outside [0, W2_l - 1] contributing 0: term for term the hat sum the
// TPU kernel sweeps over its volume tile (corr_lookup.py hat_sample).  Dots
// accumulate in fp32 (bf16 x bf16 products are exact in fp32), each dot is
// scaled by s before it is weighted, and the output is rounded once to the
// feature dtype.
//
// Bound: memory, and in practice load latency.  The TPU kernel computes a
// whole (W1-block x W2) volume tile on the MXU because it has no gather.
// Here a pixel needs only the 2R+2 bins its window touches per level: ten
// dot products of length D at R = 4, 153 MFLOP per realtime call against
// 11.6 MB of inputs and output.  Design: one warp per output pixel.  Lanes
// split D into 16-byte vectors, so one bin of f2 is one coalesced load (512
// bytes in bf16 at D = 256), and the pixel's f1 row stays in registers for
// every level.  A level's bins are all loaded before any is reduced, so
// their loads are in flight together; each dot is then summed across the
// warp with shuffles and staged in shared memory, where lanes 0..2R read
// the two bins of their tap.  The eight warps of a block take neighbouring
// pixels of one row, whose windows overlap, so most f2 loads hit L1.  All
// levels go in one launch: their pointers and widths travel by value in
// the kernel's parameter block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;
// The 2R+2 bins of a window, plus one on each side: x = c/2^l + k - R is
// rounded in fp32, which can move floor(x) of the end taps by one.
constexpr int kMaxBins = 2 * kMaxRadius + 4;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVecPerLane = 2;  // D <= 64 vectors of 16 bytes

// 16 bytes of T as fp32 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    union {
      uint4 u;
      __nv_bfloat162 h[4];
    } q;
    q.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(q.h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 round(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T>
struct Levels {
  const T* f2[kMaxLevels];
  int w2[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_alt_kernel(const T* __restrict__ f1, Levels<T> lv, int levels,
                const float* __restrict__ coords, T* __restrict__ out,
                long long pixels, int w1, int d, int radius, float scale) {
  constexpr int kN = Vec<T>::kN;
  __shared__ float dots[kWarps][kMaxBins];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= pixels) return;  // no block-wide barrier follows
  const long long row = p / w1;
  const int nvec = d / kN;

  float a[kMaxVecPerLane][kN];
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      Vec<T>::load(f1 + p * d + c * kN, a[i]);
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) a[i][e] = 0.f;
    }
  }

  const float center = coords[p];
  const int taps = 2 * radius + 1;
  T* o = out + p * (long long)(levels * taps);
  for (int l = 0; l < levels; ++l) {
    const int w2 = lv.w2[l];
    // c / 2^l is exact in fp32, as in the plain version.
    const float xc = ldexpf(center, -l);
    // A window wholly outside [0, W2-1] reads nothing and gives zeros.
    if (!(xc > -(float)(radius + 2) && xc < (float)(w2 + radius + 1))) {
      if (lane < taps) o[l * taps + lane] = Vec<T>::round(0.f);
      continue;
    }
    // Bins from tap 0's x0 to tap 2R's x0 + 1, each computed as the taps
    // compute it, so every tap finds both of its bins in the window.
    const int base = (int)floorf(xc + (float)(-radius));
    const int nbins =
        min((int)floorf(xc + (float)radius) + 2 - base, kMaxBins);
    const T* f2 = lv.f2[l] + row * (long long)w2 * d;

    float s[kMaxBins];
#pragma unroll
    for (int j = 0; j < kMaxBins; ++j) {
      s[j] = 0.f;
      const int bin = base + j;
      if (j < nbins && bin >= 0 && bin < w2) {
#pragma unroll
        for (int i = 0; i < kMaxVecPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < nvec) {
            float b[kN];
            Vec<T>::load(f2 + (long long)bin * d + c * kN, b);
#pragma unroll
            for (int e = 0; e < kN; ++e) s[j] = fmaf(a[i][e], b[e], s[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxBins; ++j) {
      if (j < nbins) {  // the same for every lane of the warp
        float v = s[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) dots[warp][j] = v * scale;
      }
    }
    __syncwarp();
    if (lane < taps) {
      const float x = xc + (float)(lane - radius);
      const float x0 = floorf(x);
      const float t = x - x0;
      const int j0 = (int)x0 - base;
      const float hi = (float)(w2 - 1);
      const float v0 = (x0 >= 0.f && x0 <= hi && j0 >= 0 && j0 < nbins)
                           ? dots[warp][j0]
                           : 0.f;
      const float v1 =
          (x0 + 1.f >= 0.f && x0 + 1.f <= hi && j0 + 1 >= 0 && j0 + 1 < nbins)
              ? dots[warp][j0 + 1]
              : 0.f;
      o[l * taps + lane] = Vec<T>::round(v0 * (1.f - t) + v1 * t);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* f1, const void* const* f2s, const int* w2s,
           int levels, const float* coords, void* out, long long pixels,
           int w1, int d, int radius, float scale, void* stream) {
  constexpr int kN = Vec<T>::kN;
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || w1 < 1 || d < kN || d % kN ||
      d > 32 * kMaxVecPerLane * kN)
    return (int)cudaErrorInvalidValue;
  if (pixels == 0) return (int)cudaSuccess;
  Levels<T> lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.f2[l] = static_cast<const T*>(f2s[l]);
    lv.w2[l] = w2s[l];
  }
  const long long blocks = (pixels + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  corr_alt_kernel<T><<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f1), lv, levels, coords, static_cast<T*>(out),
      pixels, w1, d, radius, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f1: (rows, w1, d); f2s: host array of `levels` device pointers, level l
// (rows, w2s[l], d); coords: (rows, w1) fp32; out: (rows, w1,
// levels*(2*radius+1)).  Features and out share one dtype, contiguous;
// pixels = rows * w1; scale = 1/sqrt(d).
extern "C" int raft_corr_alt_f32(const void* f1, const void* const* f2s,
                                 const int* w2s, int levels,
                                 const float* coords, void* out,
                                 long long pixels, int w1, int d, int radius,
                                 float scale, void* stream) {
  return launch<float>(f1, f2s, w2s, levels, coords, out, pixels, w1, d,
                       radius, scale, stream);
}

extern "C" int raft_corr_alt_bf16(const void* f1, const void* const* f2s,
                                  const int* w2s, int levels,
                                  const float* coords, void* out,
                                  long long pixels, int w1, int d, int radius,
                                  float scale, void* stream) {
  return launch<__nv_bfloat16>(f1, f2s, w2s, levels, coords, out, pixels, w1,
                               d, radius, scale, stream);
}
