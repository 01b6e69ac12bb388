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
//
// The quantized tier (corr_alt_q_*, replacing _launch_fwd_multi_q, the
// entry alt_lookup_fused_q) runs the same kernel over int8 or
// float8_e4m3fn feature codes: one 16-byte vector is 16 codes, upcast to
// fp32 on load (exactly), the dots accumulate in fp32 and the output is
// fp32, the raw correlation of the codes times 1/sqrt(D); the caller
// multiplies each level's taps by s1*s2_l.  For int8 every dot is an
// exact integer in fp32 (256 * 127^2 < 2^24), so only the interpolation
// rounds.  The 1-byte features halve the bytes of bf16 (6.6 MB per
// realtime call instead of 11.6).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  __device__ static float to_float(float x) { return x; }
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
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

// 16 one-byte codes: int8 or float8_e4m3fn, each exact in fp32.
template <>
struct Vec<int8_t> {
  static constexpr int kN = 16;
  __device__ static void load(const int8_t* p, float* v) {
    union {
      uint4 u;
      int8_t b[16];
    } q;
    q.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = (float)q.b[i];
  }
};

template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int kN = 16;
  __device__ static void load(const __nv_fp8_e4m3* p, float* v) {
    union {
      uint4 u;
      __nv_fp8_storage_t b[16];
    } q;
    q.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      __nv_fp8_e4m3 e;
      e.__x = q.b[i];
      v[i] = static_cast<float>(e);
    }
  }
};

// The output: the feature dtype, or fp32 for the quantized tier.
__device__ inline void store_out(float* p, float v) { *p = v; }
__device__ inline void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
struct Levels {
  const T* f2[kMaxLevels];
  int w2[kMaxLevels];
};

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
corr_alt_kernel(const T* __restrict__ f1, Levels<T> lv, int levels,
                const float* __restrict__ coords, OutT* __restrict__ out,
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
  OutT* o = out + p * (long long)(levels * taps);
  for (int l = 0; l < levels; ++l) {
    const int w2 = lv.w2[l];
    // c / 2^l is exact in fp32, as in the plain version.
    const float xc = ldexpf(center, -l);
    // A window wholly outside [0, W2-1] reads nothing and gives zeros.
    if (!(xc > -(float)(radius + 2) && xc < (float)(w2 + radius + 1))) {
      if (lane < taps) store_out(o + l * taps + lane, 0.f);
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
      store_out(o + l * taps + lane, v0 * (1.f - t) + v1 * t);
    }
    __syncwarp();
  }
}

template <typename T, typename OutT = T>
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
  corr_alt_kernel<T, OutT><<<(unsigned)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f1), lv, levels, coords,
      static_cast<OutT*>(out), pixels, w1, d, radius, scale);
  return (int)cudaGetLastError();
}

template <typename T>
struct GradLevels {
  T* df2[kMaxLevels];
  int w2[kMaxLevels];
  int offset[kMaxLevels];  // first bin of level l in the block's df2
};

constexpr int kBwdChannels = 32;  // channels per block, one per lane
constexpr int kBwdTile = 32;      // pixels per tile, one per lane

// Shared bytes of one backward block: the row's df2 of every level, the
// levels' df1 partials of a tile, and the tile's window weights and bases.
inline size_t bwd_smem_bytes(int wsum, int levels, int radius) {
  const int max_bins = 2 * radius + 4;
  return sizeof(float) * ((size_t)wsum * kBwdChannels +
                          (size_t)levels * kBwdTile * kBwdChannels +
                          (size_t)levels * kBwdTile * max_bins) +
         sizeof(int) * 2 * (size_t)levels * kBwdTile;
}

template <typename T>
__global__ void corr_alt_bwd_kernel(const T* __restrict__ f1, Levels<T> lv,
                                    GradLevels<T> glv, int levels, int wsum,
                                    const float* __restrict__ coords,
                                    const T* __restrict__ g,
                                    T* __restrict__ df1, int w1, int d,
                                    int radius, float scale) {
  extern __shared__ float smem[];
  const int max_bins = 2 * radius + 4;
  const int taps = 2 * radius + 1;
  const int l = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = blockIdx.x;
  const int ch = blockIdx.y * kBwdChannels + lane;
  const bool has_ch = ch < d;
  const int w2 = lv.w2[l];
  float* acc2 = smem + (size_t)glv.offset[l] * kBwdChannels;  // [w2][32]
  float* part = smem + (size_t)wsum * kBwdChannels;       // [L][tile][32]
  float* wts = part + (size_t)levels * kBwdTile * kBwdChannels;
  int* base = reinterpret_cast<int*>(wts + (size_t)levels * kBwdTile *
                                               max_bins);  // [L][tile]
  int* nbins = base + levels * kBwdTile;                   // [L][tile]
  for (int b = 0; b < w2; ++b) acc2[b * kBwdChannels + lane] = 0.f;
  const T* f2 = lv.f2[l] + row * (long long)w2 * d;

  for (int p0 = 0; p0 < w1; p0 += kBwdTile) {
    // Window weights of pixel p0 + lane at this warp's level.
    {
      const int p = p0 + lane;
      float* w = wts + (size_t)(l * kBwdTile + lane) * max_bins;
      int b0 = 0, nb = 0;
      if (p < w1) {
        const long long pix = row * w1 + p;
        const float xc = ldexpf(coords[pix], -l);
        if (xc > -(float)(radius + 2) && xc < (float)(w2 + radius + 1)) {
          b0 = (int)floorf(xc + (float)(-radius));
          nb = min((int)floorf(xc + (float)radius) + 2 - b0, max_bins);
          for (int j = 0; j < max_bins; ++j) w[j] = 0.f;
          const T* gp = g + pix * (long long)(levels * taps) + l * taps;
          for (int k = 0; k < taps; ++k) {
            const float x = xc + (float)(k - radius);
            const float x0 = floorf(x);
            const float t = x - x0;
            const float gk = Vec<T>::to_float(gp[k]);
            const int j0 = (int)x0 - b0;
            if (x0 >= 0.f && x0 <= (float)(w2 - 1) && j0 >= 0 && j0 < nb)
              w[j0] += (1.f - t) * gk;
            if (x0 + 1.f >= 0.f && x0 + 1.f <= (float)(w2 - 1) &&
                j0 + 1 >= 0 && j0 + 1 < nb)
              w[j0 + 1] += t * gk;
          }
        }
      }
      base[l * kBwdTile + lane] = b0;
      nbins[l * kBwdTile + lane] = nb;
    }
    __syncwarp();
    // Lane = channel: walk the tile's pixels and their bins in order.
    for (int j = 0; j < kBwdTile && p0 + j < w1; ++j) {
      const int nb = nbins[l * kBwdTile + j];
      float a = 0.f;
      if (nb > 0 && has_ch) {
        const int b0 = base[l * kBwdTile + j];
        const float* w = wts + (size_t)(l * kBwdTile + j) * max_bins;
        const float v1 =
            Vec<T>::to_float(f1[(row * w1 + p0 + j) * (long long)d + ch]);
        for (int b = 0; b < nb; ++b) {
          const int bin = b0 + b;
          if (bin < 0 || bin >= w2) continue;
          const float wb = w[b];
          a = fmaf(wb, Vec<T>::to_float(f2[(long long)bin * d + ch]), a);
          float* acc = acc2 + bin * kBwdChannels + lane;
          *acc = fmaf(wb, v1, *acc);
        }
      }
      part[(l * kBwdTile + j) * kBwdChannels + lane] = a;
    }
    __syncthreads();
    // df1 of the tile: the levels' partials summed in level order.
    for (int i = threadIdx.x; i < kBwdTile * kBwdChannels; i += blockDim.x) {
      const int j = i / kBwdChannels;
      const int c = blockIdx.y * kBwdChannels + i % kBwdChannels;
      if (p0 + j < w1 && c < d) {
        float sum = 0.f;
        for (int m = 0; m < levels; ++m)
          sum += part[(m * kBwdTile + j) * kBwdChannels + i % kBwdChannels];
        df1[(row * w1 + p0 + j) * (long long)d + c] =
            Vec<T>::round(sum * scale);
      }
    }
    __syncthreads();  // the next tile rewrites the partials
  }
  // This warp's level of df2 for row r, written once.
  if (has_ch) {
    T* out = glv.df2[l] + row * (long long)w2 * d;
    for (int b = 0; b < w2; ++b)
      out[(long long)b * d + ch] = Vec<T>::round(acc2[b * kBwdChannels + lane] *
                                                 scale);
  }
}

template <typename T>
int launch_bwd(const void* f1, const void* const* f2s, void* const* df2s,
               const int* w2s, int levels, const float* coords,
               const void* g, void* df1, long long rows, int w1, int d,
               int radius, float scale, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || w1 < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  Levels<T> lv = {};
  GradLevels<T> glv = {};
  int wsum = 0;
  for (int l = 0; l < levels; ++l) {
    lv.f2[l] = static_cast<const T*>(f2s[l]);
    lv.w2[l] = w2s[l];
    glv.df2[l] = static_cast<T*>(df2s[l]);
    glv.w2[l] = w2s[l];
    glv.offset[l] = wsum;
    wsum += w2s[l];
  }
  const size_t smem = bwd_smem_bytes(wsum, levels, radius);
  if (smem > 232448 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_alt_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)rows, (unsigned)((d + kBwdChannels - 1) /
                                             kBwdChannels));
  corr_alt_bwd_kernel<T><<<grid, 32 * levels, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f1), lv, glv, levels, wsum, coords,
      static_cast<const T*>(g), static_cast<T*>(df1), w1, d, radius, scale);
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

// Quantized features: int8 or float8_e4m3fn codes (d a multiple of 16),
// out fp32: the raw correlation of the codes times scale.
extern "C" int raft_corr_alt_q_int8(const void* f1, const void* const* f2s,
                                    const int* w2s, int levels,
                                    const float* coords, void* out,
                                    long long pixels, int w1, int d,
                                    int radius, float scale, void* stream) {
  return launch<int8_t, float>(f1, f2s, w2s, levels, coords, out, pixels,
                               w1, d, radius, scale, stream);
}

extern "C" int raft_corr_alt_q_fp8(const void* f1, const void* const* f2s,
                                   const int* w2s, int levels,
                                   const float* coords, void* out,
                                   long long pixels, int w1, int d,
                                   int radius, float scale, void* stream) {
  return launch<__nv_fp8_e4m3, float>(f1, f2s, w2s, levels, coords, out,
                                      pixels, w1, d, radius, scale, stream);
}

// Backward: f1 (rows, w1, d), f2s level l (rows, w2s[l], d), coords
// (rows, w1) fp32, g (rows, w1, levels*(2*radius+1)) -> df1 (rows, w1, d)
// and df2s level l (rows, w2s[l], d), every element written.  Features, g,
// df1 and df2s share one dtype, contiguous; scale = 1/sqrt(d).  A
// launch whose bwd_smem_bytes exceed a block's shared memory returns
// cudaErrorInvalidValue (kernels/corr_alt.py checks it first).
extern "C" int raft_corr_alt_bwd_f32(const void* f1, const void* const* f2s,
                                     void* const* df2s, const int* w2s,
                                     int levels, const float* coords,
                                     const void* g, void* df1,
                                     long long rows, int w1, int d,
                                     int radius, float scale, void* stream) {
  return launch_bwd<float>(f1, f2s, df2s, w2s, levels, coords, g, df1, rows,
                           w1, d, radius, scale, stream);
}

extern "C" int raft_corr_alt_bwd_bf16(const void* f1, const void* const* f2s,
                                      void* const* df2s, const int* w2s,
                                      int levels, const float* coords,
                                      const void* g, void* df1,
                                      long long rows, int w1, int d,
                                      int radius, float scale, void* stream) {
  return launch_bwd<__nv_bfloat16>(f1, f2s, df2s, w2s, levels, coords, g,
                                   df1, rows, w1, d, radius, scale, stream);
}
