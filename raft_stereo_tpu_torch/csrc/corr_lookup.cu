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
// scatter.  Here each dV element is computed where it is stored, so there
// are no atomics: tap k adds (1-t)*g_k to bin x0 and t*g_k to bin x0+1
// (the same x0, t as the forward), bins outside [0, W2_l - 1] are dropped,
// and every other bin of the row is written as zero.
//
// Bound: memory.  The kernel must write every bin of every dV row
// (W2_0 + ... + W2_{L-1} values per pixel) and read only 2R+1 cotangents
// and one center per pixel and level: at the default training shape
// (640 rows x 180 pixels, W2 180/90/45/22) that is 155 MB written, 172 MB
// moved, 0.051 ms at 3.35 TB/s.
//
// Design: output-stationary over a flat index space.  Each level's dV is
// one flat array of pixels x W2_l elements; all levels go in one launch,
// their pointers, widths and block counts in the parameter block.  A
// block takes up to 4096 consecutive 16-byte runs of one level (4 fp32 or
// 8 bf16 values; at most 128 pixels), so every thread writes whole runs
// with vector stores, whatever W2_l is (a run may span two pixels; rows
// need no alignment).  Before any store it loads its pixels' centers and
// cotangents in one batch, and a thread per pixel sums the forward's
// window (the 2R+4 bins from floor(c/2^l - R) - 1): tap k, in ascending
// k, adds (1-t) g_k to the bin of its x0 and t g_k to the next, each with
// one fma in fp32.  Per bin those are the sums, in the order, of the
// warp-per-pixel kernel it replaced, so the result is bit-equal to it.  A
// run then only looks its bins up: 0 outside the window, the window's sum
// inside, one index per run where the run lies in one pixel's row.  Pixel
// and bin come from one 32-bit division by W2_l as a precomputed multiply
// and shift.
//
// What held the warp-per-pixel kernel back: it took 0.246 ms by graph
// replay at the training shape (H100 80GB HBM3, 700 W), 4.7x a memset of
// dV, and most of that time stayed with its tap scans removed: one pixel's
// levels in series behind dependent loads, not its stores.  A first flat
// kernel that formed each bin's taps as it stored lost most of the gain
// to divergence (a warp whose runs met a window paid the taps in every
// lane); staging the window sums per block removed that.  What is left
// is the latency of each block's loads of centers and cotangents: the
// kernel without its stores takes most of its time
// (tools/torch_kernel_variants.py; PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kMaxRadius = 8;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kMaxBins = 2 * kMaxRadius + 4;  // the forward's window

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

// 32-bit division by a fixed divisor as a multiply and shift (numerators
// below 2^31): q = umulhi(n, mul) >> shift, with mul = ceil(2^(31 +
// ceil(log2 d)) / d) and shift = ceil(log2 d) - 1, and q = n for d = 1.
struct FastDiv {
  unsigned mul;
  int shift;
  int d;
};

inline FastDiv fast_div(int d) {
  FastDiv f = {0u, 0, d};
  if (d > 1) {
    int lg = 0;
    while ((1ll << lg) < d) ++lg;
    f.mul = (unsigned)(((1ull << (31 + lg)) + (unsigned)d - 1) / (unsigned)d);
    f.shift = lg - 1;
  }
  return f;
}

__device__ inline int div_by(unsigned n, const FastDiv& f) {
  return f.d == 1 ? (int)n : (int)(__umulhi(n, f.mul) >> f.shift);
}

// A backward block's pixels at most (their centers, window starts,
// cotangents and window sums are staged in shared memory).
constexpr int kBwdThreads = 256;
constexpr int kBwdPixels = 128;
constexpr int kBwdMaxRuns = 4096;  // 16-byte runs per block
// The window start of a pixel whose window lies outside its row: so low
// that no bin falls in the window.
constexpr int kOutside = -0x40000000;

template <typename T>
struct GradLevels {
  T* dvol[kMaxLevels];
  FastDiv w2[kMaxLevels];
  long long size[kMaxLevels];        // pixels * W2_l elements
  long long runs[kMaxLevels];        // 16-byte runs of level l
  int block_runs[kMaxLevels];        // runs per block of level l
  long long block0[kMaxLevels + 1];  // first block of level l
};

__device__ inline void store_run(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store_run(__nv_bfloat16* p, const float* v) {
  union {
    uint4 u;
    __nv_bfloat162 h[4];
  } q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q.u;
}

// The pixel of flat element e of a level (e below 2^31: one multiply and
// shift).
__device__ inline long long pixel_of(long long e, const FastDiv& w2) {
  return e <= 0x7fffffffLL ? (long long)div_by((unsigned)e, w2) : e / w2.d;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
corr_lookup_bwd_kernel(const __grid_constant__ GradLevels<T> lv, int levels,
                       const float* __restrict__ coords,
                       const T* __restrict__ g, int radius) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte run
  __shared__ float s_xc[kBwdPixels];
  __shared__ int s_base[kBwdPixels];
  __shared__ float s_g[kBwdPixels * kMaxTaps];
  __shared__ float s_w[kBwdPixels * (kMaxBins + 1)];
  int l = 0;
  while (blockIdx.x >= lv.block0[l + 1]) ++l;
  const FastDiv w2 = lv.w2[l];
  const long long run0 = (blockIdx.x - lv.block0[l]) * lv.block_runs[l];
  const long long run1 = min(run0 + lv.block_runs[l], lv.runs[l]);
  const long long p0 = pixel_of(run0 * kV, w2);
  const int np =
      (int)(pixel_of(min(run1 * kV, lv.size[l]) - 1, w2) - p0) + 1;
  const int taps = 2 * radius + 1;
  const int nbin = taps + 3;  // the forward's window: base .. base+2R+3
  const int ws = nbin + 1;    // an odd stride
  // The block's pixels: one batch of loads, before any store.
  for (int i = threadIdx.x; i < np; i += kBwdThreads) {
    // c / 2^l is exact in fp32, as in the forward and the plain version.
    const float xc =
        __ldg(coords + p0 + i) * __int_as_float((127 - l) << 23);
    const bool inside =
        xc > -(float)(radius + 2) && xc < (float)(w2.d + radius + 1);
    s_xc[i] = xc;
    s_base[i] = inside ? (int)floorf(xc + (float)(-radius)) - 1 : kOutside;
  }
  for (int i = threadIdx.x; i < np * taps; i += kBwdThreads) {
    const int q = i / taps;
    s_g[i] = to_float(
        __ldg(g + ((p0 + q) * levels + l) * taps + (i - q * taps)));
  }
  __syncthreads();
  // Each window bin's sum: tap k adds (1-t) g_k to the bin of its x0 and
  // t g_k to the next (x0 lies within one of floor(c/2^l - R) + k, so both
  // fall in the window), taps in ascending k: per bin the sums, and the
  // order, of the warp-per-pixel kernel this replaced.
  for (int q = threadIdx.x; q < np; q += kBwdThreads) {
    float* w = s_w + q * ws;
    for (int j = 0; j < nbin; ++j) w[j] = 0.f;
    const int base = s_base[q];
    const float xc = s_xc[q];
    for (int k = 0; base != kOutside && k < taps; ++k) {
      const float x = xc + (float)(k - radius);
      const float x0 = floorf(x);
      const float t = x - x0;
      const float gk = s_g[q * taps + k];
      const int j = (int)x0 - base;
      if (j >= 0 && j + 1 < nbin) {
        w[j] = fmaf(1.f - t, gk, w[j]);
        w[j + 1] = fmaf(t, gk, w[j + 1]);
      }
    }
  }
  __syncthreads();
  // The runs: a bin inside its pixel's window takes the window's sum,
  // every other bin 0.
  for (long long run = run0 + threadIdx.x; run < run1; run += kBwdThreads) {
    const long long e0 = run * kV;
    const int n = (int)min((long long)kV, lv.size[l] - e0);
    const long long p = pixel_of(e0, w2);
    int b = (int)(e0 - p * w2.d);
    int q = (int)(p - p0);
    float v[kV];
    if (n == kV && b + kV <= w2.d) {
      // The run lies in one pixel's row: zeros unless it meets the window.
      const int j0 = b - s_base[q];
      const float* w = s_w + q * ws;
#pragma unroll
      for (int i = 0; i < kV; ++i)
        v[i] = (unsigned)(j0 + i) < (unsigned)nbin ? w[j0 + i] : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int j = b - s_base[q];
        v[i] = (unsigned)j < (unsigned)nbin ? s_w[q * ws + j] : 0.f;
        if (++b == w2.d) {
          b = 0;
          q = min(q + 1, np - 1);
        }
      }
    }
    T* dst = lv.dvol[l] + e0;
    if (n == kV) {
      store_run(dst, v);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (i < n) store(dst + i, v[i]);
    }
  }
}

template <typename T>
int launch_bwd(void* const* dvols, const int* w2s, int levels,
               const float* coords, const void* g, long long pixels,
               int radius, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || pixels < 0)
    return (int)cudaErrorInvalidValue;
  GradLevels<T> lv = {};
  lv.block0[0] = 0;
  for (int l = 0; l < levels; ++l) {
    if (w2s[l] < 0 || reinterpret_cast<uintptr_t>(dvols[l]) % 16)
      return (int)cudaErrorInvalidValue;
    const int w2 = w2s[l] > 0 ? w2s[l] : 1;
    lv.dvol[l] = static_cast<T*>(dvols[l]);
    lv.w2[l] = fast_div(w2);
    lv.size[l] = w2s[l] > 0 ? pixels * w2s[l] : 0;
    lv.runs[l] = (lv.size[l] + kV - 1) / kV;
    // A block's runs span at most kBwdPixels pixels.
    lv.block_runs[l] = (int)std::max(
        1LL, std::min((long long)kBwdMaxRuns,
                      ((kBwdPixels - 2) * (long long)w2 + 1) / kV));
    lv.block0[l + 1] =
        lv.block0[l] + (lv.runs[l] + lv.block_runs[l] - 1) / lv.block_runs[l];
  }
  const long long blocks = lv.block0[levels];
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  corr_lookup_bwd_kernel<T><<<(unsigned)blocks, kBwdThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      lv, levels, coords, static_cast<const T*>(g), radius);
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
