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
// Bound: memory.  The TPU kernel computes a whole (W1-block x W2) volume
// tile on the MXU because it has no gather.  Here a pixel needs only the
// 2R+2 bins its window touches per level: ten dot products of length D at
// R = 4, 153 MFLOP per realtime call against 11.6 MB of inputs and output.
//
// Design (corr_alt_fwd_kernel).  A block takes a tile of up to 32
// consecutive pixels of one image row.  It computes each pixel's window
// at every level (the window start floor(c/2^l - R) and its bins, the
// arithmetic of the taps), and per level the band of f2 bins from the
// tile's smallest window start to its largest window end, clipped to the
// row.  The tile's f1 and the bands of every level (one list of band rows,
// level after level, each row's level and bin noted beside it) are copied
// to shared memory with 16-byte cp.async loads, all issued before any
// arithmetic; rows are padded by 16 bytes, so eight rows at one column
// fall in eight different bank groups.  Every (pixel, window bin) dot is
// then computed once, from shared memory, into an fp32 array of window
// dots per pixel and level, and a thread per pixel and level interpolates
// its taps from it with the same fp32 arithmetic as before; the block's
// outputs are staged and written with 16-byte stores.  Any center field
// works: where the bands (up to every bin of every level, when the
// centers are random) do not fit the shared memory that leaves two blocks
// on each SM, they are taken in passes, and where fewer than 160 rows a
// pass fit, D is taken in chunks; partial dots add up in the dots array in
// a fixed order (chunk by chunk; each dot belongs to one pass), so two
// launches agree bit for bit.  kernels/corr_alt.py plan_fwd chooses the
// tile, the chunk and the rows a pass; FwdSmem here mirrors its count.
//
// The dots: bf16, fp8 (each code upcast exactly to bf16 as it lands in
// shared memory) and int8 on the tensor cores, fp32 on the CUDA cores.
// mma.sync multiplies 16-pixel x 16-row blocks of the tile's f1 and the
// band (m16n8k16 bf16 with fp32 sums; m16n8k32 s8 with int32 sums, exact),
// and skips a block that no window of its 16 pixels reaches; where the
// centers rise along the row, as a disparity field's do, the band is the
// tile plus one window and few blocks are wasted.  The same kernel with
// its bf16 dots on the CUDA cores took about twice as long
// (tools/torch_kernel_variants.py; PERF.md section 6).  fp32 stays on the
// CUDA cores for fp32 accuracy: eight threads take one pixel's window at one
// level and split D's 16-byte columns, so they read 128 contiguous bytes
// of a row together; each bin's products are summed in order and the
// eight partial sums by a fixed shuffle tree.  The earlier kernel (one
// warp per pixel, levels in series, each bin reloaded by every window
// that reaches it and reduced with five shuffles; 1-byte features filling
// half the lanes) took 0.051 ms in bf16 and 0.096 ms in int8 a call at
// the realtime shape (H100 80GB HBM3, 700 W, 20 calls per graph replay),
// whatever the centers.
//
// The quantized tier (corr_alt_q_*, replacing _launch_fwd_multi_q, the
// entry alt_lookup_fused_q) runs the same kernel over int8 or
// float8_e4m3fn feature codes: the dots are the raw correlation of the
// codes (exact integers for int8: 1024 * 127^2 < 2^24), the output is
// fp32, the dots times 1/sqrt(D); the caller multiplies each level's taps
// by s1*s2_l.  The 1-byte features halve the bytes of bf16 (6.6 MB per
// realtime call instead of 11.6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;
// The 2R+2 bins of a window, plus one on each side: x = c/2^l + k - R is
// rounded in fp32, which can move floor(x) of the end taps by one.
constexpr int kMaxBins = 2 * kMaxRadius + 4;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The output: the feature dtype, or fp32 for the quantized tier.
__device__ inline void store_out(float* p, float v) { *p = v; }
__device__ inline void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// int8 x int8 into int32: exact.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Sets a kernel's dynamic shared-memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kernel, bool* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  return cudaSuccess;
}

// ------------------------------------------------------------- forward

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdMaxTile = 32;  // two 16-pixel blocks
constexpr int kFwdBandInts = 64;

// Per feature type: the type staged in shared memory and whether the dots
// run on the tensor cores.
template <typename T>
struct FwdTraits;
template <>
struct FwdTraits<float> {
  using S = float;
  static constexpr bool kTensor = false;
};
template <>
struct FwdTraits<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr bool kTensor = true;
};
template <>
struct FwdTraits<int8_t> {
  using S = int8_t;
  static constexpr bool kTensor = true;
};
template <>
struct FwdTraits<__nv_fp8_e4m3> {
  using S = __nv_bfloat16;  // upcast exactly as it lands
  static constexpr bool kTensor = true;
};
template <typename S>
struct TcAcc {
  using type = float;
};
template <>
struct TcAcc<int8_t> {
  using type = int;
};
__device__ __forceinline__ void mma_tc(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  mma_bf16(c, a, b0, b1);
}
__device__ __forceinline__ void mma_tc(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  mma_s8(c, a, b0, b1);
}

// Byte offsets of one forward block's shared memory: the tile's f1 chunk
// (16-pixel blocks), the band's rows (seg of them), each staged row being
// the chunk padded to 32 bytes (one k step) plus 16 bytes; the window
// dots (levels x tile x (2R+5) fp32, an odd stride); each window's
// center, start and bin count; the band table (per level the first and
// last bin, its first row, and the windows' union per 16-pixel block);
// each staged band row's level and bin; the staged outputs (plus up to 16
// bytes of lead).
struct FwdSmem {
  size_t f1, f2, dots, xc, lo, nb, band, rows, outs, total;
  int row_bytes;
  __host__ __device__ FwdSmem(int levels, int radius, int tile, int chunk,
                              int item, int seg, int out_item) {
    row_bytes = (chunk * item + 31) / 32 * 32 + 16;
    const size_t pl = (size_t)levels * tile;
    f1 = 0;
    f2 = f1 + (size_t)(tile + 15) / 16 * 16 * row_bytes;
    dots = f2 + (size_t)seg * row_bytes;
    xc = dots + align16(pl * (2 * radius + 5) * 4);
    lo = xc + align16(pl * 4);
    nb = lo + align16(pl * 4);
    band = nb + align16(pl * 4);
    rows = band + kFwdBandInts * 4;
    outs = rows + (size_t)seg * 4;
    total = outs + align16((size_t)tile * levels * (2 * radius + 1) *
                               out_item + 16);
  }
};

// Shared bytes of one forward launch, 0 for a plan the kernel refuses.
inline size_t fwd_smem_bytes(int levels, int radius, int tile, int chunk,
                             int item, int seg, int out_item) {
  if (tile < 1 || tile > kFwdMaxTile || chunk < 1 || seg < 16 || seg % 16)
    return 0;
  const FwdSmem lay(levels, radius, tile, chunk, item, seg, out_item);
  return lay.total <= kMaxSmem ? lay.total : 0;
}

template <typename T>
struct FwdArgs {
  const T* f1;
  const T* f2[kMaxLevels];
  int w2[kMaxLevels];
  const float* coords;
  void* out;
  int levels, w1, d, radius, tile, chunk, seg, tiles;
  float scale;
};

// The band's level of staged row v (boff: first row of each level).
__device__ __forceinline__ int level_of_row(const int* boff, int v) {
  int l = 0;
  while (v >= boff[l + 1]) ++l;
  return l;
}

// 16 fp8 codes as 16 bf16 values (exact: e4m3 -> f16 -> f32 -> bf16).
__device__ inline void fp8_to_bf16(uint4 q, uint4* dst) {
  const __nv_fp8x2_storage_t* c2 =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&q);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(c2[i], __NV_E4M3);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Start copying the tile's f1 chunk (with_f1) and band rows v0 .. v0+nv-1
// of the chunk [c0, c0+cw) into shared memory with cp.async (fp8 lands
// converted, by plain loads and stores), noting each band row's level and
// bin in rowtab (bin * 8 + level); for the tensor cores, zero each row's
// padding up to the next 32 bytes.
template <typename T>
__device__ void fwd_stage(const FwdArgs<T>& a, unsigned char* f1s,
                          unsigned char* f2s, int rb, long long row,
                          long long pix0, int np, int c0, int cw, int v0,
                          int nv, bool with_f1, const int* blo,
                          const int* boff, int* rowtab) {
  using S = typename FwdTraits<T>::S;
  constexpr int kIn = 16 / sizeof(T);       // source elements per load
  constexpr int kOut = kIn * sizeof(S);     // staged bytes per load
  const int vr = cw / kIn;
  const int n1 = with_f1 ? np : 0;
  // The source of staged row r, and where it lands (its first load notes
  // a band row in rowtab).
  auto locate = [&](int r, bool first, const T*& src, unsigned char*& dst) {
    if (r < n1) {
      src = a.f1 + (pix0 + r) * a.d + c0;
      dst = f1s + r * rb;
    } else {
      const int v = v0 + r - n1;
      const int l = level_of_row(boff, v);
      const int b = blo[l] + v - boff[l];
      src = a.f2[l] + (row * a.w2[l] + b) * (long long)a.d + c0;
      dst = f2s + (r - n1) * rb;
      if (first) rowtab[r - n1] = b * 8 + l;
    }
  };
  if (vr % 32 == 0) {
    // rows of whole warps of 16-byte loads: a warp per row
    for (int r = threadIdx.x / 32; r < n1 + nv; r += kFwdWarps) {
      const T* src;
      unsigned char* dst;
      locate(r, threadIdx.x % 32 == 0, src, dst);
      for (int k = threadIdx.x % 32; k < vr; k += 32) {
        if constexpr (sizeof(S) == sizeof(T))
          cp_async16(dst + k * kOut, src + k * kIn);
        else
          fp8_to_bf16(__ldg(reinterpret_cast<const uint4*>(src + k * kIn)),
                      reinterpret_cast<uint4*>(dst + k * kOut));
      }
    }
  } else {
    // shorter rows: the block's threads over all the 16-byte loads, four
    // per thread in flight (fp8's are plain loads, converted as they land)
    constexpr int kBatch = 4;
    const int total = (n1 + nv) * vr;
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kFwdThreads) {
      uint4 q[kBatch];
      unsigned char* dst[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kFwdThreads;
        dst[u] = nullptr;
        if (i < total) {
          const int r = i / vr;
          const int k = i - r * vr;
          const T* src;
          locate(r, k == 0, src, dst[u]);
          src += k * kIn;
          dst[u] += k * kOut;
          if constexpr (sizeof(S) == sizeof(T))
            cp_async16(dst[u], src);
          else
            q[u] = __ldg(reinterpret_cast<const uint4*>(src));
        }
      }
      if constexpr (sizeof(S) != sizeof(T)) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (dst[u]) fp8_to_bf16(q[u], reinterpret_cast<uint4*>(dst[u]));
      }
    }
  }
  if constexpr (FwdTraits<T>::kTensor) {
    const int used = cw * (int)sizeof(S);
    if (used % 32) {  // 16 bytes of padding
      for (int r = threadIdx.x; r < n1 + nv; r += kFwdThreads) {
        unsigned char* dst = r < n1 ? f1s + r * rb : f2s + (r - n1) * rb;
        *reinterpret_cast<uint4*>(dst + used) = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// Window dots on the tensor cores: each warp takes a 16-pixel x 16-row
// block of the staged band (two m16n8 products per k step) that some
// window of its pixels reaches, and adds each product that is a window
// bin of its pixel into the dots.
template <typename S>
__device__ void fwd_dots_tc(const unsigned char* f1s,
                            const unsigned char* f2s, int rb, int kbytes,
                            int np, int nv, int tile, int ws,
                            const int* rowtab, const int* umin,
                            const int* umax, const int* los, const int* nbs,
                            float* dots) {
  using Acc = typename TcAcc<S>::type;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int nmb = (np + 15) / 16;
  const int npair = (nv + 15) / 16;
  for (int task = warp; task < nmb * npair; task += kFwdWarps) {
    const int m = task / npair;
    const int pr = task - m * npair;
    bool reach = false;
    if (lane < 16 && pr * 16 + lane < nv) {
      const int lb = rowtab[pr * 16 + lane];
      const int l = lb & 7, b = lb >> 3;
      reach = b >= umin[2 * l + m] && b < umax[2 * l + m];
    }
    if (!__any_sync(0xffffffffu, reach)) continue;
    Acc acc[2][4] = {};
    const unsigned char* ap =
        f1s + (m * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * rb +
        (lane >> 4) * 16;
    const unsigned char* bp =
        f2s + (pr * 16 + (lane & 7) + (lane >> 4) * 8) * rb +
        ((lane >> 3) & 1) * 16;
#pragma unroll 4
    for (int kb = 0; kb < kbytes; kb += 32) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, ap + kb);
      ldsm_x4(bf, bp + kb);
      mma_tc(acc[0], af, bf[0], bf[1]);
      mma_tc(acc[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m * 16 + gq + (e >> 1) * 8;
        const int r = pr * 16 + h * 8 + 2 * t4 + (e & 1);
        if (p < np && r < nv) {
          const int lb = rowtab[r];
          const int l = lb & 7;
          const int j = (lb >> 3) - los[l * tile + p];
          if (j >= 0 && j < nbs[l * tile + p])
            dots[(l * tile + p) * ws + j] += (float)acc[h][e];
        }
      }
    }
  }
}

// 16 staged bytes as fp32 values.
__device__ __forceinline__ void load16(const unsigned char* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load16(const unsigned char* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Window dots on the CUDA cores: eight threads take one pixel's window at
// one level (its bins in this segment) and split the chunk's 16-byte
// columns between them, so the eight read one 128-byte span of a staged
// row together (no bank conflicts); each sums its columns in order, and
// the eight partial sums of each bin are added by a fixed shuffle tree.
template <typename S>
__device__ void fwd_dots_cc(const unsigned char* f1s,
                            const unsigned char* f2s, int rb, int cw, int np,
                            int v0, int nv, int levels, int tile, int ws,
                            const int* blo, const int* boff, const int* los,
                            const int* nbs, float* dots) {
  constexpr int kE = 16 / sizeof(S);
  const int nvec = cw * (int)sizeof(S) / 16;
  const int sub = threadIdx.x % 8;
  // rounds of the loop are uniform across each octet (and so its shuffles)
  for (int t = threadIdx.x / 8; t < ((levels * np + 3) / 4) * 4;
       t += kFwdThreads / 8) {
    int cnt = 0, j0 = 0, l = 0, p = 0;
    if (t < levels * np) {
      l = t / np;
      p = t - l * np;
      const int s = los[l * tile + p];
      // the window's bins inside this segment's rows of the level
      const int first = blo[l] + max(0, v0 - boff[l]);
      const int end = blo[l] + min(boff[l + 1], v0 + nv) - boff[l];
      j0 = max(0, first - s);
      cnt = max(0, min(nbs[l * tile + p], end - s) - j0);
    }
    const int most = __reduce_max_sync(0xffffffffu, cnt);  // warp-uniform
    if (most == 0) continue;
    float acc[kMaxBins];
#pragma unroll
    for (int i = 0; i < kMaxBins; ++i) acc[i] = 0.f;
    if (cnt > 0) {
      const unsigned char* ar = f1s + p * rb;
      const unsigned char* br =
          f2s + (boff[l] + los[l * tile + p] + j0 - blo[l] - v0) * rb;
      for (int q = sub; q < nvec; q += 8) {
        float av[kE];
        load16(ar + q * 16, av);
#pragma unroll
        for (int i = 0; i < kMaxBins; ++i) {
          if (i < cnt) {
            float bv[kE];
            load16(br + i * rb + q * 16, bv);
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[i] = fmaf(av[e], bv[e], acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxBins; ++i) {
      if (i < most) {
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      }
    }
    if (sub == 0) {
      float* dt = dots + (l * tile + p) * ws + j0;
#pragma unroll
      for (int i = 0; i < kMaxBins; ++i)
        if (i < cnt) dt[i] += acc[i];
    }
  }
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kFwdThreads, 2)
corr_alt_fwd_kernel(const __grid_constant__ FwdArgs<T> a) {
  using S = typename FwdTraits<T>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int levels = a.levels;
  const int radius = a.radius;
  const int tile = a.tile;
  const int taps = 2 * radius + 1;
  const int ws = 2 * radius + 5;
  const long long row = blockIdx.x / a.tiles;
  const int p0 = (int)(blockIdx.x - row * a.tiles) * tile;
  const int np = min(tile, a.w1 - p0);
  const long long pix0 = row * a.w1 + p0;
  const FwdSmem lay(levels, radius, tile, a.chunk, sizeof(S), a.seg,
                    sizeof(OutT));
  const int rb = lay.row_bytes;
  unsigned char* f1s = smem + lay.f1;
  unsigned char* f2s = smem + lay.f2;
  float* dots = reinterpret_cast<float*>(smem + lay.dots);  // [L][tile][ws]
  float* xcs = reinterpret_cast<float*>(smem + lay.xc);     // [L][tile]
  int* los = reinterpret_cast<int*>(smem + lay.lo);         // window start
  int* nbs = reinterpret_cast<int*>(smem + lay.nb);         // its bins
  int* band = reinterpret_cast<int*>(smem + lay.band);
  int* blo = band;         // per level: the band's first bin,
  int* bhi = band + 8;     // its last,
  int* boff = band + 16;   // its first staged row (9 entries),
  int* umin = band + 25;   // per level and 16-pixel block: the union
  int* umax = band + 41;   // of the windows' bins [umin, umax)
  int* rowtab = reinterpret_cast<int*>(smem + lay.rows);
  OutT* outs = reinterpret_cast<OutT*>(smem + lay.outs);

  // ---- the windows, as the taps compute them
  for (int e = tid; e < levels * tile * ws; e += kFwdThreads) dots[e] = 0.f;
  if (tid < kMaxLevels) {
    blo[tid] = INT_MAX;
    bhi[tid] = INT_MIN;
  }
  if (tid < 2 * kMaxLevels) {
    umin[tid] = INT_MAX;
    umax[tid] = INT_MIN;
  }
  for (int e = tid; e < levels * np; e += kFwdThreads) {
    const int l = e / np;
    const int p = e - l * np;
    // c / 2^l is exact in fp32, as in the plain version.
    const float xc = ldexpf(a.coords[pix0 + p], -l);
    int s = 0, n = 0;
    // A window wholly outside [0, W2-1] reads nothing and gives zeros.
    if (xc > -(float)(radius + 2) && xc < (float)(a.w2[l] + radius + 1)) {
      // Bins from tap 0's x0 to tap 2R's x0 + 1, each computed as the taps
      // compute it, so every tap finds both of its bins in the window.
      s = (int)floorf(xc + (float)(-radius));
      n = min((int)floorf(xc + (float)radius) + 2 - s, 2 * radius + 4);
    }
    xcs[l * tile + p] = xc;
    los[l * tile + p] = s;
    nbs[l * tile + p] = n;
  }
  __syncthreads();
  for (int e = tid; e < levels * np; e += kFwdThreads) {
    const int l = e / np;
    const int p = e - l * np;
    const int n = nbs[l * tile + p];
    const int s = los[l * tile + p];
    const int lo = max(s, 0);
    const int hi = min(s + n - 1, a.w2[l] - 1);
    if (n > 0 && lo <= hi) {
      atomicMin(blo + l, lo);
      atomicMax(bhi + l, hi);
      atomicMin(umin + 2 * l + p / 16, s);
      atomicMax(umax + 2 * l + p / 16, s + n);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int v = 0;
    for (int l = 0; l < levels; ++l) {
      boff[l] = v;
      if (blo[l] <= bhi[l]) {
        v += bhi[l] - blo[l] + 1;
      } else {  // no window of the tile reaches the level's row
        blo[l] = 0;
        bhi[l] = -1;
      }
    }
    boff[levels] = v;
  }
  __syncthreads();

  // ---- the window dots: D chunk by chunk, the band pass by pass
  const int rows = boff[levels];
  for (int c0 = 0; rows > 0 && c0 < a.d; c0 += a.chunk) {
    const int cw = min(a.chunk, a.d - c0);
    for (int v0 = 0; v0 < rows; v0 += a.seg) {
      const int nv = min(a.seg, rows - v0);
      if (c0 > 0 || v0 > 0) __syncthreads();  // the last pass is read
      fwd_stage(a, f1s, f2s, rb, row, pix0, np, c0, cw, v0, nv, v0 == 0,
                blo, boff, rowtab);
      cp_async_wait_all();
      __syncthreads();
      if constexpr (FwdTraits<T>::kTensor) {
        fwd_dots_tc<S>(f1s, f2s, rb, (cw * (int)sizeof(S) + 31) / 32 * 32,
                       np, nv, tile, ws, rowtab, umin, umax, los, nbs, dots);
      } else {
        fwd_dots_cc<S>(f1s, f2s, rb, cw, np, v0, nv, levels, tile, ws, blo,
                       boff, los, nbs, dots);
      }
    }
  }
  __syncthreads();

  // ---- the taps, interpolated from the dots, staged for 16-byte stores
  constexpr int kVo = 16 / sizeof(OutT);
  const int per_pixel = levels * taps;
  const int nout = np * per_pixel;
  const long long o0 = pix0 * per_pixel;
  const int lead = (int)(o0 % kVo);
  for (int e = tid; e < np * levels; e += kFwdThreads) {
    const int p = e / levels;
    const int l = e - p * levels;
    const int n = nbs[l * tile + p];
    const int s0 = los[l * tile + p];
    const float xc = xcs[l * tile + p];
    const float hi = (float)(a.w2[l] - 1);
    const float* dt = dots + (l * tile + p) * ws;
    OutT* o = outs + lead + p * per_pixel + l * taps;
    for (int k = 0; k < taps; ++k) {
      float v = 0.f;
      if (n > 0) {
        const float x = xc + (float)(k - radius);
        const float x0 = floorf(x);
        const float t = x - x0;
        const int j0 = (int)x0 - s0;
        const float v0 = (x0 >= 0.f && x0 <= hi && j0 >= 0 && j0 < n)
                             ? dt[j0] * a.scale
                             : 0.f;
        const float v1 =
            (x0 + 1.f >= 0.f && x0 + 1.f <= hi && j0 + 1 >= 0 && j0 + 1 < n)
                ? dt[j0 + 1] * a.scale
                : 0.f;
        v = v0 * (1.f - t) + v1 * t;
      }
      store_out(o + k, v);
    }
  }
  __syncthreads();
  OutT* dst = static_cast<OutT*>(a.out) + o0;
  const int head = min(nout, (kVo - lead) % kVo);
  const int nvec = (nout - head) / kVo;
  for (int i = tid; i < head; i += kFwdThreads) dst[i] = outs[lead + i];
  for (int i = tid; i < nvec; i += kFwdThreads)
    reinterpret_cast<uint4*>(dst + head)[i] =
        reinterpret_cast<const uint4*>(outs + lead + head)[i];
  for (int i = head + nvec * kVo + tid; i < nout; i += kFwdThreads)
    dst[i] = outs[lead + i];
}

template <typename T, typename OutT = T>
int launch(const void* f1, const void* const* f2s, const int* w2s,
           int levels, const float* coords, void* out, long long pixels,
           int w1, int d, int radius, float scale, int tile, int chunk,
           int seg, void* stream) {
  using S = typename FwdTraits<T>::S;
  constexpr int kIn = 16 / sizeof(T);
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || w1 < 1 || d < kIn || d % kIn ||
      d > 64 * kIn || pixels < 0 || pixels % w1 || chunk % kIn)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(levels, radius, tile, chunk, sizeof(S),
                                     seg, sizeof(OutT));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (pixels == 0) return (int)cudaSuccess;
  FwdArgs<T> a = {};
  for (int l = 0; l < levels; ++l) {
    if (w2s[l] < 0) return (int)cudaErrorInvalidValue;
    a.f2[l] = static_cast<const T*>(f2s[l]);
    a.w2[l] = w2s[l];
  }
  a.f1 = static_cast<const T*>(f1);
  a.coords = coords;
  a.out = out;
  a.levels = levels;
  a.w1 = w1;
  a.d = d;
  a.radius = radius;
  a.tile = tile;
  a.chunk = chunk;
  a.seg = seg;
  a.tiles = (w1 + tile - 1) / tile;
  a.scale = scale;
  const long long blocks = pixels / w1 * a.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool configured[64] = {};
  const cudaError_t err = allow_smem(corr_alt_fwd_kernel<T, OutT>, configured);
  if (err != cudaSuccess) return (int)err;
  corr_alt_fwd_kernel<T, OutT><<<(unsigned)blocks, kFwdThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ backward
//
// Kernel #8.  Replaces the TPU kernel
// raft_stereo_tpu/kernels/corr_alt.py _bwd_kernel (launched by _launch_bwd
// through the VJPs _alt_level_bwd and _alt_multi_bwd).  Per image row and
// level l, with W_l[p, .] the hat weights of pixel p's 2R+1 taps (at most
// 2R+4 non-zero bins from the window start s_p, built from its center and
// the cotangent g) and s = 1/sqrt(D):
//
//     df1[p]    = s * sum_l sum_b W_l[p, b] * f2_l[b]
//     df2_l[b]  = s * sum_p W_l[p, b] * f1[p]
//
// Bound: memory.  Each input byte is read once and each output byte written
// once: 86.7 MB at the realtime training shape (320 rows, W1 90, W2
// 90/45/22/11, D 256, bf16), 0.026 ms at 3.35 TB/s.  The 918 MFLOP of the
// banded products take 0.014 ms on the CUDA cores, but on them each
// product needs a shared-memory operand: a feature is reused only across
// the ~10 windows that reach it, so the CUDA cores run these sums at a
// small share of their rate.
//
// Both kernels below give one block one image row and a chunk of up to 64
// channels (kernels/corr_alt.py plan_bwd chooses the kernel and the plan;
// bwd_smem_bytes and TcSmem here mirror its counts).  The row's f2 at every
// level and its f1 pixels are read once with 16-byte loads, six in flight
// per thread, into shared memory, and while the first loads are in flight
// the block builds the compact W (2R+4 weights and a window start per
// pixel and level, the plain version's fp32 arithmetic).  Every sum then has
// a fixed order, so two launches agree bit for bit.  Blocks take their
// work from a counter in shared memory, four tasks per warp at a time.
// The dynamic shared-memory limit is set once per kernel and device.
//
// bf16 features whose row fits one block (the training path) take the
// tensor-core kernel (corr_alt_bwd_tc_kernel, its note below): W is split
// into two bf16 parts and multiplied densely in 16 x 16 blocks, skipping
// blocks that no window reaches.  fp32 features, and rows too wide for it,
// take the CUDA-core kernel (corr_alt_bwd_kernel): one warp per level
// buckets its pixels by window start (a count per start, an exclusive scan
// and a fill in pixel order, by match_any ballots: no atomics), so the
// pixels whose windows reach a bin b are the contiguous run of starts
// b-2R-3 .. b.  Eight lanes cover a row of 64 channels (one 16-byte load
// each in bf16, two in fp32), so each shared load of a quarter warp is one
// 128-byte row:
//   df1: a thread takes (pixel, lane), sums over levels in order and bins
//        ascending in registers, scales, rounds once and stores;
//   df2: a thread takes (kBinGroup neighbouring bins, lane) and walks the
//        pixels of their run of starts once, loading each pixel's f1 once
//        for the group: starts ascending, pixels in order.
// A row wider than one tile loops over pixel tiles; df2's partial sums then
// stay in shared memory (fp32) between tiles, pixels still summed in order.
// f1 is widened to fp32 as it lands, f2 stays in the feature dtype.
//
// Why the tensor cores (H100 80GB HBM3, 700 W, chip_smoke.py phase 12,
// CUDA-graph replay): an earlier design (one warp per level walking
// pixels and bins in series, 2-byte loads per lane, a shared
// read-modify-write per step, the level-3 warp waiting on level 0 at every
// barrier) took 0.60 ms in bf16.  On the CUDA cores every product costs a
// shared-memory load of its feature and about three instructions, however
// the loops are arranged (bf16 or fp32 operands in shared memory, several
// bins or pixels per thread), and this layout's CUDA-core kernel takes
// 0.18 ms in fp32; the tensor-core kernel takes 0.11 ms in bf16.  Bulk
// copies (TMA) were tried for the loads and dropped: the CUDA-core kernel
// widens its f1 rows to fp32 as they land, which a bulk copy cannot do,
// and the 16-byte loads keep enough bytes in flight.

constexpr int kBwdThreads = 256;
constexpr int kBwdMaxTile = 2048;   // a bucket entry packs the pixel in 11 bits
constexpr int kBwdMaxChunk = 64;    // 8 lanes x 8 channels
constexpr int kBwdLoads = 6;        // 16-byte loads in flight per thread
constexpr int kBinGroup = 2;        // df2's bins per task
// Byte offsets of one backward block's shared memory: the row's f2 chunk
// (bins x chunk, in the feature dtype), the f1 tile (tile x chunk, widened
// to fp32), df2's fp32 partials (only when the row takes more than one
// tile), the window weights (levels x tile x (2R+5): an odd stride, so a
// warp's writes take 32 banks), each window's start bin and bin count, the
// bucket ends (per level w2 + 2R+3 window starts), the bucket entries
// (levels x tile) and the task counter.
struct BwdSmem {
  size_t f2, f1, acc, wts, lo, nb, ends, list, next, total;
  __host__ __device__ BwdSmem(int bins, int levels, int radius, int tile,
                              int chunk, int item, bool multi) {
    const size_t ws = 2 * radius + 5;
    const size_t keys = bins + (size_t)levels * (2 * radius + 3);
    f2 = 0;
    f1 = f2 + align16((size_t)bins * chunk * item);
    acc = f1 + align16((size_t)tile * chunk * 4);
    wts = acc + (multi ? align16((size_t)bins * chunk * 4) : 0);
    lo = wts + align16((size_t)levels * tile * ws * 4);
    nb = lo + align16((size_t)levels * tile * 4);
    ends = nb + align16((size_t)levels * tile * 4);
    list = ends + align16(keys * 4);
    next = list + align16((size_t)levels * tile * 4);
    total = next + 16;
  }
};

template <typename T>
struct BwdArgs {
  const T* f1;
  const T* f2[kMaxLevels];
  T* df2[kMaxLevels];
  int w2[kMaxLevels];
  int off[kMaxLevels + 1];  // first bin of level l among the row's bins
  const float* coords;
  const T* g;
  T* df1;
  int levels, w1, d, radius, chunk, tile;
  float scale;
};

// 16 bytes of T from global memory, widened to fp32 in shared memory.
__device__ inline void widen_store(float* dst, uint4 q, float) {
  *reinterpret_cast<uint4*>(dst) = q;
}
__device__ inline void widen_store(float* dst, uint4 q, __nv_bfloat16) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Four fp32 sums times s, rounded once to T.
__device__ inline void store4(float* p, const float* v, float s) {
  *reinterpret_cast<float4*>(p) =
      make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
}
__device__ inline void store4(__nv_bfloat16* p, const float* v, float s) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } q;
  q.h[0] = __floats2bfloat162_rn(v[0] * s, v[1] * s);
  q.h[1] = __floats2bfloat162_rn(v[2] * s, v[3] * s);
  *reinterpret_cast<uint2*>(p) = q.u;
}

// A lane's 8 channels of a shared row (channel c of the chunk at row[c]),
// so that the 8 lanes of a quarter warp read 128 contiguous bytes: over a
// bf16 row lane k takes channels 8k..8k+7 (one 16-byte load), over an fp32
// row 4k..4k+3 and 32+4k..32+4k+3 (two).  Channels past cw read as 0 and
// are not stored.
struct LaneBf16 {
  int c;
  bool ok;
  __device__ LaneBf16(int k, int cw) : c(8 * k), ok(8 * k < cw) {}
  __device__ void load(const __nv_bfloat16* row, float* f) const {
    uint4 q = make_uint4(0, 0, 0, 0);
    if (ok) q = *reinterpret_cast<const uint4*>(row + c);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ void store(__nv_bfloat16* out, const float* v, float s) const {
    if (ok) {
      store4(out + c, v, s);
      store4(out + c + 4, v + 4, s);
    }
  }
};

struct LaneF32 {
  int ca, cb;
  bool oka, okb;
  __device__ LaneF32(int k, int cw)
      : ca(4 * k), cb(32 + 4 * k), oka(4 * k < cw), okb(32 + 4 * k < cw) {}
  __device__ void load(const float* row, float* f) const {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (oka) x = *reinterpret_cast<const float4*>(row + ca);
    if (okb) y = *reinterpret_cast<const float4*>(row + cb);
    f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
    f[4] = y.x, f[5] = y.y, f[6] = y.z, f[7] = y.w;
  }
  template <typename T>
  __device__ void store(T* out, const float* v, float s) const {
    if (oka) store4(out + ca, v, s);
    if (okb) store4(out + cb, v + 4, s);
  }
  __device__ void keep(float* row, const float* v) const {
    if (oka) *reinterpret_cast<float4*>(row + ca) =
        make_float4(v[0], v[1], v[2], v[3]);
    if (okb) *reinterpret_cast<float4*>(row + cb) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <typename T>
struct LaneOf {
  using type = LaneF32;
};
template <>
struct LaneOf<__nv_bfloat16> {
  using type = LaneBf16;
};

template <typename T>
__device__ inline int level_of(const BwdArgs<T>& a, int bin) {
  int l = 0;
  while (bin >= a.off[l + 1]) ++l;
  return l;
}

// The window weights of pixels p0 .. p0+np-1 of a row at every level (the
// plain version's fp32 arithmetic): W_l[p, j] at wts[(l*tile + p)*(2R+5) +
// j] for the 2R+4 bins from the window start lo[l*tile + p], nb[l*tile + p]
// of them in the window (0 when it lies wholly outside the level).
template <typename T>
__device__ void build_weights(const BwdArgs<T>& a, long long row, int p0,
                              int np, int tile, float* wts, int* lo,
                              int* nb) {
  const int levels = a.levels;
  const int radius = a.radius;
  const int taps = 2 * radius + 1;
  const int mb = 2 * radius + 4;
  const int ws = mb + 1;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int e = tid; e < levels * np; e += nthreads) {
    const int l = e / np;
    const int p = e - l * np;
    const long long pix = row * a.w1 + p0 + p;
    const int w2 = a.w2[l];
    // c / 2^l is exact in fp32, as in the plain version.
    const float xc = a.coords[pix] * __int_as_float((127 - l) << 23);
    float* w = wts + (size_t)(l * tile + p) * ws;
    int b0 = 0, n = 0;
    if (xc > -(float)(radius + 2) && xc < (float)(w2 + radius + 1)) {
      b0 = (int)floorf(xc + (float)(-radius));
      n = min((int)floorf(xc + (float)radius) + 2 - b0, mb);
      for (int j = 0; j < mb; ++j) w[j] = 0.f;
      const T* gp = a.g + pix * (long long)(levels * taps) + l * taps;
      for (int k = 0; k < taps; ++k) {
        const float x = xc + (float)(k - radius);
        const float x0 = floorf(x);
        const float t = x - x0;
        const float gk = to_float(gp[k]);
        const int j0 = (int)x0 - b0;
        if (x0 >= 0.f && x0 <= (float)(w2 - 1) && j0 >= 0 && j0 < n)
          w[j0] += (1.f - t) * gk;
        if (x0 + 1.f >= 0.f && x0 + 1.f <= (float)(w2 - 1) &&
            j0 + 1 >= 0 && j0 + 1 < n)
          w[j0 + 1] += t * gk;
      }
    }
    lo[l * tile + p] = b0;
    nb[l * tile + p] = n;
  }
}

// Buckets pixels 0 .. np-1 by key(p) in [0, nk) (a negative key leaves p
// out), one warp, in pixel order (match_any ballots, no atomics): end[k]
// becomes the end of key k's run (and so the start of k + 1's), and
// out[first ..] the entries entry(p, k), runs in key order.
template <typename Key, typename Entry>
__device__ void bucket_pass(int np, int nk, int* end, uint32_t* out,
                            int first, Key key, Entry entry) {
  const int lane = threadIdx.x % 32;
  for (int k = lane; k < nk; k += 32) end[k] = 0;
  __syncwarp();
  for (int q = 0; q < np; q += 32) {  // count per key
    const int p = q + lane;
    const int k = p < np ? key(p) : -1;
    const unsigned m = __match_any_sync(0xffffffffu, k < 0 ? -1 - lane : k);
    if (k >= 0 && lane == __ffs(m) - 1) end[k] += __popc(m);
    __syncwarp();
  }
  int carry = first;  // exclusive scan: counts -> starts
  for (int q = 0; q < nk; q += 32) {
    const int v = q + lane < nk ? end[q + lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (q + lane < nk) end[q + lane] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
  for (int q = 0; q < np; q += 32) {  // fill in pixel order
    const int p = q + lane;
    const int k = p < np ? key(p) : -1;
    const unsigned m = __match_any_sync(0xffffffffu, k < 0 ? -1 - lane : k);
    if (k >= 0) out[end[k] + __popc(m & ((1u << lane) - 1))] = entry(p, k);
    __syncwarp();
    if (k >= 0 && lane == __ffs(m) - 1) end[k] += __popc(m);
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 3)
corr_alt_bwd_kernel(const __grid_constant__ BwdArgs<T> a) {
  constexpr int kN = 16 / sizeof(T);  // elements per 16-byte load
  using Lane2 = typename LaneOf<T>::type;  // over the f2 rows (T)
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long row = blockIdx.x;
  const int c0 = blockIdx.y * a.chunk;
  const int cw = min(a.chunk, a.d - c0);  // this block's channels
  const int vpr = cw / kN;                // 16-byte loads per row
  const int levels = a.levels;
  const int bins = a.off[levels];
  const int tile = a.tile;
  const int radius = a.radius;
  const int ws = 2 * radius + 5;    // the weights' stride
  const int span = 2 * radius + 3;  // a bin's window starts: b-span .. b
  const bool multi = tile < a.w1;
  const BwdSmem lay(bins, levels, radius, tile, a.chunk, sizeof(T), multi);
  T* f2s = reinterpret_cast<T*>(smem + lay.f2);            // [bins][cw]
  float* f1s = reinterpret_cast<float*>(smem + lay.f1);    // [tile][cw]
  float* accs = reinterpret_cast<float*>(smem + lay.acc);  // [bins][cw]
  float* wts = reinterpret_cast<float*>(smem + lay.wts);   // [L][tile][ws]
  int* lo = reinterpret_cast<int*>(smem + lay.lo);         // [L][tile]
  int* nb = reinterpret_cast<int*>(smem + lay.nb);         // [L][tile]
  int* ends = reinterpret_cast<int*>(smem + lay.ends);     // per level
  uint32_t* list = reinterpret_cast<uint32_t*>(smem + lay.list);
  int* next = reinterpret_cast<int*>(smem + lay.next);
  const Lane2 ln2(tid % 8, cw);
  const LaneF32 ln1(tid % 8, cw);
  // df2's tasks: groups of kBinGroup neighbouring bins, the coarsest level
  // (the longest runs of pixels) first.
  int groups = 0;
  for (int l = 0; l < levels; ++l)
    groups += (a.w2[l] + kBinGroup - 1) / kBinGroup;

  for (int p0 = 0, phase = 0; p0 < a.w1; p0 += tile, ++phase) {
    const int np = min(tile, a.w1 - p0);
    if (phase > 0) __syncthreads();  // every read of the last tile is done
    if (tid == 0) *next = 0;
    const int f2rows = phase == 0 ? bins : 0;
    const int nvec = (f2rows + np) * vpr;
    // 16-byte loads of the rows, kBwdLoads per thread in flight: issue()
    // starts a batch into registers, land() writes it to shared memory (f2
    // rows as they are, f1 rows widened to fp32).
    uint4 buf[kBwdLoads];
    void* dst[kBwdLoads];
    bool widen[kBwdLoads];
    auto issue = [&](int i0) {
#pragma unroll
      for (int u = 0; u < kBwdLoads; ++u) {
        const int i = i0 + u * kBwdThreads + tid;
        dst[u] = nullptr;
        if (i < nvec) {
          const int r = i / vpr;
          const int k = i - r * vpr;
          const T* src;
          widen[u] = r >= f2rows;
          if (!widen[u]) {
            const int l = level_of(a, r);
            src = a.f2[l] + (row * a.w2[l] + (r - a.off[l])) * (long long)a.d;
            dst[u] = f2s + (size_t)r * cw + k * kN;
          } else {
            src = a.f1 + (row * a.w1 + p0 + (r - f2rows)) * (long long)a.d;
            dst[u] = f1s + (size_t)(r - f2rows) * cw + k * kN;
          }
          buf[u] = __ldg(reinterpret_cast<const uint4*>(src + c0 + k * kN));
        }
      }
    };
    auto land = [&]() {
#pragma unroll
      for (int u = 0; u < kBwdLoads; ++u) {
        if (!dst[u]) continue;
        if (widen[u])
          widen_store(static_cast<float*>(dst[u]), buf[u], T());
        else
          *reinterpret_cast<uint4*>(dst[u]) = buf[u];
      }
    };
    issue(0);
    // ---- window weights of the tile, while the loads are in flight.
    build_weights(a, row, p0, np, tile, wts, lo, nb);
    __syncthreads();

    // Per level, by window start (key = start + 2R + 2, so 0 .. w2 + 2R + 2;
    // empty windows left out): the entries pack pixel, bin count and key.
    if (warp < levels) {
      const int l = warp;
      bucket_pass(np, a.w2[l] + span, ends + a.off[l] + l * span, list,
                  l * tile,
                  [&](int p) {
                    return nb[l * tile + p] > 0 ? lo[l * tile + p] + span - 1
                                                : -1;
                  },
                  [&](int p, int k) {
                    return (uint32_t)p | ((uint32_t)nb[l * tile + p] << 11) |
                           ((uint32_t)k << 16);
                  });
    }
    // The rows: the first batch has been in flight since the start.
    land();
    for (int i0 = kBwdThreads * kBwdLoads; i0 < nvec;
         i0 += kBwdThreads * kBwdLoads) {
      issue(i0);
      land();
    }
    __syncthreads();

    // ---- the tasks, taken four at a time by each warp (one per quarter
    // warp) from the block's counter: df2's bin groups, then df1's pixels.
    const bool last = p0 + tile >= a.w1;
    const int ntasks = groups + np;
    for (;;) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, 4);
      base = __shfl_sync(0xffffffffu, base, 0);
      if (base >= ntasks) break;
      const int task = base + lane / 8;
      if (task >= ntasks) continue;
      if (task < groups) {
        // df2 of kBinGroup neighbouring bins, over the pixels whose windows
        // start in b0-2R-3 .. b0+kBinGroup-1.
        int gi = task, l = levels - 1;
        for (;; --l) {
          const int ng = (a.w2[l] + kBinGroup - 1) / kBinGroup;
          if (gi < ng) break;
          gi -= ng;
        }
        const int w2 = a.w2[l];
        const int b0 = gi * kBinGroup;
        const int nbin = min(kBinGroup, w2 - b0);
        float acc[kBinGroup][8];
#pragma unroll
        for (int t = 0; t < kBinGroup; ++t) {
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[t][i] = 0.f;
          if (phase > 0 && t < nbin)
            ln1.load(accs + (size_t)(a.off[l] + b0 + t) * cw, acc[t]);
        }
        const int* end = ends + a.off[l] + l * span;
        const int kb = b0 + span - 1;  // the key of start b0
        const float* wl = wts + (size_t)l * tile * ws;
        const int stop = end[kb + nbin - 1];
        for (int i = b0 >= 2 ? end[b0 - 2] : l * tile; i < stop; ++i) {
          const uint32_t ent = list[i];
          const int p = ent & 2047;
          const int n = (ent >> 11) & 31;
          const int j = kb - (int)(ent >> 16);  // b0 - the window's start
          float f[8];
          ln1.load(f1s + (size_t)p * cw, f);
          const float* w = wl + p * ws;
#pragma unroll
          for (int t = 0; t < kBinGroup; ++t) {
            if (j + t >= 0 && j + t < n) {
              const float wj = w[j + t];
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[t][c] = fmaf(wj, f[c], acc[t][c]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < kBinGroup; ++t) {
          if (t < nbin) {
            if (last)
              ln1.store(a.df2[l] + (row * w2 + b0 + t) * (long long)a.d + c0,
                        acc[t], a.scale);
            else
              ln1.keep(accs + (size_t)(a.off[l] + b0 + t) * cw, acc[t]);
          }
        }
      } else {
        // df1 of one pixel: levels in order, bins ascending.
        const int p = task - groups;
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        for (int l = 0; l < levels; ++l) {
          const int b0 = lo[l * tile + p];
          const int j1 = min(nb[l * tile + p], a.w2[l] - b0);
          const float* w = wts + (size_t)(l * tile + p) * ws;
          const int j0 = max(0, -b0);
          const T* src = f2s + (size_t)(a.off[l] + b0 + j0) * cw;
          for (int j = j0; j < j1; ++j, src += cw) {
            float f[8];
            ln2.load(src, f);
            const float wj = w[j];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = fmaf(wj, f[i], acc[i]);
          }
        }
        ln2.store(a.df1 + (row * a.w1 + p0 + p) * (long long)a.d + c0, acc,
                  a.scale);
      }
    }
  }
}

// Shared bytes of one backward launch, 0 for a plan the kernel refuses.
inline size_t bwd_smem_bytes(int bins, int levels, int radius, int tile,
                             int chunk, int item, int w1) {
  if (tile < 1 || tile > kBwdMaxTile || chunk < 1 ||
      chunk > kBwdMaxChunk || chunk * item % 16)
    return 0;
  const BwdSmem lay(bins, levels, radius, tile, chunk, item, tile < w1);
  return lay.total <= kMaxSmem ? lay.total : 0;
}

// ---- kernel #8 on the tensor cores (bf16 features, a row in one tile).
//
// The same sums as dense products per block: df1 (pixels x channels) =
// sum_l W_l (pixels x bins) F2_l and df2_l (bins x channels) = W_l^T F1,
// on mma.sync m16n8k16 (bf16 in, fp32 accumulators).  The features are
// bf16 already, so their products are exact; each fp32 weight is split
// into a bf16 high part and a bf16 low part (16 significant bits, an
// error of 2^-17 of the weight) and both parts are multiplied, so the
// result keeps the fp32 version's accuracy to well inside one bf16 ulp of
// the output.  The weights are never stored densely: each lane builds its
// fragments of W from the compact window weights (2R+4 per pixel and
// level) as it goes, and a 16 x 16 block of W that no window reaches is
// skipped (where the centers rise along the row, as a disparity field's do,
// W is banded and most blocks are).  The features sit in shared memory in rows padded by 16 bytes,
// so the ldmatrix loads of the B fragments meet no bank conflicts.
struct TcSmem {
  size_t f2, f1, wts, lo, nb, next, total;
  __host__ __device__ TcSmem(const int* w2s, int levels, int radius, int tile,
                             int chunk) {
    int krows = 0;
    for (int l = 0; l < levels; ++l) krows += (w2s[l] + 15) / 16 * 16;
    const size_t stride = (size_t)(chunk + 8) * 2;
    const size_t ws = 2 * radius + 5;
    f2 = 0;
    f1 = f2 + align16(krows * stride);
    wts = f1 + align16((size_t)(tile + 15) / 16 * 16 * stride);
    lo = wts + align16((size_t)levels * tile * ws * 4);
    nb = lo + align16((size_t)levels * tile * 4);
    next = nb + align16((size_t)levels * tile * 4);
    total = next + 16;
  }
};

// Two fp32 weights as bf16x2 high and low words (the first in the low half).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// Pixel p's weight at bin b of a level: its window starts at s, holds n
// bins, its weights at w.
__device__ __forceinline__ float wat(const float* w, int s, int n, int b) {
  const int j = b - s;
  return (unsigned)j < (unsigned)n ? w[j] : 0.f;
}

__global__ void __launch_bounds__(kBwdThreads, 3)
corr_alt_bwd_tc_kernel(const __grid_constant__ BwdArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int kN = 8;  // bf16 per 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;  // fragment row and column pair
  const long long row = blockIdx.x;
  const int c0 = blockIdx.y * a.chunk;
  const int cw = min(a.chunk, a.d - c0);  // this block's channels
  const int nt = cw / 8;                  // its 8-channel tiles
  const int vpr = cw / kN;
  const int levels = a.levels;
  const int np = a.w1;  // one tile
  const int mpad = (np + 15) / 16 * 16;
  const int ws = 2 * a.radius + 5;
  const int sr = a.chunk + 8;  // row stride of the features, elements
  const TcSmem lay(a.w2, levels, a.radius, np, a.chunk);
  T* f2s = reinterpret_cast<T*>(smem + lay.f2);  // level l from koff_l
  T* f1s = reinterpret_cast<T*>(smem + lay.f1);  // [mpad][sr]
  float* wts = reinterpret_cast<float*>(smem + lay.wts);
  int* lo = reinterpret_cast<int*>(smem + lay.lo);
  int* nb = reinterpret_cast<int*>(smem + lay.nb);
  int* next = reinterpret_cast<int*>(smem + lay.next);
  if (tid == 0) *next = 0;

  // The rows: f2 of every level (padded to 16 bins with zeros) and f1
  // (padded to 16 pixels), 16-byte loads, kBwdLoads in flight per thread.
  int krows = 0;
  for (int l = 0; l < levels; ++l) krows += (a.w2[l] + 15) / 16 * 16;
  const int bins = a.off[levels];
  const int nvec = (bins + np) * vpr;
  uint4 buf[kBwdLoads];
  T* dst[kBwdLoads];
  auto issue = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBwdLoads; ++u) {
      const int i = i0 + u * kBwdThreads + tid;
      dst[u] = nullptr;
      if (i < nvec) {
        const int r = i / vpr;
        const int k = i - r * vpr;
        const T* src;
        if (r < bins) {
          int l = level_of(a, r), koff = 0;
          for (int m = 0; m < l; ++m) koff += (a.w2[m] + 15) / 16 * 16;
          src = a.f2[l] + (row * a.w2[l] + (r - a.off[l])) * (long long)a.d;
          dst[u] = f2s + (size_t)(koff + r - a.off[l]) * sr + k * kN;
        } else {
          src = a.f1 + (row * a.w1 + (r - bins)) * (long long)a.d;
          dst[u] = f1s + (size_t)(r - bins) * sr + k * kN;
        }
        buf[u] = __ldg(reinterpret_cast<const uint4*>(src + c0 + k * kN));
      }
    }
  };
  auto land = [&]() {
#pragma unroll
    for (int u = 0; u < kBwdLoads; ++u)
      if (dst[u]) *reinterpret_cast<uint4*>(dst[u]) = buf[u];
  };
  issue(0);
  build_weights(a, row, 0, np, np, wts, lo, nb);
  // zero rows: the levels' padding bins and the pixels' padding rows
  {
    int koff = 0;
    for (int l = 0; l < levels; ++l) {
      const int pad = (a.w2[l] + 15) / 16 * 16 - a.w2[l];
      for (int i = tid; i < pad * vpr; i += kBwdThreads)
        *reinterpret_cast<uint4*>(
            f2s + (size_t)(koff + a.w2[l] + i / vpr) * sr + i % vpr * kN) =
            make_uint4(0, 0, 0, 0);
      koff += (a.w2[l] + 15) / 16 * 16;
    }
    for (int i = tid; i < (mpad - np) * vpr; i += kBwdThreads)
      *reinterpret_cast<uint4*>(f1s + (size_t)(np + i / vpr) * sr +
                                i % vpr * kN) = make_uint4(0, 0, 0, 0);
  }
  land();
  for (int i0 = kBwdThreads * kBwdLoads; i0 < nvec;
       i0 += kBwdThreads * kBwdLoads) {
    issue(i0);
    land();
  }
  __syncthreads();

  // ---- tasks, one per warp at a time: df1 of 16 pixels, then df2 of 16
  // bins of a level.
  const int m1 = mpad / 16;
  const int ntasks = m1 + krows / 16;
  for (;;) {
    int task = 0;
    if (lane == 0) task = atomicAdd(next, 1);
    task = __shfl_sync(0xffffffffu, task, 0);
    if (task >= ntasks) break;
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    if (task < m1) {
      // df1 of pixels p0 .. p0+15: sum over levels and 16-bin blocks.
      const int r0 = task * 16 + gq, r1 = r0 + 8;
      int koff = 0;
      for (int l = 0; l < levels; ++l) {
        const int kp = (a.w2[l] + 15) / 16 * 16;
        int s0 = 0, n0 = 0, s1 = 0, n1 = 0;
        const float* w0 = wts;
        const float* w1 = wts;
        if (r0 < np) {
          s0 = lo[l * np + r0];
          n0 = nb[l * np + r0];
          w0 = wts + (size_t)(l * np + r0) * ws;
        }
        if (r1 < np) {
          s1 = lo[l * np + r1];
          n1 = nb[l * np + r1];
          w1 = wts + (size_t)(l * np + r1) * ws;
        }
        // the bins the 16 windows reach
        int umin = 0x7fffffff, umax = -0x7fffffff;
        if (n0) umin = min(umin, s0), umax = max(umax, s0 + n0);
        if (n1) umin = min(umin, s1), umax = max(umax, s1 + n1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          umin = min(umin, __shfl_xor_sync(0xffffffffu, umin, o));
          umax = max(umax, __shfl_xor_sync(0xffffffffu, umax, o));
        }
        for (int kb = max(0, umin / 16 * 16); kb < min(kp, umax); kb += 16) {
          const int ca = kb + 2 * t4, cb = ca + 8;
          uint32_t ah[4], al[4];
          split2(wat(w0, s0, n0, ca), wat(w0, s0, n0, ca + 1), ah[0], al[0]);
          split2(wat(w1, s1, n1, ca), wat(w1, s1, n1, ca + 1), ah[1], al[1]);
          split2(wat(w0, s0, n0, cb), wat(w0, s0, n0, cb + 1), ah[2], al[2]);
          split2(wat(w1, s1, n1, cb), wat(w1, s1, n1, cb + 1), ah[3], al[3]);
          const T* brow = f2s + (size_t)(koff + kb + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * sr +
                          (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < 8; n += 2) {
            if (n < nt) {
              uint32_t b[4];
              ldsm_x4_trans(b, brow + n * 8);
              mma_bf16(acc[n], ah, b[0], b[1]);
              mma_bf16(acc[n], al, b[0], b[1]);
              mma_bf16(acc[n + 1], ah, b[2], b[3]);
              mma_bf16(acc[n + 1], al, b[2], b[3]);
            }
          }
        }
        koff += kp;
      }
      T* out = a.df1 + (row * a.w1) * (long long)a.d + c0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < nt) {
          if (r0 < np)
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)r0 * a.d +
                                               n * 8) =
                __floats2bfloat162_rn(acc[n][0] * a.scale,
                                      acc[n][1] * a.scale);
          if (r1 < np)
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)r1 * a.d +
                                               n * 8) =
                __floats2bfloat162_rn(acc[n][2] * a.scale,
                                      acc[n][3] * a.scale);
        }
      }
    } else {
      // df2 of bins mb .. mb+15 of level l: sum over 16-pixel blocks.
      int mt = task - m1, l = 0, koff = 0;
      for (;; ++l) {
        const int kt = (a.w2[l] + 15) / 16;
        if (mt < kt) break;
        mt -= kt;
        koff += kt * 16;
      }
      const int mb = mt * 16;
      const int b0 = mb + gq, b1 = b0 + 8;
      for (int kb = 0; kb < mpad; kb += 16) {
        const int pa = kb + 2 * t4;
        const int px[4] = {pa, pa + 1, pa + 8, pa + 9};
        int s[4], n[4];
        const float* w[4];
        bool reach = false;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[q] = 0;
          n[q] = 0;
          w[q] = wts;
          if (px[q] < np) {
            s[q] = lo[l * np + px[q]];
            n[q] = nb[l * np + px[q]];
            w[q] = wts + (size_t)(l * np + px[q]) * ws;
            reach |= n[q] > 0 && s[q] < mb + 16 && s[q] + n[q] > mb;
          }
        }
        if (!__any_sync(0xffffffffu, reach)) continue;
        uint32_t ah[4], al[4];
        split2(wat(w[0], s[0], n[0], b0), wat(w[1], s[1], n[1], b0), ah[0],
               al[0]);
        split2(wat(w[0], s[0], n[0], b1), wat(w[1], s[1], n[1], b1), ah[1],
               al[1]);
        split2(wat(w[2], s[2], n[2], b0), wat(w[3], s[3], n[3], b0), ah[2],
               al[2]);
        split2(wat(w[2], s[2], n[2], b1), wat(w[3], s[3], n[3], b1), ah[3],
               al[3]);
        const T* brow = f1s + (size_t)(kb + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * sr +
                        (lane >> 4) * 8;
#pragma unroll
        for (int c = 0; c < 8; c += 2) {
          if (c < nt) {
            uint32_t b[4];
            ldsm_x4_trans(b, brow + c * 8);
            mma_bf16(acc[c], ah, b[0], b[1]);
            mma_bf16(acc[c], al, b[0], b[1]);
            mma_bf16(acc[c + 1], ah, b[2], b[3]);
            mma_bf16(acc[c + 1], al, b[2], b[3]);
          }
        }
      }
      const int w2 = a.w2[l];
      T* out = a.df2[l] + (row * w2) * (long long)a.d + c0 + 2 * t4;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (c < nt) {
          if (b0 < w2)
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)b0 * a.d +
                                               c * 8) =
                __floats2bfloat162_rn(acc[c][0] * a.scale,
                                      acc[c][1] * a.scale);
          if (b1 < w2)
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)b1 * a.d +
                                               c * 8) =
                __floats2bfloat162_rn(acc[c][2] * a.scale,
                                      acc[c][3] * a.scale);
        }
      }
    }
  }
}

// Shared bytes of a tensor-core launch (bf16, the whole row one tile), 0
// where it does not fit.
inline size_t bwd_tc_smem_bytes(const int* w2s, int levels, int radius,
                                int w1, int chunk) {
  if (chunk < 8 || chunk > kBwdMaxChunk || chunk % 8) return 0;
  const TcSmem lay(w2s, levels, radius, w1, chunk);
  return lay.total <= kMaxSmem ? lay.total : 0;
}

// Shared bytes of a backward launch (tensor_cores: the bf16 tensor-core
// kernel over the whole row), 0 where the kernel refuses the plan.
inline size_t bwd_plan_bytes(const int* w2s, int levels, int radius,
                             int tile, int chunk, int item, int w1,
                             int tensor_cores) {
  if (!tensor_cores) {
    int bins = 0;
    for (int l = 0; l < levels; ++l) bins += w2s[l];
    return bwd_smem_bytes(bins, levels, radius, tile, chunk, item, w1);
  }
  if (item != 2 || tile != w1 || w1 > kBwdMaxTile) return 0;
  return bwd_tc_smem_bytes(w2s, levels, radius, w1, chunk);
}

template <typename T>
int launch_bwd(const void* f1, const void* const* f2s, void* const* df2s,
               const int* w2s, int levels, const float* coords,
               const void* g, void* df1, long long rows, int w1, int d,
               int radius, float scale, int chunk, int tile,
               int tensor_cores, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || w1 < 1 || d < 1 || d % (16 / sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  BwdArgs<T> a = {};
  a.off[0] = 0;
  for (int l = 0; l < levels; ++l) {
    if (w2s[l] < 1) return (int)cudaErrorInvalidValue;
    a.f2[l] = static_cast<const T*>(f2s[l]);
    a.df2[l] = static_cast<T*>(df2s[l]);
    a.w2[l] = w2s[l];
    a.off[l + 1] = a.off[l] + w2s[l];
  }
  for (int l = levels; l < kMaxLevels; ++l) a.off[l + 1] = a.off[levels];
  const size_t smem = bwd_plan_bytes(w2s, levels, radius, tile, chunk,
                                     sizeof(T), w1, tensor_cores);
  const long long chunks = (d + chunk - 1) / chunk;
  if (smem == 0 || chunk % (16 / sizeof(T)) || rows > 0x7fffffffLL ||
      chunks > 65535)
    return (int)cudaErrorInvalidValue;
  a.f1 = static_cast<const T*>(f1);
  a.coords = coords;
  a.g = static_cast<const T*>(g);
  a.df1 = static_cast<T*>(df1);
  a.levels = levels;
  a.w1 = w1;
  a.d = d;
  a.radius = radius;
  a.chunk = chunk;
  a.tile = tile;
  a.scale = scale;
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tensor_cores) {
      static bool configured[64] = {};
      const cudaError_t err = allow_smem(corr_alt_bwd_tc_kernel, configured);
      if (err != cudaSuccess) return (int)err;
      corr_alt_bwd_tc_kernel<<<grid, kBwdThreads, smem, st>>>(a);
      return (int)cudaGetLastError();
    }
  }
  static bool configured[64] = {};
  const cudaError_t err = allow_smem(corr_alt_bwd_kernel<T>, configured);
  if (err != cudaSuccess) return (int)err;
  corr_alt_bwd_kernel<T><<<grid, kBwdThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// f1: (rows, w1, d); f2s: host array of `levels` device pointers, level l
// (rows, w2s[l], d); coords: (rows, w1) fp32; out: (rows, w1,
// levels*(2*radius+1)).  Features and out share one dtype, contiguous, the
// features 16-byte aligned; pixels = rows * w1; scale = 1/sqrt(d).  tile
// (pixels per block), chunk (channels per pass) and seg (band rows per
// pass) come from kernels/corr_alt.py plan_fwd; a plan whose shared memory
// exceeds a block's returns cudaErrorInvalidValue.
#define RAFT_ALT_FWD(name, T, OutT)                                          \
  extern "C" int name(const void* f1, const void* const* f2s,               \
                      const int* w2s, int levels, const float* coords,       \
                      void* out, long long pixels, int w1, int d,            \
                      int radius, float scale, int tile, int chunk, int seg, \
                      void* stream) {                                        \
    return launch<T, OutT>(f1, f2s, w2s, levels, coords, out, pixels, w1,   \
                           d, radius, scale, tile, chunk, seg, stream);      \
  }
RAFT_ALT_FWD(raft_corr_alt_f32, float, float)
RAFT_ALT_FWD(raft_corr_alt_bf16, __nv_bfloat16, __nv_bfloat16)
// Quantized features: int8 or float8_e4m3fn codes (d a multiple of 16),
// out fp32: the raw correlation of the codes times scale.
RAFT_ALT_FWD(raft_corr_alt_q_int8, int8_t, float)
RAFT_ALT_FWD(raft_corr_alt_q_fp8, __nv_fp8_e4m3, float)
#undef RAFT_ALT_FWD

// Shared bytes of a forward plan (item: bytes of a staged feature, 2 for
// fp8; out_item: bytes of an output), 0 where the kernel refuses it.
extern "C" int raft_corr_alt_fwd_smem_bytes(int levels, int radius, int tile,
                                            int chunk, int item, int seg,
                                            int out_item) {
  return (int)fwd_smem_bytes(levels, radius, tile, chunk, item, seg,
                             out_item);
}

// Backward: f1 (rows, w1, d), f2s level l (rows, w2s[l], d), coords
// (rows, w1) fp32, g (rows, w1, levels*(2*radius+1)) -> df1 (rows, w1, d)
// and df2s level l (rows, w2s[l], d), every element written.  Features, g,
// df1 and df2s share one dtype, contiguous, the features 16-byte aligned;
// scale = 1/sqrt(d).  chunk (channels per block, a whole number of 16-byte
// vectors), tile (pixels per tile) and tensor_cores (bf16 only, the whole
// row one tile) come from kernels/corr_alt.py plan_bwd; a plan whose shared
// memory exceeds a block's returns cudaErrorInvalidValue.
extern "C" int raft_corr_alt_bwd_f32(const void* f1, const void* const* f2s,
                                     void* const* df2s, const int* w2s,
                                     int levels, const float* coords,
                                     const void* g, void* df1,
                                     long long rows, int w1, int d,
                                     int radius, float scale, int chunk,
                                     int tile, int tensor_cores,
                                     void* stream) {
  return launch_bwd<float>(f1, f2s, df2s, w2s, levels, coords, g, df1, rows,
                           w1, d, radius, scale, chunk, tile, tensor_cores,
                           stream);
}

extern "C" int raft_corr_alt_bwd_bf16(const void* f1, const void* const* f2s,
                                      void* const* df2s, const int* w2s,
                                      int levels, const float* coords,
                                      const void* g, void* df1,
                                      long long rows, int w1, int d,
                                      int radius, float scale, int chunk,
                                      int tile, int tensor_cores,
                                      void* stream) {
  return launch_bwd<__nv_bfloat16>(f1, f2s, df2s, w2s, levels, coords, g,
                                   df1, rows, w1, d, radius, scale, chunk,
                                   tile, tensor_cores, stream);
}

// Shared bytes of a backward plan (w2s: the level widths, item: the
// feature's bytes), 0 where the kernel refuses it.
extern "C" int raft_corr_alt_bwd_smem_bytes(const int* w2s, int levels,
                                            int radius, int tile, int chunk,
                                            int item, int w1,
                                            int tensor_cores) {
  return (int)bwd_plan_bytes(w2s, levels, radius, tile, chunk, item, w1,
                             tensor_cores);
}
