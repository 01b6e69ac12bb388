// Fused ConvGRU gate pre-activations for NVIDIA Hopper (sm_90a), fp32 and
// bf16.
//
// Replaces the TPU kernel raft_stereo_tpu/kernels/gru_fused.py
// _gates_kernel:
//     zr   = conv3x3([h, x], Wzr) + bzr
//     r    = sigmoid(zr[..., Ch:] + cr)
//     qpre = conv3x3([r*h, x], Wq) + bq
// NHWC activations, HWIO weights, zero padding of one pixel (SAME).
// Activations and weights are fp32 or bf16 (one type T for all of them);
// biases are fp32.  The rounding points are the TPU kernel's: products
// accumulate in fp32, the fp32 bias joins the accumulator before any
// rounding, r is computed in fp32 from the unrounded zr, r*h is rounded to
// T before the q conv reads it, and zr and qpre are rounded once to T.
//
// Bound: arithmetic.  At Cin = 384 each output pixel costs 9*384*384
// multiply-adds and reads a few KB, so the kernel is limited by the fp32
// FMA rate of the CUDA cores (the fp32 path of the model is full fp32, so
// no TF32 tensor cores; the bf16 instantiation converts to fp32 on load
// and runs the same FMAs, which keeps its products exact).  The design is
// an implicit GEMM on the CUDA cores: a block owns an 8x16 tile of output
// pixels and 128 output channels; it streams the inputs through shared
// memory 8 channels at a time (the 10x18 halo patch of the tile plus the
// 9x8x128 weight slice, both as fp32: 42.6 KB, so the weights at Cin 384
// never have to fit at once), and each of the 256 threads keeps an
// 8-pixel x 8-channel accumulator in registers, so every shared-memory
// load feeds 4-8 FMAs.
//
// Two launches per call, from one kernel template: the first computes zr
// and, in its epilogue, r*h for the channels of the r half, written to a
// scratch buffer in device memory; the second computes qpre over
// [r*h, x].  The TPU kernel instead recomputes zr on a one-pixel ring
// around its row block to keep r*h on chip; here the extra 15 MB round
// trip of r*h at the finest level costs far less than that recompute.
// The zero padding of the q conv is exact: outside the image the patch
// loader reads zeros, just as padded h makes r*h zero on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kBlockN = 128;           // output channels per block
constexpr int kChunk = 8;              // input channels per shared stage
constexpr int kThreads = 256;
constexpr int kPatchH = kTileH + 2;
constexpr int kPatchW = kTileW + 2;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive values as fp32 (16 bytes of fp32, 8 of bf16).
__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float4 load4(const __nv_bfloat16* p) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } q;
  q.u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(q.h[0]);
  const float2 hi = __bfloat1622float2(q.h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four fp32 values, each rounded once to the destination type.
__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store4(__nv_bfloat16* p, const float* v) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } q;
  q.h[0] = __floats2bfloat162_rn(v[0], v[1]);
  q.h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q.u;
}

template <typename T>
struct ConvArgs {
  const T* src0;      // first input part, NHWC with c0 channels
  const T* src1;      // second input part, NHWC with c1 channels
  int c0, c1;
  const T* w;         // HWIO (3, 3, c0 + c1, cout)
  const float* bias;  // (cout)
  T* out;             // NHWC with cout channels
  int cout;
  // r coupling (first launch only): r = sigmoid(out[..., ch:] + cr),
  // rh = r * h, all three NHWC with ch channels.
  const T* cr;
  const T* h;
  T* rh;
  int ch;
  int batch, height, width;
};

template <typename T, bool kRCouple>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(ConvArgs<T> a) {
  __shared__ float patch[kChunk][kPatchH][kPatchW];
  __shared__ __align__(16) float wts[9][kChunk][kBlockN];

  const int tid = threadIdx.x;
  const int tiles_w = (a.width + kTileW - 1) / kTileW;
  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kBlockN;
  const long long b = blockIdx.z;
  const int cin = a.c0 + a.c1;

  // Thread -> (8 pixels in one tile row) x (8 output channels).  The
  // channels are n0 + tn*4 + {0..3} and n0 + 64 + tn*4 + {0..3}, so the
  // 16 channel groups of a warp read 16 consecutive float4s.
  const int tn = tid % 16;
  const int tm = tid / 16;
  const int prow = tm >> 1;
  const int pcol = (tm & 1) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kChunk) {
    const bool first = ci0 < a.c0;
    const T* src = first ? a.src0 : a.src1;
    const int cs = first ? a.c0 : a.c1;
    const int coff = first ? ci0 : ci0 - a.c0;
    for (int e = tid; e < kPatchH * kPatchW * kChunk; e += kThreads) {
      const int c = e % kChunk;
      const int pix = e / kChunk;
      const int py = pix / kPatchW;
      const int px = pix % kPatchW;
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      float v = 0.f;
      if (gy >= 0 && gy < a.height && gx >= 0 && gx < a.width)
        v = to_float(src[((b * a.height + gy) * a.width + gx) * cs + coff + c]);
      patch[c][py][px] = v;
    }
    for (int e = tid; e < 9 * kChunk * (kBlockN / 4); e += kThreads) {
      const int n4 = e % (kBlockN / 4);
      const int rest = e / (kBlockN / 4);
      const int c = rest % kChunk;
      const int tap = rest / kChunk;
      const int n = n0 + n4 * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < a.cout)
        v = load4(&a.w[((long long)tap * cin + ci0 + c) * a.cout + n]);
      *reinterpret_cast<float4*>(&wts[tap][c][n4 * 4]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = patch[c][prow + dy][pcol + i + dx];
        const float4 b0 = *reinterpret_cast<const float4*>(&wts[tap][c][tn * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&wts[tap][c][64 + tn * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int y = y0 + prow;
  if (y >= a.height) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x = x0 + pcol + i;
    if (x >= a.width) continue;
    const long long pix = (b * a.height + y) * a.width + x;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tn * 4;
      if (n >= a.cout) continue;  // cout % 4 == 0: n..n+3 all valid
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[i][half * 4 + q] + a.bias[n + q];
      store4(&a.out[pix * a.cout + n], v);
      if (kRCouple && n >= a.ch) {
        const long long o = pix * a.ch + (n - a.ch);
        float rh[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float r = 1.f / (1.f + expf(-(v[q] + to_float(a.cr[o + q]))));
          rh[q] = r * to_float(a.h[o + q]);
        }
        store4(&a.rh[o], rh);
      }
    }
  }
}

template <typename T>
int run(const T* h, const T* x, const T* cr, const T* wzr, const float* bzr,
        const T* wq, const float* bq, T* zr, T* qpre, T* rh_scratch,
        int batch, int height, int width, int ch, int cx, void* stream) {
  if (ch % kChunk || cx % kChunk) return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ((height + kTileH - 1) / kTileH) *
                    ((width + kTileW - 1) / kTileW);

  ConvArgs<T> a = {};
  a.src0 = h;
  a.c0 = ch;
  a.src1 = x;
  a.c1 = cx;
  a.w = wzr;
  a.bias = bzr;
  a.out = zr;
  a.cout = 2 * ch;
  a.cr = cr;
  a.h = h;
  a.rh = rh_scratch;
  a.ch = ch;
  a.batch = batch;
  a.height = height;
  a.width = width;
  dim3 grid_zr(tiles, (2 * ch + kBlockN - 1) / kBlockN, batch);
  conv3x3_kernel<T, true><<<grid_zr, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  a.src0 = rh_scratch;
  a.w = wq;
  a.bias = bq;
  a.out = qpre;
  a.cout = ch;
  a.cr = nullptr;
  a.h = nullptr;
  a.rh = nullptr;
  dim3 grid_q(tiles, (ch + kBlockN - 1) / kBlockN, batch);
  conv3x3_kernel<T, false><<<grid_q, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// h, cr, rh_scratch, qpre: (B, H, W, ch); x: (B, H, W, cx);
// zr: (B, H, W, 2*ch); wzr: (3, 3, ch+cx, 2*ch); wq: (3, 3, ch+cx, ch);
// bzr (2*ch), bq (ch) fp32.  Contiguous device pointers; ch and cx
// multiples of 8.  raft_gru_gates takes fp32, raft_gru_gates_bf16 bf16
// activations and weights.
extern "C" int raft_gru_gates(const float* h, const float* x, const float* cr,
                              const float* wzr, const float* bzr,
                              const float* wq, const float* bq, float* zr,
                              float* qpre, float* rh_scratch, int batch,
                              int height, int width, int ch, int cx,
                              void* stream) {
  return run<float>(h, x, cr, wzr, bzr, wq, bq, zr, qpre, rh_scratch, batch,
                    height, width, ch, cx, stream);
}

extern "C" int raft_gru_gates_bf16(const __nv_bfloat16* h,
                                   const __nv_bfloat16* x,
                                   const __nv_bfloat16* cr,
                                   const __nv_bfloat16* wzr, const float* bzr,
                                   const __nv_bfloat16* wq, const float* bq,
                                   __nv_bfloat16* zr, __nv_bfloat16* qpre,
                                   __nv_bfloat16* rh_scratch, int batch,
                                   int height, int width, int ch, int cx,
                                   void* stream) {
  return run<__nv_bfloat16>(h, x, cr, wzr, bzr, wq, bq, zr, qpre, rh_scratch,
                            batch, height, width, ch, cx, stream);
}
