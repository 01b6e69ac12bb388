// Fused ConvGRU gate pre-activations for NVIDIA Hopper (sm_90a) on the
// tensor cores: bf16 on wgmma, fp32 as 3xTF32 on wgmma.
//
// Replaces the TPU kernel raft_stereo_tpu/kernels/gru_fused.py:153
// (_gates_kernel, launched at :227):
//     zr   = conv3x3([h, x], Wzr) + bzr
//     r    = sigmoid(zr[..., Ch:] + cr)
//     qpre = conv3x3([r*h, x], Wq) + bq
// NHWC activations, zero padding of one pixel (SAME), fp32 biases.
// Activations are fp32 or bf16 (one type T); the weights arrive packed by
// the wrapper (kernels/gru_fused.py, cached per weight tensor and version):
// HWIO regrouped K-major as (9, Cin'/E, Cout, E), E = 16 bytes of T, Cin'
// = Cin zero-padded to a multiple of 16, and for fp32 as two such planes,
// the TF32 high part and the TF32 low part.  The rounding points are the
// TPU kernel's: products accumulate in fp32, the fp32 bias joins the
// accumulator before any rounding, r is computed in fp32 from the
// unrounded zr, r*h is rounded to T before the q conv reads it, and zr and
// qpre are rounded once to T.
//
// Bound: operations.  A KITTI-size default iteration (gru08, gru16, gru32)
// is 102.7 GFLOP; the realtime one (gru08 once, gru16 twice) 26.5 GFLOP in
// bf16: 0.027 ms at the bf16 tensor-core rate.  The TPU kernel runs fp32 at
// Precision.HIGHEST, a multi-pass bf16 product of fp32 accuracy, and the
// port's fp32 model is full fp32, so a single TF32 pass (about three
// decimal digits) is not this function.  The fp32 instantiation is 3xTF32:
// a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi), likewise for
// the weights, and a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the dropped
// a_lo*b_lo is 2^-22 relative): three TF32 products, so the bound is
// 3 x 102.7 GFLOP at 495 TFLOP/s = 0.622 ms per default iteration (1.533 ms
// for the same work on the fp32 CUDA cores).
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// 9 taps x Cin.  A block is WG warpgroups (128 threads each) and owns a
// tile of 4*WG rows by 16 columns of output pixels of one image (each
// warpgroup 64 pixels, one wgmma M) by BN output channels, and KS blocks
// of a thread-block cluster may share one tile and split its K, rank 0
// adding the others' sums from their shared memory (one launch: the r
// coupling needs the full sum).  The wrapper picks the tile per launch:
// 128 x 2 where that fills the card (two warpgroups share each stage's
// weights, which halves their traffic), else with K split in two, else
// 64 x 2 or 64 x 1 split in two at the small levels (at 1,872 pixels a
// 128 x 2 tile gives 15 blocks to 132 SMs, and each block's chain of
// stages, not the tensor rate, sets the time).  K is walked in stages of
// 32 bytes of input channels (16 bf16 or 8 fp32: one wgmma K step) over
// all 9 taps.  Each stage brings, into a ring of 2 to 4 buffers in shared
// memory:
//   - the tile's halo patch, (4*WG + 2) x 18 pixels of those channels,
//     gathered with cp.async and zero filled outside the image (the SAME
//     padding) and beyond Cin: the 9 taps read it shifted, so each input
//     value crosses from L2 once per tile and not once per tap;
//   - the stage's weights, 9 taps x BN rows of 32 bytes per plane, with
//     bulk copies (cp.async.bulk, issued by the lanes of warp 0) that
//     complete on an mbarrier.
// Gathering each tap's rows apart and loading the weights with cp.async
// leaves the loads as long as the products and not overlapped with them;
// this design cuts the L2 traffic and takes the weights off the
// load/store path.  A reaches the tensor cores from registers:
// ldmatrix reads the shifted patch rows, so the tap shift costs an address
// and no im2col copy, and the fp32 split happens on these registers
// (cvt.rna.tf32).  One tap's wgmmas stay in flight while the next tap's
// fragment loads.  B is read by wgmma from shared memory in the K-major
// layout without swizzle (8-row x 16-byte core matrices), which is why the
// weights are packed K-major: TF32 wgmma takes no MN-major operand, and
// one layout serves both types.  fp32 keeps two accumulators: each
// stage's 27 wgmmas start a fresh tensor-core accumulator (which sums in
// its own order and truncates), added into the running fp32 sum with
// round-to-nearest adds, so the sum over Cin = 384 keeps fp32 accuracy
// (with a single accumulator the truncation errors of 432 stages pile up
// beyond those of an fp32 convolution).  Why wgmma and not mma.sync for TF32: wgmma is
// the route to Hopper's full tensor rate, and with A from registers the
// split still happens at fragment load, as it would with mma.sync; the
// K-major copy of the weights costs nothing per call once cached.
//
// Two launches per call, from one kernel template: the first computes zr
// and, in its epilogue, r*h for the channels of the r half, written to a
// scratch buffer in device memory; the second computes qpre over
// [r*h, x].  The TPU kernel instead recomputes zr on a one-pixel ring
// around its row block to keep r*h on chip; here the round trip of r*h
// (15 MB at the finest default level) costs far less than that recompute.
// The zero padding of the q conv is exact: outside the image the gather
// reads zeros, just as padded h makes r*h zero on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTW = 16;        // tile width, pixels
constexpr int kPW = kTW + 2;   // halo patch width
constexpr int kSG = 2;         // 16-byte channel groups per stage (32 B)

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kE = 4;       // elements per 16-byte group
  static constexpr int kPlanes = 2;  // TF32 high and low parts of B
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kE = 8;
  static constexpr int kPlanes = 1;
};

// Shared memory of one block of (BN, WG): kStages stage buffers, each the
// halo patch then the weight planes, and one mbarrier per stage.
template <typename T, int BN, int WG>
struct Smem {
  static constexpr int kPatch = (4 * WG + 2) * kPW;       // patch pixels
  static constexpr int kA = kSG * kPatch * 16;            // patch bytes
  static constexpr int kB = 9 * kSG * BN * 16;            // one plane
  static constexpr int kStage = kA + Traits<T>::kPlanes * kB;
  // As deep as leaves room for two blocks per SM, and 2 to 4 deep.
  static constexpr int kFit = (113 * 1024) / kStage;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kBytes = kStages * kStage + 8 * kStages;
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Bulk copy global -> shared (16-byte multiples), completing on an mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Thread-block clusters: this block's rank, the cluster-wide barrier
// (release/acquire) and a float read from a peer block's shared memory.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float peer_load(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices adjacent in K), stride byte offset
// (between core matrices adjacent in N), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16 bf16 and m64nNk8 tf32, A from registers, B K-major from shared
// memory, fp32 accumulators: d = a * b + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}


template <typename T, int BN>
struct Mma;
template <>
struct Mma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    wgmma_bf16_n128(d, a, desc, scale_d);
  }
};
template <>
struct Mma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    wgmma_bf16_n64(d, a, desc, scale_d);
  }
};
template <>
struct Mma<float, 128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    wgmma_tf32_n128(d, a, desc, scale_d);
  }
};
template <>
struct Mma<float, 64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    wgmma_tf32_n64(d, a, desc, scale_d);
  }
};

// ------------------------------------------------------------- kernel
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two consecutive values, each rounded once to the destination type.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
struct ConvArgs {
  const T* src0;      // first input part, NHWC with c0 channels
  const T* src1;      // second input part, NHWC with c1 channels
  int c0, c1;
  const T* w;         // packed (planes, 9, cin16 / E, cout, E)
  int cin16;          // c0 + c1 rounded up to a multiple of 16
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

// KS > 1: the KS blocks of a thread-block cluster share one output tile
// and split its K (the channel stages); rank 0 adds the others' sums from
// their shared memory and runs the epilogue.
template <typename T, int BN, int WG, int KS, bool kRCouple>
__global__ void __launch_bounds__(128 * WG)
gates_conv_kernel(const ConvArgs<T> a) {
  using S = Smem<T, BN, WG>;
  constexpr int kE = Traits<T>::kE;
  constexpr int kPlanes = Traits<T>::kPlanes;
  constexpr bool kSplit = kPlanes == 2;
  constexpr int kThreads = 128 * WG;
  constexpr int kTH = 4 * WG;
  constexpr int kChunk = kSG * kE;  // input channels per stage
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t smem0 = smem_addr(smem);
  const uint32_t bars = smem0 + S::kStages * S::kStage;

  const int tid = threadIdx.x;
  const int tiles_w = (a.width + kTW - 1) / kTW;
  const int tiles_h = (a.height + kTH - 1) / kTH;
  const int rank = KS > 1 ? cluster_rank() : 0;
  const int tile = blockIdx.x / KS;
  const int b = tile / (tiles_w * tiles_h);
  const int y0 = (tile / tiles_w) % tiles_h * kTH;
  const int x0 = tile % tiles_w * kTW;
  const int n0 = blockIdx.y * BN;
  const int cin = a.c0 + a.c1;
  const int n_valid = min(BN, a.cout - n0);
  const int groups = a.cin16 / kE;  // 16-byte groups of one weight row
  const long long plane = 9LL * a.cin16 * a.cout;

  // Gather duty: patch entries tid and tid + kThreads (if inside the
  // patch), entry e = pixel e / 2, channel group e % 2; the pixel's offset
  // in the image, or -1 outside it.
  constexpr int kPer = (kSG * S::kPatch + kThreads - 1) / kThreads;
  int pix[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    const int p = e / kSG;
    const int yy = y0 - 1 + p / kPW;
    const int xx = x0 - 1 + p % kPW;
    pix[i] = (e < kSG * S::kPatch && yy >= 0 && yy < a.height && xx >= 0 &&
              xx < a.width)
                 ? (b * a.height + yy) * a.width + xx
                 : -1;
  }

  if (tid == 0) {
    for (int i = 0; i < S::kStages; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This block's stages: [s_first, s_first + n_stages) of the whole K.
  const int n_all = (cin + kChunk - 1) / kChunk;
  const int per_rank = (n_all + KS - 1) / KS;
  const int s_first = rank * per_rank;
  const int n_stages = max(0, min(n_all - s_first, per_rank));

  auto load_stage = [&](int local, int buf) {
    const int s = s_first + local;
    const uint32_t base = smem0 + buf * S::kStage;
    // A: the halo patch of channels [s * kChunk, (s + 1) * kChunk).
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kSG * S::kPatch) {
        const int g = e % kSG;
        const int cg = s * kChunk + g * kE;
        const bool first = cg < a.c0;
        const bool ok = pix[i] >= 0 && cg < cin;
        const T* src =
            ok ? (first ? a.src0 + static_cast<long long>(pix[i]) * a.c0 + cg
                        : a.src1 + static_cast<long long>(pix[i]) * a.c1 +
                              (cg - a.c0))
               : a.src0;
        cp_async16(base + (g * S::kPatch + e / kSG) * 16, src, ok ? 16 : 0);
      }
    }
    // B: 9 taps x kSG groups x planes rows of n_valid x 16 bytes, one
    // bulk copy per row, spread over the lanes of warp 0.
    if (tid < 32) {
      const uint32_t bar = bars + 8 * buf;
      if (tid == 0) mbar_expect_tx(bar, 9 * kSG * kPlanes * n_valid * 16);
      __syncwarp();
      for (int r = tid; r < 9 * kSG * kPlanes; r += 32) {
        const int pl = r / (9 * kSG);
        const int tap = r % (9 * kSG) / kSG;
        const int g = s * kSG + r % kSG;
        bulk_copy(base + S::kA + r * BN * 16,
                  a.w + pl * plane +
                      (static_cast<long long>(tap * groups + g) * a.cout +
                       n0) * kE,
                  n_valid * 16, bar);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float part[kSplit ? BN / 2 : 1];  // fp32: one stage's tensor-core sum
#pragma unroll
  for (int i = 0; i < (kSplit ? BN / 2 : 1); ++i) part[i] = 0.f;

#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i) {
    if (i < n_stages) load_stage(i, i);
    cp_async_commit();
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;  // = the tile row of the warp's 16 pixels
  // ldmatrix duty: matrix lane / 8 of the x4 (columns +8 for odd matrices,
  // the second 16-byte group for matrices 2 and 3), its row lane % 8: the
  // patch entry of tile pixel (warp, tx) at tap (dy, dx) is pixel
  // (warp + dy) * kPW + tx + dx of group lg.
  const int ltx = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lg = lane >> 4;
  const int lrow = (lg * S::kPatch + warp * kPW + ltx) * 16;

  for (int s = 0; s < n_stages; ++s) {
    const int buf = s % S::kStages;
    cp_async_wait<S::kStages - 2>();
    __syncthreads();
    {
      const int nxt = s + S::kStages - 1;
      if (nxt < n_stages) load_stage(nxt, nxt % S::kStages);
      cp_async_commit();
    }
    mbar_wait(bars + 8 * buf, (s / S::kStages) & 1);
    const uint32_t base = smem0 + buf * S::kStage;
    const uint32_t bbase = base + S::kA;
    uint32_t frag[2][4];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      ldmatrix_x4(frag[t & 1], base + lrow + (t / 3 * kPW + t % 3) * 16);
      const uint64_t d_hi =
          make_desc(bbase + t * kSG * BN * 16, BN * 16, 128);
      if constexpr (kSplit) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = __uint_as_float(frag[t & 1][i]);
          hi[i] = tf32_rna(v);
          lo[i] = tf32_rna(v - __uint_as_float(hi[i]));
        }
        const uint64_t d_lo =
            make_desc(bbase + S::kB + t * kSG * BN * 16, BN * 16, 128);
        wgmma_fence();
        Mma<T, BN>::run(part, lo, d_hi, t > 0);
        Mma<T, BN>::run(part, hi, d_lo, 1);
        Mma<T, BN>::run(part, hi, d_hi, 1);
      } else {
        wgmma_fence();
        Mma<T, BN>::run(acc, frag[t & 1], d_hi, 1);
      }
      // One tap in flight while the next one's fragment loads: the wait
      // frees the registers the tap before read.
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    if constexpr (kSplit) {
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    } else {
      fence_regs(acc);
    }
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {
    // Split K: the other ranks leave their sums in their own shared memory
    // (the stage ring is free now), rank 0 adds them.  The second barrier
    // keeps every block's shared memory alive until rank 0 has read it.
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) red[i * kThreads + tid] = acc[i];
    }
    cluster_sync();
    if (rank == 0) {
      for (int peer = 1; peer < KS; ++peer)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          acc[i] += peer_load(smem0 + (i * kThreads + tid) * 4, peer);
    }
    cluster_sync();
    if (rank != 0) return;
  }

  // Epilogue.  Accumulator i of thread (warp, lane): row warp*16 + lane/4
  // (+8 for i % 4 >= 2), column 8*(i/4) + 2*(lane%4) + i%2; the row is
  // tile pixel (warp, row % 16).
  const int y = y0 + warp;
  if (y >= a.height) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int x = x0 + (lane >> 2) + 8 * j;
    if (x >= a.width) continue;
    const long long p = (static_cast<long long>(b) * a.height + y) * a.width + x;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * (lane & 3);
      if (n >= a.cout) continue;  // cout % 8 == 0: n + 1 valid too
      const float v0 = acc[4 * i + 2 * j] + a.bias[n];
      const float v1 = acc[4 * i + 2 * j + 1] + a.bias[n + 1];
      store2(a.out + p * a.cout + n, v0, v1);
      if (kRCouple && n >= a.ch) {
        const long long o = p * a.ch + (n - a.ch);
        const float r0 = 1.f / (1.f + expf(-(v0 + to_float(a.cr[o]))));
        const float r1 = 1.f / (1.f + expf(-(v1 + to_float(a.cr[o + 1]))));
        store2(a.rh + o, r0 * to_float(a.h[o]), r1 * to_float(a.h[o + 1]));
      }
    }
  }
}

template <typename T, int BN, int WG, int KS, bool kRCouple>
cudaError_t launch(const ConvArgs<T>& a, cudaStream_t s) {
  auto* fn = gates_conv_kernel<T, BN, WG, KS, kRCouple>;
  constexpr int bytes = Smem<T, BN, WG>::kBytes;
  static bool configured[64] = {};  // the attribute, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  const int tiles = ((a.width + kTW - 1) / kTW) *
                    ((a.height + 4 * WG - 1) / (4 * WG)) * a.batch;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * KS, (a.cout + BN - 1) / BN);
  cfg.blockDim = dim3(128 * WG);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = KS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = KS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kRCouple>
cudaError_t launch_tile(const ConvArgs<T>& a, int bn, int wg, int ks,
                        cudaStream_t s) {
  if (bn == 128 && wg == 2 && ks == 1)
    return launch<T, 128, 2, 1, kRCouple>(a, s);
  if (bn == 128 && wg == 2 && ks == 2)
    return launch<T, 128, 2, 2, kRCouple>(a, s);
  if (bn == 64 && wg == 2 && ks == 2)
    return launch<T, 64, 2, 2, kRCouple>(a, s);
  if (bn == 64 && wg == 1 && ks == 2)
    return launch<T, 64, 1, 2, kRCouple>(a, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const T* h, const T* x, const T* cr, const T* wzr, const float* bzr,
        const T* wq, const float* bq, T* zr, T* qpre, T* rh_scratch,
        int batch, int height, int width, int ch, int cx, const int* tiles,
        void* stream) {
  if (ch % 8 || cx % 8) return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  ConvArgs<T> a = {};
  a.src0 = h;
  a.c0 = ch;
  a.src1 = x;
  a.c1 = cx;
  a.w = wzr;
  a.cin16 = (ch + cx + 15) / 16 * 16;
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
  cudaError_t err = launch_tile<T, true>(a, tiles[0], tiles[1], tiles[2], s);
  if (err != cudaSuccess) return (int)err;

  a.src0 = rh_scratch;
  a.w = wq;
  a.bias = bq;
  a.out = qpre;
  a.cout = ch;
  a.cr = nullptr;
  a.h = nullptr;
  a.rh = nullptr;
  return (int)launch_tile<T, false>(a, tiles[3], tiles[4], tiles[5], s);
}

}  // namespace

// h, cr, rh_scratch, qpre: (B, H, W, ch); x: (B, H, W, cx); zr: (B, H, W,
// 2*ch); wzr, wq: the packed weights of (3, 3, ch+cx, 2*ch) and (3, 3,
// ch+cx, ch); bzr (2*ch), bq (ch) fp32.  Contiguous device pointers; ch
// and cx multiples of 8; tiles (host memory) the (BN, WG, KS) of the zr
// launch, then of the q launch: BN output channels by WG warpgroups of 64
// pixels, K split over a cluster of KS blocks; (128, 2, 1), (128, 2, 2),
// (64, 2, 2) or (64, 1, 2).  raft_gru_gates takes fp32, raft_gru_gates_bf16
// bf16 activations.
extern "C" int raft_gru_gates(const float* h, const float* x, const float* cr,
                              const float* wzr, const float* bzr,
                              const float* wq, const float* bq, float* zr,
                              float* qpre, float* rh_scratch, int batch,
                              int height, int width, int ch, int cx,
                              const int* tiles, void* stream) {
  return run<float>(h, x, cr, wzr, bzr, wq, bq, zr, qpre, rh_scratch, batch,
                    height, width, ch, cx, tiles, stream);
}

extern "C" int raft_gru_gates_bf16(
    const __nv_bfloat16* h, const __nv_bfloat16* x, const __nv_bfloat16* cr,
    const __nv_bfloat16* wzr, const float* bzr, const __nv_bfloat16* wq,
    const float* bq, __nv_bfloat16* zr, __nv_bfloat16* qpre,
    __nv_bfloat16* rh_scratch, int batch, int height, int width, int ch,
    int cx, const int* tiles, void* stream) {
  return run<__nv_bfloat16>(h, x, cr, wzr, bzr, wq, bq, zr, qpre, rh_scratch,
                            batch, height, width, ch, cx, tiles, stream);
}

// Dynamic shared memory of one block, in bytes (bf16: 0 for fp32, 1 for
// bf16; the tile as above).
extern "C" int raft_gru_gates_smem_bytes(int bf16, int bn, int wg) {
  if (bn == 128 && wg == 2)
    return bf16 ? Smem<__nv_bfloat16, 128, 2>::kBytes
                : Smem<float, 128, 2>::kBytes;
  if (bn == 64 && wg == 2)
    return bf16 ? Smem<__nv_bfloat16, 64, 2>::kBytes
                : Smem<float, 64, 2>::kBytes;
  if (bn == 64 && wg == 1)
    return bf16 ? Smem<__nv_bfloat16, 64, 1>::kBytes
                : Smem<float, 64, 1>::kBytes;
  return -1;  // KS does not change a block's shared memory
}
