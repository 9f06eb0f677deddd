// Fused StyleGAN2 styled 3x3 convolution, forward:
//
//     out = lrelu(conv3x3_same(x * s, w) * d + noise_w * noise + bias, slope) * gain
//
// x [B, H, W, Cin] NHWC; w [3, 3, Cin, Cout] already scaled by
// 1/sqrt(9 Cin); s [B, Cin] the style modulation; d [B, Cout] the
// demodulation; noise [NB, H, W] with NB = 1 (shared) or B, or null: all f32,
// or all bf16 (the bf16 instance below); noise_w [1] and bias [Cout] f32.
//
// Replaces the TPU kernel latent2im_tpu/ops/pair_conv.py:
// fused_styled_conv3x3_pair (with _kernel), which the JAX package routes to
// from models/stylegan2.py:styled_conv. Here it runs for every non-up styled
// conv of synthesis, with no channel or resolution gate.
//
// Bound on an H100: operations, 2*B*H*W*9*Cin*Cout flops (515 GFLOP per
// 256 px training step at B=4) against a few bytes per output. On the CUDA
// cores in f32 (67 TFLOP/s) that is 7.69 ms per step. The TPU kernel computes
// at Precision.HIGHEST, multi-pass bf16 on the MXU; the Hopper counterpart is
// 3xTF32 on the tensor cores: each operand v splits into big = tf32(v) and
// small = tf32(v - big), and small*big + big*small + big*big accumulate in f32
// registers, which keeps f32-level error (single-pass TF32 does not hold the
// 1e-5 tolerance) at a third of the 495 TFLOP/s dense TF32 rate: 3.12 ms per
// step.
//
// Design: one implicit GEMM over the whole batch, M = B*H*W output pixels,
// N = Cout, K = 9*Cin ordered (tap, input channel), with no im2col tensor
// and no per-sample weight: conv(x*s, w)*d is computed as the TPU kernel's
// per-sample weights would give it, s scaling each A row by its own
// sample's channel scales as the row is loaded, d scaling each accumulator
// row by its sample's demodulation in the epilogue. So all samples share
// one weight, and the batch fills M at the small resolutions. Per call, a
// first launch (styled_conv_weight_kmajor_kernel, one pass over 9*Cin*Cout
// floats into the workspace) transposes the [3,3,Cin,Cout] weight the
// wrapper takes to [9, Cout, Cin]: wgmma reads TF32 operands only K-major.
// The product runs on wgmma (m64n128k8, TF32, both operands in shared
// memory): each K step of one tap x 32 input channels is one group of
// small*big, big*small, big*big for each k8 slice, the small terms first.
// The threads load a K step into registers (x at the tap's shifted pixels,
// zeros outside the image and past Cin: the same-padding and the ragged
// tiles), split it into TF32 halves with the rounding of cvt.rna.tf32.f32
// (as integer operations) and store the halves in the 128-byte swizzle
// layout, in a ring of stages, so the tensor cores run group k while step
// k + 1 is split and step k + 2 loaded. The tensor cores accumulate
// with truncation; left alone over K = 4608 that bias put the walk
// gradient of a training step 1.5x further from an f64 reference than
// the CPU's f32, so every two K steps sum from zero and join the running
// f32 sum with a rounded add, which puts the kernel closer to an f64
// reference than cuDNN's f32 convolution.
//
// The two problems of the f32 CUDA-core version this replaces:
//  - the FMA peak: the tensor cores carry the arithmetic (3.12 ms bound
//    against 7.69);
//  - latency at 4..32 px, where a grid of per-sample tiles filled a quarter
//    of the card: M runs across the batch, 64 x 128 tiles (one warpgroup,
//    two blocks per SM) serve grids under one wave of 128 x 128 ones (two
//    warpgroups, one block per SM), and K
//    splits over (tap, channel chunk) until about two blocks per SM are in
//    flight. Split blocks write raw partial sums to the workspace; a last
//    launch (styled_conv_splitk_reduce_kernel) adds them in split order,
//    with no float atomics, so two runs give bit-identical results, and
//    applies the epilogue. A call is two launches, three when K is split;
//    the wrapper's count stays one per call.
//
// The bf16 instance (the JAX package's --bf16 compute; pair_conv.py keeps
// bf16 operands exact on the MXU with f32 accumulators, :114-116, an f32
// epilogue and one bf16 store, :130-133): A = bf16(x * s), the product of
// two bf16 values (exact in f32) rounded once, as a bf16 multiply rounds; B
// the bf16 weight, made K-major by the same first launch. The product runs
// on wgmma m64n128k16 with bf16 operands and f32 accumulators: a 128-byte
// swizzle row holds 64 bf16 channels, so a K step is one tap x 64 channels
// and one product per k16 slice (four per step) where the f32 instance
// issues three per k8 slice (twelve). Bound: 2*B*H*W*9*Cin*Cout flops at
// 989 TFLOP/s dense bf16 (0.52 ms per 256 px training step at B=4), against
// 2 bytes per element of x, w and out. The epilogue is f32: acc * d +
// noise_w * noise + bias, LeakyReLU * gain, one bf16 store (d and noise are
// bf16 values). The tiling, split K with its fixed-order reduction (partial
// sums in f32) and the flush of the truncating accumulation every two K
// steps are those of the f32 instance.
//
// The bf16 thin form (Cout <= 64, Cin <= 64: the 1024 px model's 512^2 x 64
// and 1024^2 x 32 layers, styled_conv_bf16_thin_kernel). There the tiling
// above wastes most of its work: an N tile of 128 holds 32 or 64 channels,
// a 64-channel K step is half zeros at Cin 32, and a 128-row tile's nine K
// steps with one block per SM leave load latency exposed; at 1024^2 x 32 it
// ran 2.3x slower than cuDNN's bf16 grouped conv. The thin form:
//  - N follows Cout: wgmma m64n32k16 for Cout <= 32, m64n64k16 up to 64
//    (16 or 32 f32 accumulators a thread), zero weight rows past Cout;
//  - K is (tap, 16-channel slice), Cin rounded up to 16 only, so no zero
//    half at Cin 32. Neither swizzle is used: a row tile is THIN_BM pixels of
//    one image row, and x is staged once per image row as a halo row of
//    THIN_BM + 2 pixels (A = bf16(x * s), rounded in place). The A operand of
//    tap (dy, dx) is then the halo row y + dy read from column 1 + dx, a
//    descriptor shifted by whole 16-byte rows, which the no-swizzle layout
//    (8 x 16-byte core matrices, rows 16 bytes apart) allows at any row and a
//    swizzled one (its pattern tied to the address bits of the row) does not.
//    Each halo row serves three output rows and nine taps;
//  - the block's whole K-major weight, [9][Cin/8][N][8] (18 KB at 32 x 32,
//    72 KB at 64 x 64), is read from w once per block into shared memory and
//    stays there: no transpose launch and no workspace;
//  - a persistent grid (the blocks that fit on the SMs at once) of blocks of
//    up to four warpgroups (three at N 64), each with its own ring of five halo
//    rows and an equal share of the row tiles, walking down the image: row
//    y + 3 is copied with cp.async (zeros outside the image) while row y is
//    computed, two rows ahead of its use. No split K;
//  - the epilogue as above (acc * d + noise_w * noise + bias, LeakyReLU *
//    gain, one bf16 store). The flush is dropped: the sums are 9 * Cin <= 576
//    terms, and the truncating accumulation's bias over 36 k16 steps lies
//    far under the 2^-7 gate of a bf16 result. Fixed order, no atomics:
//    reruns are bit-identical.
//
// The tensor-parallel split (parallel/tensor.py; the JAX package's Megatron
// layout makes the partner conv row-parallel, so each rank holds a slice of
// Cin): l2i_styled_conv3x3_partial is the product over that slice with the
// epilogue switched off, a template parameter RAW of every product kernel
// and of the split-K reduction, whose false instances are the fused
// kernel's, unchanged (scripts/torch_sass_diff.py compares their SASS); it
// writes raw f32 sums, which the ranks all-reduce in f32.
// l2i_styled_conv3x3_epilogue is the split-K reduction over the summed
// buffer with one split: d (from the summed sums of squares, which no rank
// holds alone), noise, bias, LeakyReLU * gain, one store in x's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;            // K per stage: one tap x 32 input channels (f32)
constexpr int BK_BF16 = 64;       // the bf16 instance's: one tap x 64 input channels
constexpr int BN = 128;           // output channels per block: one wgmma n128
constexpr int MAX_SPLITS = 32;

// T = float (the 3xTF32 instance) or __nv_bfloat16 (the bf16 instance);
// noise_w, bias and the split-K partial sums are f32 in both
template <typename T>
struct ParamsT {
  const T* x;
  const T* w;
  const T* s;
  const T* d;
  const T* noise;
  const float* noise_w;
  const float* bias;
  T* out;
  T* wt;      // the weight transposed to [9][Cout][cinp] (K-major)
  float* ws;  // split-K partial sums [splits][M][Cout], or null
  int H, W, cin, cinp, cout, noise_per_sample;
  int M, HW, kchunks, ksteps, splits;
  float slope, gain;
};
using Params = ParamsT<float>;
using ParamsBf16 = ParamsT<__nv_bfloat16>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
// read-only loads through the non-coherent cache, as f32
__device__ __forceinline__ float ldg_f32(const float* q) { return __ldg(q); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* q) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(q))));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// v = big + small, both TF32, each rounded to nearest with ties away from
// zero as cvt.rna.tf32.f32 rounds (bit-identical for finite values), in
// integer operations, which issue at a higher rate than the conversion.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// layout: rows of 128 bytes (32 TF32 or 64 bf16 values), the 16-byte chunk c
// of row r stored at chunk c ^ (r % 8), 8-row groups 1024 bytes apart; the
// tile starts on a 1024-byte boundary, and k slice k (k8 for TF32, k16 for
// bf16: 32 bytes either way) starts 32 * k bytes in.
__device__ __forceinline__ uint64_t sw128_desc(const void* start) {
  return (uint64_t)((smem_u32(start) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte chunk c (of 8) of row r in such a tile
__device__ __forceinline__ int sw128_offset(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of r across a wgmma boundary
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= a * b over one k8 step of a warpgroup's 64 x 128 tile, both
// operands TF32 in shared memory (descriptors); accumulate = 0 starts from
// zero. d: per warp w of the warpgroup rows 16w + g (+8), per j columns
// 8j + 2t (+1), in d[4j] .. d[4j + 3].
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same over one k16 step, both operands bf16 and K-major (no transpose).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The epilogue for one output, in f32: demodulate, noise, bias, LeakyReLU * gain.
template <typename T>
__device__ __forceinline__ float finish(const ParamsT<T>& p, float acc, int b, int n, float nz) {
  float v = acc * ldg_f32(p.d + (long long)b * p.cout + n) + nz + __ldg(p.bias + n);
  v = v >= 0.f ? v : v * p.slope;
  return v * p.gain;
}

template <typename T>
__device__ __forceinline__ float noise_term(const ParamsT<T>& p, int b, int q) {
  if (p.noise == nullptr) return 0.f;
  return __ldg(p.noise_w) * ldg_f32(p.noise + (p.noise_per_sample ? (long long)b * p.HW : 0) + q);
}

// w [9][Cin][Cout] -> [9][Cout][cinp], K-major for wgmma, through a 32 x 32
// shared tile; channels cin..cinp-1 are zero. Values pass through f32
// unchanged.
template <typename T>
__global__ void __launch_bounds__(256) styled_conv_weight_kmajor_kernel(const ParamsT<T> p) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z, ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + threadIdx.x;
    tile[r][threadIdx.x] =
        ci < p.cin && co < p.cout ? to_f32(p.w[((long long)tap * p.cin + ci) * p.cout + co]) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + threadIdx.x;
    if (co < p.cout && ci < p.cinp)
      p.wt[((long long)tap * p.cout + co) * p.cinp + ci] = from_f32<T>(tile[threadIdx.x][r]);
  }
}

// Split-tile stages of the ring: with one warpgroup the stage its group
// it - 1 read is free once that warpgroup waited for it, so two suffice and
// two blocks fit on an SM; with two, the other warpgroup may still read it.
__host__ __device__ constexpr int stages(int wgs) { return wgs == 1 ? 2 : 3; }

// One block: a (64 * WGS) x 128 output tile over the K steps of its split
// (blockIdx.z), WGS warpgroups of 64 x 128 each. VEC: Cin, Cout % 4 == 0
// and 16-byte aligned operands, so every load of x is 16 bytes.
//
// K step (one tap x 32 channels) `it` runs as one wgmma group per
// warpgroup: small*big, big*small, big*big for each of its four k8 steps,
// both operands' TF32 halves read from shared memory. A ring of stages of
// split tiles keeps the tensor cores fed: while group `it` runs, the
// threads split step it + 1 (loaded into registers one step earlier: x of
// the tap's shifted pixels, zeros outside the image, times s; the K-major
// weight) into a stage no group still reads, and load step it + 2. One
// barrier per step. RAW (the tensor-parallel partial): no epilogue, the
// raw f32 sums go to p.out, or with split K to the workspace as always.
template <int WGS, bool VEC, bool RAW>
__global__ void __launch_bounds__(WGS * 128, WGS == 1 ? 2 : 1)
    styled_conv_tc_kernel(const Params p) {
  constexpr int THREADS = WGS * 128, BM = WGS * 64, STAGES = stages(WGS);
  constexpr int A_HALF = BM * BK, B_HALF = BN * BK;  // floats of one TF32 half
  constexpr int STAGE = 2 * A_HALF + 2 * B_HALF;      // floats of one stage
  constexpr int ROW_STEP = THREADS / (BK / 4);
  constexpr int A_ITERS = BM / ROW_STEP, B_ITERS = BN / ROW_STEP;
  constexpr int FLUSH = 2;  // K steps summed in `part` between flushes
  static_assert(A_ITERS * ROW_STEP == BM && B_ITERS * ROW_STEP == BN, "staging map");

  // per stage: A big, A small, B big, B small; 1024-byte aligned for the swizzle
  extern __shared__ __align__(1024) float smem_raw[];
  float* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int step0 = (int)((long long)split * p.ksteps / p.splits);
  const int nsteps = (int)((long long)(split + 1) * p.ksteps / p.splits) - step0;

  // Staging map: this thread loads channels kc..kc+3 (kc = (tid % 8) * 4) of
  // A rows r_0 + i * ROW_STEP (their pixel, image row and column and sample
  // fixed over K) and of weight rows (output channels) r_0 + i * ROW_STEP.
  const int kc = (tid % (BK / 4)) * 4, r_0 = tid / (BK / 4);
  int rp[A_ITERS], ry[A_ITERS], rx[A_ITERS], rb[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int pix = m0 + r_0 + i * ROW_STEP;
    rp[i] = pix;
    rb[i] = pix < p.M ? pix / p.HW : 0;
    const int q = pix - rb[i] * p.HW;
    ry[i] = pix < p.M ? q / p.W : -(1 << 20);  // never inside the image
    rx[i] = q % p.W;
  }
  float4 xa[A_ITERS], wv[B_ITERS];  // the next K step, in flight

  auto load = [&](int step) {
    const int tap = step / p.kchunks;
    const int ci = (step - tap * p.kchunks) * BK + kc;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int yy = ry[i] + dy, xx = rx[i] + dx;
      const bool in = yy >= 0 && yy < p.H && xx >= 0 && xx < p.W;
      const long long o = (long long)(rp[i] + dy * p.W + dx) * p.cin + ci;
      const long long so = (long long)rb[i] * p.cin + ci;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f), sv = v;
      if (VEC) {
        if (in && ci < p.cin) {
          v = __ldg(reinterpret_cast<const float4*>(p.x + o));
          sv = __ldg(reinterpret_cast<const float4*>(p.s + so));
        }
      } else if (in) {
        if (ci < p.cin) v.x = __ldg(p.x + o) * __ldg(p.s + so);
        if (ci + 1 < p.cin) v.y = __ldg(p.x + o + 1) * __ldg(p.s + so + 1);
        if (ci + 2 < p.cin) v.z = __ldg(p.x + o + 2) * __ldg(p.s + so + 2);
        if (ci + 3 < p.cin) v.w = __ldg(p.x + o + 3) * __ldg(p.s + so + 3);
        sv = make_float4(1.f, 1.f, 1.f, 1.f);
      }
      xa[i] = make_float4(v.x * sv.x, v.y * sv.y, v.z * sv.z, v.w * sv.w);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int n = n0 + r_0 + i * ROW_STEP;
      wv[i] = n < p.cout && ci < p.cinp
                  ? __ldg(reinterpret_cast<const float4*>(
                        p.wt + ((long long)tap * p.cout + n) * p.cinp + ci))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // (v0..v3) -> their big halves at `big`, small halves at `small`
  auto put = [](char* big, char* small, int off, float4 v) {
    uint32_t b[4], l[4];
    split_tf32(v.x, b[0], l[0]);
    split_tf32(v.y, b[1], l[1]);
    split_tf32(v.z, b[2], l[2]);
    split_tf32(v.w, b[3], l[3]);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) = make_uint4(l[0], l[1], l[2], l[3]);
  };
  auto store = [&](int stage) {
    char* st = reinterpret_cast<char*>(smem + stage * STAGE);
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i)
      put(st, st + 4 * A_HALF, sw128_offset(r_0 + i * ROW_STEP, kc / 4), xa[i]);
    char* bt = st + 8 * A_HALF;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i)
      put(bt, bt + 4 * B_HALF, sw128_offset(r_0 + i * ROW_STEP, kc / 4), wv[i]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // -> wgmma
  };

  // The tensor cores add into their accumulator with truncation, whose bias
  // would grow over the 3 * 9 * Cin / 8 updates of a running sum: FLUSH K
  // steps of products sum from zero in `part`, which then joins the running
  // sum `acc` with a rounded f32 add.
  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;

  const int wg = warp / 4;
  load(step0);
  store(0);
  if (nsteps > 1) load(step0 + 1);
  for (int it = 0; it < nsteps; ++it) {
    __syncthreads();  // stage `it` is complete; groups <= it - 2 are done everywhere
    const char* st = reinterpret_cast<const char*>(smem + (it % STAGES) * STAGE);
    const char* a_big = st + wg * 64 * 128;
    const char* a_small = a_big + 4 * A_HALF;
    const char* b_big = st + 8 * A_HALF;
    const char* b_small = b_big + 4 * B_HALF;
#pragma unroll
    for (int e = 0; e < 64; ++e) fence_operand(part[e]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      const int from_zero = k == 0 && it % FLUSH == 0;
      wgmma_tf32(part, sw128_desc(a_small + 32 * k), sw128_desc(b_big + 32 * k), !from_zero);
      wgmma_tf32(part, sw128_desc(a_big + 32 * k), sw128_desc(b_small + 32 * k), 1);
      wgmma_tf32(part, sw128_desc(a_big + 32 * k), sw128_desc(b_big + 32 * k), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's group it - 1 is done
    if (it + 1 < nsteps) store((it + 1) % STAGES);
    if (it + 2 < nsteps) load(step0 + it + 2);
    if ((it + 1) % FLUSH == 0 || it + 1 == nsteps) {
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        fence_operand(part[e]);
        acc[e] += part[e];
      }
    }
  }

  // Epilogue: rows m0 + 16 * warp + g (+8), columns n0 + 8j + 2t (+1)
  const int arow = 16 * warp + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = m0 + arow + 8 * h;
    if (pix >= p.M) continue;
    const int b = pix / p.HW;
    const float nz = !RAW && p.splits == 1 ? noise_term(p, b, pix - b * p.HW) : 0.f;
    float* orow = p.splits == 1 ? p.out + (long long)pix * p.cout
                                : p.ws + ((long long)split * p.M + pix) * p.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (!RAW && p.splits == 1) {
        if (n < p.cout) v0 = finish(p, v0, b, n, nz);
        if (n + 1 < p.cout) v1 = finish(p, v1, b, n + 1, nz);
      }
      if (VEC) {
        if (n < p.cout) *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
      } else {
        if (n < p.cout) orow[n] = v0;
        if (n + 1 < p.cout) orow[n + 1] = v1;
      }
    }
  }
}

// The bf16 instance of styled_conv_tc_kernel: the same tiling, stage ring,
// flush and split K; A = bf16(x * s) (an exact f32 product rounded once)
// and the bf16 K-major weight, each K step one tap x 64 channels (a 128-byte
// swizzle row) as one stage of A and one of B, and one wgmma k16 per
// 32-byte k slice, four per step. VEC: Cin and Cout multiples of 8 and
// 16-byte aligned operands, so every load of x is eight bf16. RAW: no
// epilogue, the raw f32 sums go to p.out read as f32 (or the workspace).
template <int WGS, bool VEC, bool RAW>
__global__ void __launch_bounds__(WGS * 128, WGS == 1 ? 2 : 1)
    styled_conv_bf16_kernel(const ParamsBf16 p) {
  constexpr int THREADS = WGS * 128, BM = WGS * 64, STAGES = stages(WGS);
  constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;  // one K step of A, of B
  constexpr int STAGE = A_BYTES + B_BYTES;               // bytes of one stage
  constexpr int ROW_STEP = THREADS / 8;                  // 8 threads, 16 bytes each, a row
  constexpr int A_ITERS = BM / ROW_STEP, B_ITERS = BN / ROW_STEP;
  constexpr int FLUSH = 2;  // K steps summed in `part` between flushes
  static_assert(A_ITERS * ROW_STEP == BM && B_ITERS * ROW_STEP == BN, "staging map");

  extern __shared__ __align__(1024) unsigned char smem_b[];
  unsigned char* smem = smem_b + ((1024 - (smem_u32(smem_b) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int step0 = (int)((long long)split * p.ksteps / p.splits);
  const int nsteps = (int)((long long)(split + 1) * p.ksteps / p.splits) - step0;

  // Staging map: this thread loads channels kc..kc+7 (kc = (tid % 8) * 8)
  // of A rows r_0 + i * ROW_STEP and of weight rows r_0 + i * ROW_STEP.
  const int kc = (tid % 8) * 8, r_0 = tid / 8;
  int rp[A_ITERS], ry[A_ITERS], rx[A_ITERS], rb[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int pix = m0 + r_0 + i * ROW_STEP;
    rp[i] = pix;
    rb[i] = pix < p.M ? pix / p.HW : 0;
    const int q = pix - rb[i] * p.HW;
    ry[i] = pix < p.M ? q / p.W : -(1 << 20);  // never inside the image
    rx[i] = q % p.W;
  }
  uint4 xa[A_ITERS], wv[B_ITERS];  // the next K step, in flight: eight bf16 each

  auto load = [&](int step) {
    const int tap = step / p.kchunks;
    const int ci = (step - tap * p.kchunks) * BK_BF16 + kc;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int yy = ry[i] + dy, xx = rx[i] + dx;
      const bool in = yy >= 0 && yy < p.H && xx >= 0 && xx < p.W;
      const long long o = (long long)(rp[i] + dy * p.W + dx) * p.cin + ci;
      const long long so = (long long)rb[i] * p.cin + ci;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (VEC) {
        if (in && ci < p.cin) {
          const uint4 xv = __ldg(reinterpret_cast<const uint4*>(p.x + o));
          const uint4 sv = __ldg(reinterpret_cast<const uint4*>(p.s + so));
          const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w}, sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = unpack_bf16(xw[j]), b = unpack_bf16(sw[j]);
            v[2 * j] = a.x * b.x;
            v[2 * j + 1] = a.y * b.y;
          }
        }
      } else if (in) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ci + j < p.cin) v[j] = ldg_f32(p.x + o + j) * ldg_f32(p.s + so + j);
      }
      xa[i] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                         pack_bf16(v[6], v[7]));
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int n = n0 + r_0 + i * ROW_STEP;
      wv[i] = n < p.cout && ci < p.cinp
                  ? __ldg(reinterpret_cast<const uint4*>(
                        p.wt + ((long long)tap * p.cout + n) * p.cinp + ci))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store = [&](int stage) {
    unsigned char* st = smem + stage * STAGE;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i)
      *reinterpret_cast<uint4*>(st + sw128_offset(r_0 + i * ROW_STEP, kc / 8)) = xa[i];
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i)
      *reinterpret_cast<uint4*>(st + A_BYTES + sw128_offset(r_0 + i * ROW_STEP, kc / 8)) = wv[i];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // -> wgmma
  };

  // as in the f32 instance: FLUSH K steps from zero in `part`, joined to
  // `acc` with a rounded f32 add, against the truncating accumulation
  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;

  const int wg = warp / 4;
  load(step0);
  store(0);
  if (nsteps > 1) load(step0 + 1);
  for (int it = 0; it < nsteps; ++it) {
    __syncthreads();  // stage `it` is complete; groups <= it - 2 are done everywhere
    const unsigned char* st = smem + (it % STAGES) * STAGE;
    const unsigned char* a_tile = st + wg * 64 * 128;
    const unsigned char* b_tile = st + A_BYTES;
#pragma unroll
    for (int e = 0; e < 64; ++e) fence_operand(part[e]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int from_zero = k == 0 && it % FLUSH == 0;
      wgmma_bf16(part, sw128_desc(a_tile + 32 * k), sw128_desc(b_tile + 32 * k), !from_zero);
    }
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's group it - 1 is done
    if (it + 1 < nsteps) store((it + 1) % STAGES);
    if (it + 2 < nsteps) load(step0 + it + 2);
    if ((it + 1) % FLUSH == 0 || it + 1 == nsteps) {
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        fence_operand(part[e]);
        acc[e] += part[e];
      }
    }
  }

  // Epilogue: rows m0 + 16 * warp + g (+8), columns n0 + 8j + 2t (+1); in
  // f32, one bf16 store, or raw f32 partial sums when K is split
  const int arow = 16 * warp + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = m0 + arow + 8 * h;
    if (pix >= p.M) continue;
    const int b = pix / p.HW;
    const float nz = !RAW && p.splits == 1 ? noise_term(p, b, pix - b * p.HW) : 0.f;
    __nv_bfloat16* orow = p.out + (long long)pix * p.cout;
    float* prow = p.splits > 1 ? p.ws + ((long long)split * p.M + pix) * p.cout
                  : RAW        ? reinterpret_cast<float*>(p.out) + (long long)pix * p.cout
                               : nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (RAW || p.splits > 1) {
        if (VEC) {
          if (n < p.cout) *reinterpret_cast<float2*>(prow + n) = make_float2(v0, v1);
        } else {
          if (n < p.cout) prow[n] = v0;
          if (n + 1 < p.cout) prow[n + 1] = v1;
        }
        continue;
      }
      if (n < p.cout) v0 = finish(p, v0, b, n, nz);
      if (n + 1 < p.cout) v1 = finish(p, v1, b, n + 1, nz);
      if (VEC) {
        if (n < p.cout) *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v0, v1);
      } else {
        if (n < p.cout) orow[n] = __float2bfloat16(v0);
        if (n + 1 < p.cout) orow[n + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 form for Cout <= 64 and Cin <= 64 (the 512^2 x 64 and 1024^2 x 32
// layers of the 1024 px model): see the header. Each warpgroup walks a range
// of row tiles (THIN_BM output pixels of one image row of one sample), down
// the image, through a ring of halo rows in shared memory.
constexpr int THIN_BM = 64;      // output pixels of one image row per tile: one wgmma m64
constexpr int THIN_SLOTS = 5;    // halo rows per warpgroup: 3 read, 2 loading
// warpgroups per block (they share the weight): 4 with 16 accumulators a
// thread, 3 with 32 (the weight of 64 x 64 leaves room for three rings)
__host__ __device__ constexpr int thin_max_wgs(int n) { return n == 32 ? 4 : 3; }
constexpr int THIN_PLANE = (THIN_BM + 2) * 16;  // bytes of one 8-channel plane of a halo row

struct ThinParams {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;  // [3, 3, cin, cout], read once per block
  const __nv_bfloat16* s;
  const __nv_bfloat16* d;
  const __nv_bfloat16* noise;
  const float* noise_w;
  const float* bias;
  __nv_bfloat16* out;
  int H, W, cin, cout, noise_per_sample;
  int kch;     // 8-channel planes of K per tap: cin rounded up to 16, over 8
  int strips;  // row tiles across the image: ceil(W / THIN_BM)
  int wg_bytes;  // shared bytes of one warpgroup's ring and style vector
  long long tiles;  // B * strips * H row tiles
  float slope, gain;
};

// wgmma descriptor of a K-major operand without swizzle: 8 rows x 16 bytes
// (8 bf16 of K) per core matrix, rows 16 bytes apart, 8-row groups `sbo`
// bytes apart, the second 8 of a k16 slice `lbo` bytes after the first
__device__ __forceinline__ uint64_t plain_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= a * b over one k16 step of a 64 x N tile, N = 32 or 64, bf16
// operands K-major in shared memory; d as in wgmma_tf32 (per j < N / 8).
__device__ __forceinline__ void wgmma_bf16_n(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_bf16_n(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the 128 threads of warpgroup `wg` meet (barrier 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// One block: WGS = blockDim.x / 128 warpgroups sharing the K-major weight
// [9][KCH][N][8] (zeros past cin and cout), loaded once; each warpgroup owns
// a ring of THIN_SLOTS halo rows [KCH][THIN_BM + 2][8] (image columns x0 - 1
// .. x0 + THIN_BM, zeros outside the image) and its sample's style vector,
// and walks its share of the row tiles (b, strip, y), y fastest. Output row y
// reads the halo rows y - 1, y, y + 1: for tap (dy, dx) and k16 slice k the
// A operand is halo row y + dy from column 1 + dx on, a plain-layout
// descriptor shifted by 16 (1 + dx) bytes, so x is staged once for all nine
// taps. Row y + 3 is copied (cp.async, zeros outside the image) while row y
// is computed; row y + 1 is multiplied by s and rounded to bf16 in place
// just before. VEC: cin % 8 == 0 and 16-byte aligned x (the copies);
// otherwise each halo row is read channel by channel when it is prepared.
// KCH (= p.kch) is a template parameter so that the nine taps' products
// unroll into one straight run of wgmma on fixed accumulators. RAW (the
// tensor-parallel partial): no epilogue; the raw f32 sums go to p.out read
// as f32, and d, noise and bias are not read.
template <int N, int KCH, bool VEC, bool RAW>
__global__ void __launch_bounds__(thin_max_wgs(N) * 128, 1)
    styled_conv_bf16_thin_kernel(const ThinParams p) {
  constexpr int NJ = N / 8;  // accumulator column groups per thread
  constexpr int kch = KCH;
  extern __shared__ __align__(128) unsigned char smem_t[];
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int wgs = blockDim.x / 128;
  constexpr int kpad = kch * 8, w_bytes = 9 * kch * N * 16;
  unsigned char* wsm = smem_t;
  unsigned char* ring = smem_t + w_bytes + wg * p.wg_bytes;
  __nv_bfloat16* s_sm = reinterpret_cast<__nv_bfloat16*>(ring + THIN_SLOTS * kch * THIN_PLANE);

  // the weight, K-major: chunk (tap, c, n) holds w[tap][8c .. 8c + 7][n]
  for (int i = tid; i < 9 * kch * N; i += blockDim.x) {
    const int n = i % N, c = (i / N) % kch, tap = i / (N * kch);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ci = 8 * c + e;
      v[e] = ci < p.cin && n < p.cout ? ldg_f32(p.w + ((long long)tap * p.cin + ci) * p.cout + n)
                                      : 0.f;
    }
    *reinterpret_cast<uint4*>(wsm + 16 * i) = make_uint4(
        pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // -> wgmma
  __syncthreads();

  // this thread's output columns n = 8j + 2t (+1): bias once, d per sample
  float bias[NJ][2], dm[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t + e;
      bias[j][e] = !RAW && n < p.cout ? __ldg(p.bias + n) : 0.f;
    }
  const float nw = !RAW && p.noise != nullptr ? __ldg(p.noise_w) : 0.f;
  const uint32_t wsm_u = smem_u32(wsm), ring_u = smem_u32(ring);
  const long long G = (long long)gridDim.x * wgs, gidx = (long long)blockIdx.x * wgs + wg;
  const long long t_end = (gidx + 1) * p.tiles / G;
  constexpr int slot_bytes = kch * THIN_PLANE;

  int b = 0, x0 = 0;
  // halo row k of the current (b, strip): copy it into its slot (VEC), or
  // nothing (the scalar form reads it in prep)
  auto fetch = [&](int k) {
    if (VEC) {
      const uint32_t slot = ring_u + ((k + THIN_SLOTS) % THIN_SLOTS) * slot_bytes;
      const bool row_in = k >= 0 && k < p.H;
      for (int i = lt; i < (THIN_BM + 2) * kch; i += 128) {
        const int px = i / kch, c = i % kch, xx = x0 - 1 + px;
        const bool in = row_in && xx >= 0 && xx < p.W && 8 * c < p.cin;
        const __nv_bfloat16* src =
            in ? p.x + ((((long long)b * p.H + k) * p.W + xx) * p.cin + 8 * c) : p.x;
        cp_async16(slot + c * THIN_PLANE + px * 16, src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // halo row k: A = bf16(x * s) in place (VEC) or from x (scalar form)
  auto prep = [&](int k) {
    unsigned char* slot = ring + ((k + THIN_SLOTS) % THIN_SLOTS) * slot_bytes;
    const bool row_in = k >= 0 && k < p.H;
    for (int i = lt; i < (THIN_BM + 2) * kch; i += 128) {
      const int px = i / kch, c = i % kch, xx = x0 - 1 + px;
      uint4* q = reinterpret_cast<uint4*>(slot + c * THIN_PLANE + px * 16);
      float v[8];
      if (VEC) {
        const uint4 xv = *q, sv = *reinterpret_cast<const uint4*>(s_sm + 8 * c);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w}, sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = unpack_bf16(xw[e]), m = unpack_bf16(sw[e]);
          v[2 * e] = a.x * m.x;
          v[2 * e + 1] = a.y * m.y;
        }
      } else {
        const bool in = row_in && xx >= 0 && xx < p.W;
        const long long o = (((long long)b * p.H + k) * p.W + xx) * p.cin;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ci = 8 * c + e;
          v[e] = in && ci < p.cin ? ldg_f32(p.x + o + ci) * __bfloat162float(s_sm[ci]) : 0.f;
        }
      }
      *q = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // -> wgmma
  };

  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  for (long long tile = gidx * p.tiles / G; tile < t_end;) {
    // one segment: rows ya .. yb - 1 of (b, strip), within this warpgroup's range
    const long long bs = tile / p.H;
    const int ya = (int)(tile - bs * p.H);
    const long long seg_end = (bs + 1) * p.H < t_end ? (bs + 1) * p.H : t_end;
    const int yb = ya + (int)(seg_end - tile);
    b = (int)(bs / p.strips);
    x0 = (int)(bs % p.strips) * THIN_BM;
    tile = seg_end;

    cp_async_wait<0>();
    wg_sync(wg);  // the last segment's copies have landed and its rows are read
    for (int c = lt; c < kpad; c += 128)
      s_sm[c] = c < p.cin ? p.s[(long long)b * p.cin + c] : __float2bfloat16(0.f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t + e;
        dm[j][e] = !RAW && n < p.cout ? ldg_f32(p.d + (long long)b * p.cout + n) : 0.f;
      }
    for (int k = ya - 1; k <= ya + 2; ++k) fetch(k);
    cp_async_wait<2>();  // rows ya - 1 and ya
    wg_sync(wg);
    prep(ya - 1);
    prep(ya);
    for (int y = ya; y < yb; ++y) {
      cp_async_wait<1>();  // row y + 1 (row y + 2 may still be in flight)
      wg_sync(wg);
      prep(y + 1);
      wg_sync(wg);  // rows y - 1 .. y + 1 are ready for the tensor cores
      // noise of this thread's two pixels, loaded while the products run
      float nz[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xx = x0 + 16 * warp + g + 8 * h;
        nz[h] = !RAW && p.noise != nullptr && xx < p.W
                    ? nw * ldg_f32(p.noise +
                                   ((long long)(p.noise_per_sample ? b : 0) * p.H + y) * p.W + xx)
                    : 0.f;
      }
#pragma unroll
      for (int e = 0; e < N / 2; ++e) fence_operand(acc[e]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const uint32_t a0 = ring_u + ((y + dy + THIN_SLOTS) % THIN_SLOTS) * slot_bytes +
                            (1 + dx) * 16;
        const uint32_t b0 = wsm_u + tap * kch * N * 16;
#pragma unroll
        for (int k = 0; k < kch / 2; ++k)
          wgmma_bf16_n(acc, plain_desc(a0 + 2 * k * THIN_PLANE, THIN_PLANE, 128),
                       plain_desc(b0 + 2 * k * N * 16, N * 16, 128), tap + k > 0);
      }
      wgmma_commit();
      fetch(y + 3);  // its slot held row y - 2, which no product reads any more
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < N / 2; ++e) fence_operand(acc[e]);

      // epilogue: pixels x0 + 16 warp + g (+8), columns 8j + 2t (+1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xx = x0 + 16 * warp + g + 8 * h;
        if (xx >= p.W) continue;
        if constexpr (RAW) {
          float* rrow = reinterpret_cast<float*>(p.out) + (((long long)b * p.H + y) * p.W + xx) * p.cout;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int n = 8 * j + 2 * t;
            const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if (VEC) {
              if (n < p.cout) *reinterpret_cast<float2*>(rrow + n) = make_float2(v0, v1);
            } else {
              if (n < p.cout) rrow[n] = v0;
              if (n + 1 < p.cout) rrow[n + 1] = v1;
            }
          }
          continue;
        }
        __nv_bfloat16* orow = p.out + (((long long)b * p.H + y) * p.W + xx) * p.cout;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float u = acc[4 * j + 2 * h + e] * dm[j][e] + nz[h] + bias[j][e];
            u = u >= 0.f ? u : u * p.slope;
            v[e] = u * p.gain;
          }
          if (VEC) {
            if (n < p.cout) *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v[0], v[1]);
          } else {
            if (n < p.cout) orow[n] = __float2bfloat16(v[0]);
            if (n + 1 < p.cout) orow[n + 1] = __float2bfloat16(v[1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Split-K: sum the f32 partial tiles in split order, then the epilogue and
// one store in x's type. One thread per output (four consecutive channels
// where VEC). Run over a given f32 buffer with one split, it is the
// tensor-parallel epilogue (l2i_styled_conv3x3_epilogue). RAW (the
// tensor-parallel partial under split K): the sum alone, stored in f32 to
// p.out read as f32.
template <typename T, bool VEC, bool RAW>
__global__ void __launch_bounds__(256) styled_conv_splitk_reduce_kernel(const ParamsT<T> p) {
  constexpr int V = VEC ? 4 : 1;
  const long long total = (long long)p.M * p.cout / V;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long e = i * V;
  const int pix = (int)(e / p.cout), n = (int)(e - (long long)pix * p.cout);
  const long long plane = (long long)p.M * p.cout;
  const int b = pix / p.HW;
  const float nz = RAW ? 0.f : noise_term(p, b, pix - b * p.HW);
  if (VEC) {
    float4 sum = *reinterpret_cast<const float4*>(p.ws + e);
    for (int z = 1; z < p.splits; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(p.ws + z * plane + e);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if constexpr (RAW) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + e) = sum;
      return;
    }
    const float4 r = make_float4(finish(p, sum.x, b, n, nz), finish(p, sum.y, b, n + 1, nz),
                                 finish(p, sum.z, b, n + 2, nz), finish(p, sum.w, b, n + 3, nz));
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(p.out + e) = r;
    else
      *reinterpret_cast<uint2*>(p.out + e) = make_uint2(pack_bf16(r.x, r.y), pack_bf16(r.z, r.w));
  } else {
    float sum = p.ws[e];
    for (int z = 1; z < p.splits; ++z) sum += p.ws[z * plane + e];
    if constexpr (RAW)
      reinterpret_cast<float*>(p.out)[e] = sum;
    else
      p.out[e] = from_f32<T>(finish(p, sum, b, n, nz));
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// The tiling and split count for a shape: 128 x 128 tiles (two
// warpgroups, one block per SM) where they give a full wave, else 64 x 128
// tiles (one warpgroup, two blocks per SM), with K split until about two
// blocks per SM are in flight (each split keeps >= 4 K steps of `bk`
// channels: BK for f32, BK_BF16 for bf16). bf16 with Cout <= 64 and Cin <=
// 64 takes the thin form instead: 64-pixel row tiles, N = 32 or 64.
struct Plan {
  int bm, splits;
  int bn = BN;
};

Plan plan(int B, int H, int W, int cin, int cout, int bk) {
  if (bk == BK_BF16 && cout <= 64 && cin <= 64) return {THIN_BM, 1, cout <= 32 ? 32 : 64};
  const long long M = (long long)B * H * W;
  const int ksteps = 9 * ((cin + bk - 1) / bk);
  const long long n_tiles = (cout + BN - 1) / BN;
  if (((M + 127) / 128) * n_tiles >= sm_count()) return {128, 1};
  const long long tiles = ((M + 63) / 64) * n_tiles, target = 2LL * sm_count();
  long long splits = (target + tiles - 1) / tiles;
  long long most = ksteps / 4 < MAX_SPLITS ? ksteps / 4 : MAX_SPLITS;
  if (most < 1) most = 1;
  if (splits > most) splits = most;
  return {64, (int)splits};
}

// Input channels of a K-major weight row: Cin rounded up to a 16-byte load.
int cin_padded(int cin, int elem) { return (cin + 16 / elem - 1) / (16 / elem) * (16 / elem); }
// Workspace bytes: the K-major weight (x's type), then the split-K f32
// partial sums, which start 16-byte aligned.
long long weight_bytes(int cin, int cout, int elem) {
  return 9LL * cout * cin_padded(cin, elem) * elem;
}
long long workspace_bytes(const Plan& pl, long long M, int cin, int cout, int elem) {
  if (pl.bn < BN) return 0;  // the thin form reads the weight itself
  return weight_bytes(cin, cout, elem) + (pl.splits > 1 ? pl.splits * M * cout * 4 : 0);
}

template <int WGS, bool VEC, bool RAW>
cudaError_t launch_tc(const Params& p, cudaStream_t st) {
  // three stages of TF32 halves of A (WGS * 64 rows) and B (128 rows), 128
  // bytes a row, and room to align the start to 1024 bytes
  constexpr int smem = stages(WGS) * 2 * (WGS * 64 + BN) * BK * (int)sizeof(float) + 1024;
  auto kernel = styled_conv_tc_kernel<WGS, VEC, RAW>;
  static bool attr = false;  // over 48 KB of dynamic shared memory needs opting in
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((p.M + WGS * 64 - 1) / (WGS * 64), (p.cout + BN - 1) / BN, p.splits);
  kernel<<<grid, WGS * 128, smem, st>>>(p);
  return cudaGetLastError();
}

template <int WGS, bool VEC, bool RAW>
cudaError_t launch_tc(const ParamsBf16& p, cudaStream_t st) {
  // the stages of A (WGS * 64 rows) and B (128 rows), 128 bytes a row
  constexpr int smem = stages(WGS) * (WGS * 64 + BN) * 128 + 1024;
  auto kernel = styled_conv_bf16_kernel<WGS, VEC, RAW>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((p.M + WGS * 64 - 1) / (WGS * 64), (p.cout + BN - 1) / BN, p.splits);
  kernel<<<grid, WGS * 128, smem, st>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* q) { return (reinterpret_cast<unsigned long long>(q) & 15) == 0; }

// The thin form: blocks of as many warpgroups as shared memory holds (at
// most thin_max_wgs(N)), as many blocks as fit on the SMs at once, each
// warpgroup an equal share of the row tiles.
template <int N, int KCH, bool VEC, bool RAW>
cudaError_t launch_thin(const ThinParams& p, cudaStream_t st) {
  constexpr int max_smem = 232448;  // 227 KB, a block's most on an H100
  auto kernel = styled_conv_bf16_thin_kernel<N, KCH, VEC, RAW>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int w_bytes = 9 * p.kch * N * 16;
  int wgs = (max_smem - w_bytes) / p.wg_bytes;
  if (wgs > thin_max_wgs(N)) wgs = thin_max_wgs(N);
  if (wgs < 1) return cudaErrorInvalidConfiguration;
  const int smem = w_bytes + wgs * p.wg_bytes;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wgs * 128, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (long long)per_sm * sm_count();
  const long long most = (p.tiles + wgs - 1) / wgs;
  if (blocks > most) blocks = most;
  kernel<<<(unsigned)blocks, wgs * 128, smem, st>>>(p);
  return cudaGetLastError();
}

template <int N, bool RAW>
cudaError_t launch_thin_k(const ThinParams& p, bool vec, cudaStream_t st) {
  switch (p.kch) {
    case 2: return vec ? launch_thin<N, 2, true, RAW>(p, st) : launch_thin<N, 2, false, RAW>(p, st);
    case 4: return vec ? launch_thin<N, 4, true, RAW>(p, st) : launch_thin<N, 4, false, RAW>(p, st);
    case 6: return vec ? launch_thin<N, 6, true, RAW>(p, st) : launch_thin<N, 6, false, RAW>(p, st);
    case 8: return vec ? launch_thin<N, 8, true, RAW>(p, st) : launch_thin<N, 8, false, RAW>(p, st);
  }
  return cudaErrorInvalidValue;
}

// raw: the tensor-parallel partial (out f32, no epilogue)
int run_thin(const void* x, const void* w, const void* s, const void* d, const void* noise,
             const void* noise_w, const void* bias, void* out, int B, int H, int W, int cin,
             int cout, int noise_per_sample, float slope, float gain, bool raw, cudaStream_t st) {
  ThinParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.s = static_cast<const __nv_bfloat16*>(s);
  p.d = static_cast<const __nv_bfloat16*>(d);
  p.noise = static_cast<const __nv_bfloat16*>(noise);
  p.noise_w = static_cast<const float*>(noise_w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  p.noise_per_sample = noise_per_sample;
  p.kch = (cin + 15) / 16 * 2;
  p.strips = (W + THIN_BM - 1) / THIN_BM;
  p.wg_bytes = THIN_SLOTS * p.kch * THIN_PLANE + p.kch * 16;
  p.tiles = (long long)B * p.strips * H;
  p.slope = slope;
  p.gain = gain;
  const bool vec = cin % 8 == 0 && cout % 8 == 0 && aligned16(x) && aligned16(out);
  if (raw)
    return (int)(cout <= 32 ? launch_thin_k<32, true>(p, vec, st)
                            : launch_thin_k<64, true>(p, vec, st));
  return (int)(cout <= 32 ? launch_thin_k<32, false>(p, vec, st)
                          : launch_thin_k<64, false>(p, vec, st));
}

// One call in T: the weight transpose, the product, and with split K the
// reduction. raw (the tensor-parallel partial): out is f32 and takes the
// sums without the epilogue; d, noise, noise_w and bias are not read.
template <typename T>
int run(const void* x, const void* w, const void* s, const void* d, const void* noise,
        const void* noise_w, const void* bias, void* out, void* ws, int B, int H, int W,
        int cin, int cout, int noise_per_sample, float slope, float gain, bool raw,
        cudaStream_t st) {
  constexpr int elem = (int)sizeof(T), bk = elem == 4 ? BK : BK_BF16;
  const Plan pl = plan(B, H, W, cin, cout, bk);
  if (pl.bn < BN)
    return run_thin(x, w, s, d, noise, noise_w, bias, out, B, H, W, cin, cout, noise_per_sample,
                    slope, gain, raw, st);
  if (ws == nullptr || !aligned16(ws)) return (int)cudaErrorInvalidValue;
  ParamsT<T> p;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.s = static_cast<const T*>(s);
  p.d = static_cast<const T*>(d);
  p.noise = static_cast<const T*>(noise);
  p.noise_w = static_cast<const float*>(noise_w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<T*>(out);
  p.wt = static_cast<T*>(ws);
  p.ws = pl.splits > 1
             ? reinterpret_cast<float*>(static_cast<char*>(ws) + weight_bytes(cin, cout, elem))
             : nullptr;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cinp = cin_padded(cin, elem);
  p.cout = cout;
  p.noise_per_sample = noise_per_sample;
  p.M = B * H * W;
  p.HW = H * W;
  p.kchunks = (cin + bk - 1) / bk;
  p.ksteps = 9 * p.kchunks;
  p.splits = pl.splits;
  p.slope = slope;
  p.gain = gain;
  const dim3 split_grid((cout + 31) / 32, (p.cinp + 31) / 32, 9);
  styled_conv_weight_kmajor_kernel<T><<<split_grid, dim3(32, 8), 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool vec = cin % (16 / elem) == 0 && cout % (16 / elem) == 0 && aligned16(x) &&
                   aligned16(s) && aligned16(out);
  if (raw)
    e = pl.bm == 128 ? (vec ? launch_tc<2, true, true>(p, st) : launch_tc<2, false, true>(p, st))
                     : (vec ? launch_tc<1, true, true>(p, st) : launch_tc<1, false, true>(p, st));
  else if (pl.bm == 128)
    e = vec ? launch_tc<2, true, false>(p, st) : launch_tc<2, false, false>(p, st);
  else
    e = vec ? launch_tc<1, true, false>(p, st) : launch_tc<1, false, false>(p, st);
  if (e != cudaSuccess || pl.splits == 1) return (int)e;
  const long long n = (long long)p.M * cout / (vec ? 4 : 1);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (raw && vec)
    styled_conv_splitk_reduce_kernel<T, true, true><<<blocks, 256, 0, st>>>(p);
  else if (raw)
    styled_conv_splitk_reduce_kernel<T, false, true><<<blocks, 256, 0, st>>>(p);
  else if (vec)
    styled_conv_splitk_reduce_kernel<T, true, false><<<blocks, 256, 0, st>>>(p);
  else
    styled_conv_splitk_reduce_kernel<T, false, false><<<blocks, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The tensor-parallel epilogue in T: the reduce launch over `acc` with one
// split.
template <typename T>
int run_epilogue(const float* acc, const void* d, const void* noise, const void* noise_w,
                 const void* bias, void* out, int B, int H, int W, int cout,
                 int noise_per_sample, float slope, float gain, cudaStream_t st) {
  ParamsT<T> p = {};
  p.d = static_cast<const T*>(d);
  p.noise = static_cast<const T*>(noise);
  p.noise_w = static_cast<const float*>(noise_w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<T*>(out);
  p.ws = const_cast<float*>(acc);
  p.cout = cout;
  p.noise_per_sample = noise_per_sample;
  p.M = B * H * W;
  p.HW = H * W;
  p.splits = 1;
  p.slope = slope;
  p.gain = gain;
  const bool vec = cout % 4 == 0 && aligned16(acc) && aligned16(out);
  const long long n = (long long)p.M * cout / (vec ? 4 : 1);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (vec)
    styled_conv_splitk_reduce_kernel<T, true, false><<<blocks, 256, 0, st>>>(p);
  else
    styled_conv_splitk_reduce_kernel<T, false, false><<<blocks, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Tiling of a call: writes {BM, BN, splits} to `out3` and returns the bytes
// of workspace the caller must pass to l2i_styled_conv3x3.
extern "C" long long l2i_styled_conv3x3_plan(int B, int H, int W, int cin, int cout,
                                             int is_bf16, int* out3) {
  const int elem = is_bf16 ? 2 : 4;
  const Plan pl = plan(B, H, W, cin, cout, is_bf16 ? BK_BF16 : BK);
  out3[0] = pl.bm;
  out3[1] = pl.bn;
  out3[2] = pl.splits;
  return workspace_bytes(pl, (long long)B * H * W, cin, cout, elem);
}

// See the header comment for the operands; contiguous, x, w, s, d and noise
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), noise_w and bias f32;
// `noise` may be null; `ws` (16-byte aligned) holds the bytes
// l2i_styled_conv3x3_plan asks for. Launches on `stream`: the weight
// transpose, the product, and with split K the reduction. Returns
// cudaGetLastError().
extern "C" int l2i_styled_conv3x3(const void* x, const void* w, const void* s, const void* d,
                                  const void* noise, const void* noise_w, const void* bias,
                                  void* out, void* ws, int B, int H, int W, int cin, int cout,
                                  int noise_per_sample, int is_bf16, float slope, float gain,
                                  void* stream) {
  if ((long long)B * H * W * cout <= 0) return 0;
  if ((long long)B * H * W >= (1LL << 31) - 256 || cin <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(x, w, s, d, noise, noise_w, bias, out, ws, B, H, W, cin,
                                      cout, noise_per_sample, slope, gain, false, st)
                 : run<float>(x, w, s, d, noise, noise_w, bias, out, ws, B, H, W, cin, cout,
                              noise_per_sample, slope, gain, false, st);
}

// The tensor-parallel split of l2i_styled_conv3x3 (a rank holding a slice of
// Cin): the product conv3x3_same(x * s, w) over that slice, without d, noise,
// bias or activation, as f32 sums in `acc` [B, H, W, Cout] whatever x's type
// (x, w and s f32 or all bf16, as l2i_styled_conv3x3 takes them, the same
// tilings and the workspace l2i_styled_conv3x3_plan asks for). The caller
// sums `acc` over the ranks and finishes with l2i_styled_conv3x3_epilogue.
extern "C" int l2i_styled_conv3x3_partial(const void* x, const void* w, const void* s,
                                          float* acc, void* ws, int B, int H, int W, int cin,
                                          int cout, int is_bf16, void* stream) {
  if ((long long)B * H * W * cout <= 0) return 0;
  if ((long long)B * H * W >= (1LL << 31) - 256 || cin <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(x, w, s, nullptr, nullptr, nullptr, nullptr, acc, ws, B, H,
                                      W, cin, cout, 0, 0.f, 1.f, true, st)
                 : run<float>(x, w, s, nullptr, nullptr, nullptr, nullptr, acc, ws, B, H, W, cin,
                              cout, 0, 0.f, 1.f, true, st);
}

// The epilogue of the split: out = lrelu(acc * d + noise_w * noise + bias,
// slope) * gain from the f32 sums `acc` [B, H, W, Cout] over every rank's
// slice; d and noise (may be null) in out's type (f32 or bf16), noise_w and
// bias f32; one store in out's type. One launch.
extern "C" int l2i_styled_conv3x3_epilogue(const float* acc, const void* d, const void* noise,
                                           const void* noise_w, const void* bias, void* out,
                                           int B, int H, int W, int cout, int noise_per_sample,
                                           int is_bf16, float slope, float gain, void* stream) {
  if ((long long)B * H * W * cout <= 0) return 0;
  if ((long long)B * H * W >= (1LL << 31) - 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run_epilogue<__nv_bfloat16>(acc, d, noise, noise_w, bias, out, B, H, W, cout,
                                               noise_per_sample, slope, gain, st)
                 : run_epilogue<float>(acc, d, noise, noise_w, bias, out, B, H, W, cout,
                                       noise_per_sample, slope, gain, st);
}
