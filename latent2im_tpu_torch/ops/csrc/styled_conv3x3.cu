// Fused StyleGAN2 styled 3x3 convolution, forward:
//
//     out = lrelu(conv3x3_same(x * s, w) * d + noise_w * noise + bias, slope) * gain
//
// x [B, H, W, Cin] NHWC f32; w [3, 3, Cin, Cout] already scaled by
// 1/sqrt(9 Cin); s [B, Cin] the style modulation; d [B, Cout] the
// demodulation; noise [NB, H, W] with NB = 1 (shared) or B, or null;
// noise_w [1] and bias [Cout].
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;            // K per stage: one tap x 32 input channels
constexpr int BN = 128;           // output channels per block: one wgmma n128
constexpr int MAX_SPLITS = 32;

struct Params {
  const float* x;
  const float* w;
  const float* s;
  const float* d;
  const float* noise;
  const float* noise_w;
  const float* bias;
  float* out;
  float* wt;  // the weight transposed to [9][Cout][cinp] (K-major)
  float* ws;  // split-K partial sums [splits][M][Cout], or null
  int H, W, cin, cinp, cout, noise_per_sample;
  int M, HW, kchunks, ksteps, splits;
  float slope, gain;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// wgmma shared-memory descriptor of a K-major TF32 tile in the 128-byte
// swizzle layout: rows of 32 values (128 bytes), the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8), 8-row groups 1024 bytes apart; the tile starts
// on a 1024-byte boundary, and k8 step k starts 32 * k bytes in.
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

// The epilogue for one output: demodulate, noise, bias, LeakyReLU * gain.
__device__ __forceinline__ float finish(const Params& p, float acc, int b, int n, float nz) {
  float v = acc * __ldg(p.d + (long long)b * p.cout + n) + nz + __ldg(p.bias + n);
  v = v >= 0.f ? v : v * p.slope;
  return v * p.gain;
}

__device__ __forceinline__ float noise_term(const Params& p, int b, int q) {
  if (p.noise == nullptr) return 0.f;
  return __ldg(p.noise_w) * __ldg(p.noise + (p.noise_per_sample ? (long long)b * p.HW : 0) + q);
}

// w [9][Cin][Cout] -> [9][Cout][cinp], K-major for wgmma, through a 32 x 32
// shared tile; channels cin..cinp-1 are zero.
__global__ void __launch_bounds__(256) styled_conv_weight_kmajor_kernel(const Params p) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z, ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + threadIdx.x;
    tile[r][threadIdx.x] =
        ci < p.cin && co < p.cout ? p.w[((long long)tap * p.cin + ci) * p.cout + co] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + threadIdx.x;
    if (co < p.cout && ci < p.cinp)
      p.wt[((long long)tap * p.cout + co) * p.cinp + ci] = tile[threadIdx.x][r];
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
// barrier per step.
template <int WGS, bool VEC>
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
    const float nz = p.splits == 1 ? noise_term(p, b, pix - b * p.HW) : 0.f;
    float* orow = p.splits == 1 ? p.out + (long long)pix * p.cout
                                : p.ws + ((long long)split * p.M + pix) * p.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (p.splits == 1) {
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

// Split-K: sum the partial tiles in split order, then the epilogue. One
// thread per output (four consecutive channels where VEC).
template <bool VEC>
__global__ void __launch_bounds__(256) styled_conv_splitk_reduce_kernel(const Params p) {
  constexpr int V = VEC ? 4 : 1;
  const long long total = (long long)p.M * p.cout / V;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long e = i * V;
  const int pix = (int)(e / p.cout), n = (int)(e - (long long)pix * p.cout);
  const long long plane = (long long)p.M * p.cout;
  const int b = pix / p.HW;
  const float nz = noise_term(p, b, pix - b * p.HW);
  if (VEC) {
    float4 sum = *reinterpret_cast<const float4*>(p.ws + e);
    for (int z = 1; z < p.splits; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(p.ws + z * plane + e);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(p.out + e) =
        make_float4(finish(p, sum.x, b, n, nz), finish(p, sum.y, b, n + 1, nz),
                    finish(p, sum.z, b, n + 2, nz), finish(p, sum.w, b, n + 3, nz));
  } else {
    float sum = p.ws[e];
    for (int z = 1; z < p.splits; ++z) sum += p.ws[z * plane + e];
    p.out[e] = finish(p, sum, b, n, nz);
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
// blocks per SM are in flight (each split keeps >= 4 K steps).
struct Plan {
  int bm, splits;
};

Plan plan(int B, int H, int W, int cin, int cout) {
  const long long M = (long long)B * H * W;
  const int ksteps = 9 * ((cin + BK - 1) / BK);
  const long long n_tiles = (cout + BN - 1) / BN;
  if (((M + 127) / 128) * n_tiles >= sm_count()) return {128, 1};
  const long long tiles = ((M + 63) / 64) * n_tiles, target = 2LL * sm_count();
  long long splits = (target + tiles - 1) / tiles;
  long long most = ksteps / 4 < MAX_SPLITS ? ksteps / 4 : MAX_SPLITS;
  if (most < 1) most = 1;
  if (splits > most) splits = most;
  return {64, (int)splits};
}

// Workspace floats: the K-major weight, then the split-K partial sums.
long long weight_floats(int cin, int cout) { return 9LL * cout * ((cin + 3) / 4 * 4); }
long long workspace_floats(const Plan& pl, long long M, int cin, int cout) {
  return weight_floats(cin, cout) + (pl.splits > 1 ? pl.splits * M * cout : 0);
}

template <int WGS, bool VEC>
cudaError_t launch_tc(const Params& p, cudaStream_t st) {
  // three stages of TF32 halves of A (WGS * 64 rows) and B (128 rows), 128
  // bytes a row, and room to align the start to 1024 bytes
  constexpr int smem = stages(WGS) * 2 * (WGS * 64 + BN) * BK * (int)sizeof(float) + 1024;
  auto kernel = styled_conv_tc_kernel<WGS, VEC>;
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

bool aligned16(const void* q) { return (reinterpret_cast<unsigned long long>(q) & 15) == 0; }

}  // namespace

// Tiling of a call: writes {BM, BN, splits} to `out3` and returns the floats
// of workspace the caller must pass to l2i_styled_conv3x3.
extern "C" long long l2i_styled_conv3x3_plan(int B, int H, int W, int cin, int cout,
                                             int* out3) {
  const Plan pl = plan(B, H, W, cin, cout);
  out3[0] = pl.bm;
  out3[1] = BN;
  out3[2] = pl.splits;
  return workspace_floats(pl, (long long)B * H * W, cin, cout);
}

// See the header comment for the operands; all f32 and contiguous, `noise`
// may be null; `ws` (16-byte aligned) holds the floats
// l2i_styled_conv3x3_plan asks for. Launches on `stream`: the weight split,
// the product, and with split K the reduction. Returns cudaGetLastError().
extern "C" int l2i_styled_conv3x3(const void* x, const void* w, const void* s, const void* d,
                                  const void* noise, const void* noise_w, const void* bias,
                                  void* out, void* ws, int B, int H, int W, int cin, int cout,
                                  int noise_per_sample, float slope, float gain, void* stream) {
  if ((long long)B * H * W * cout <= 0) return 0;
  if ((long long)B * H * W >= (1LL << 31) - 256 || cin <= 0 || ws == nullptr || !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(B, H, W, cin, cout);
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.s = static_cast<const float*>(s);
  p.d = static_cast<const float*>(d);
  p.noise = static_cast<const float*>(noise);
  p.noise_w = static_cast<const float*>(noise_w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.wt = static_cast<float*>(ws);
  p.ws = pl.splits > 1 ? p.wt + weight_floats(cin, cout) : nullptr;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cinp = (cin + 3) / 4 * 4;
  p.cout = cout;
  p.noise_per_sample = noise_per_sample;
  p.M = B * H * W;
  p.HW = H * W;
  p.kchunks = (cin + BK - 1) / BK;
  p.ksteps = 9 * p.kchunks;
  p.splits = pl.splits;
  p.slope = slope;
  p.gain = gain;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 split_grid((cout + 31) / 32, (p.cinp + 31) / 32, 9);
  styled_conv_weight_kmajor_kernel<<<split_grid, dim3(32, 8), 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool vec = cin % 4 == 0 && cout % 4 == 0 && aligned16(x) && aligned16(s) &&
                   aligned16(out);
  if (pl.bm == 128)
    e = vec ? launch_tc<2, true>(p, st) : launch_tc<2, false>(p, st);
  else
    e = vec ? launch_tc<1, true>(p, st) : launch_tc<1, false>(p, st);
  if (e != cudaSuccess || pl.splits == 1) return (int)e;
  const long long n = (long long)p.M * cout / (vec ? 4 : 1);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (vec)
    styled_conv_splitk_reduce_kernel<true><<<blocks, 256, 0, st>>>(p);
  else
    styled_conv_splitk_reduce_kernel<false><<<blocks, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}
