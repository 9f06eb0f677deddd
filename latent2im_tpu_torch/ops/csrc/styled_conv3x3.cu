// Fused StyleGAN2 styled 3x3 convolution, forward:
//
//     out = lrelu(conv3x3_same(x * s, w) * d + noise_w * noise + bias, slope) * gain
//
// x [B, H, W, Cin] NHWC f32; w [3, 3, Cin, Cout] already scaled by
// 1/sqrt(9 Cin); s [B, Cin] the style modulation; d [B, Cout] the
// demodulation; noise [NB, H, W] with NB = 1 (shared) or B, or null;
// noise_w [1] and bias [Cout]. Sums accumulate in f32.
//
// Replaces the TPU kernel latent2im_tpu/ops/pair_conv.py:
// fused_styled_conv3x3_pair (with _kernel), which the JAX package routes to
// from models/stylegan2.py:styled_conv. Here it runs for every non-up styled
// conv of synthesis, with no channel or resolution gate.
//
// Bound on an H100: operations. 2*B*H*W*9*Cin*Cout flops against a few bytes
// per output (at 256 px, 64x64x512 -> 512 does ~600 flops per byte moved), so
// the limit is the arithmetic rate: 67 TFLOP/s of f32 on the CUDA cores, the
// rate this kernel can reach at all since it keeps full f32 (TF32 tensor
// cores would be 495 TFLOP/s at 10 mantissa bits).
//
// Design: an implicit GEMM per sample, M = H*W pixels, N = Cout, K = 9*Cin,
// with no im2col tensor and no per-sample B x 9 x Cin x Cout weight tensor.
// The TPU kernel folds s and d into per-sample weight blocks; here the same
// identity conv(x*s, w)*d is applied where it is free: s[b, ci] scales the
// input as it is staged into shared memory, d[b, co] scales the accumulator
// in the epilogue, so all samples share one weight tensor. A block walks K
// in steps of one tap x BK input channels through shared memory, each
// thread keeping a tile of f32 accumulators in registers. Halo pixels
// outside the image stage as zeros, which gives the same-padding. The
// epilogue adds the noise and the bias, applies LeakyReLU * gain and stores
// NHWC, channel fastest.
//
// Two tilings, chosen per call from the grid size it would give:
//  - large: 128 pixels x 128 channels per 256-thread block, 8x8 accumulators
//    per thread (four 16-byte shared loads feed 64 multiply-adds), and the
//    next K step fetched from device memory into registers while the
//    current one is computed. Where Cin and Cout are multiples of 4 (every
//    StyleGAN2 layer) loads and stores are 16 bytes wide.
//  - small: 64 x 64 per block, 4x4 accumulators per thread. Low-resolution
//    layers (4x4 .. 32x32 at batch 4) give too few 128 x 128 tiles to fill
//    the card's 132 SMs, and four times as many smaller tiles finish sooner.
// Split-K for the smallest layers and wgmma/TMA pipelining are later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// small tiles: 64 pixels x 64 channels, 4x4 per thread, BK = 16
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
small_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ s, const float* __restrict__ d,
                  const float* __restrict__ noise, const float* __restrict__ noise_w,
                  const float* __restrict__ bias, float* __restrict__ out, int H, int W, int cin,
                  int cout, int noise_per_sample, float slope, float gain) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels n0 + tx + 16 j
  const int ty = tid / 16;  // pixels m0 + ty + 16 i
  const int hw = H * W;
  const float* xb = x + (long long)b * hw * cin;
  const float* sb = s + (long long)b * cin;

  // Staging map. A tile (BK x BM): thread stages channel a_k of pixels
  // a_m0 + 16 r, r < 4 (16 neighbouring threads read 16 neighbouring channels
  // of one pixel). B tile (BK x BN): channel b_n of input rows b_k0 + 4 r.
  const int a_k = tid % BK;
  const int a_m0 = tid / BK;
  const int b_n = tid % BN;
  const int b_k0 = tid / BN;
  int py[4], px[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = m0 + a_m0 + 16 * r;
    py[r] = p < hw ? p / W : -(1 << 20);  // an out-of-range pixel never lands in the image
    px[r] = p < hw ? p % W : 0;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    long long src[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int yy = py[r] + dy, xx = px[r] + dx;
      src[r] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? ((long long)yy * W + xx) * cin : -1;
    }
    const float* wt = w + (long long)tap * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      const int ca = c0 + a_k;
      const float sv = ca < cin ? sb[ca] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        As[a_k][a_m0 + 16 * r] = (src[r] >= 0 && ca < cin) ? xb[src[r] + ca] * sv : 0.f;
      const int n = n0 + b_n;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int cb = c0 + b_k0 + 4 * r;
        Bs[b_k0 + 4 * r][b_n] = (cb < cin && n < cout) ? wt[(long long)cb * cout + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
  }

  const float nw = noise != nullptr ? noise_w[0] : 0.f;
  const float* nb = noise != nullptr ? noise + (noise_per_sample ? (long long)b * hw : 0) : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + ty + 16 * i;
    if (p >= hw) continue;
    const float nz = nb != nullptr ? nw * nb[p] : 0.f;
    float* orow = out + ((long long)b * hw + p) * cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= cout) continue;
      float v = acc[i][j] * d[(long long)b * cout + n] + nz + bias[n];
      v = v >= 0.f ? v : v * slope;
      orow[n] = v * gain;
    }
  }
}

// ---------------------------------------------------------------------------
// large tiles: 128 pixels x 128 channels, 8x8 per thread, BK = 8, the next K
// step prefetched into registers
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
large_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ s, const float* __restrict__ d,
                  const float* __restrict__ noise, const float* __restrict__ noise_w,
                  const float* __restrict__ bias, float* __restrict__ out, int H, int W, int cin,
                  int cout, int noise_per_sample, float slope, float gain) {
  constexpr int BM = 128, BN = 128, BK = 8;
  // +4: the two staging rows a warp writes land in different banks; rows stay
  // 16-byte aligned (132 floats)
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels n0 + tx*4 + {0..3} and n0 + 64 + tx*4 + {0..3}
  const int ty = tid / 16;  // pixels   m0 + ty*4 + {0..3} and m0 + 64 + ty*4 + {0..3}
  const int hw = H * W;
  const float* xb = x + (long long)b * hw * cin;
  const float* sb = s + (long long)b * cin;

  // Staging map. VEC: this thread stages input channels a_k..a_k+3 of pixel
  // a_m, and weights b_n..b_n+3 of row b_k. Scalar: channel a_k of pixels
  // a_m + 32 r, and weight b_n of rows b_k + 2 r, r < 4.
  const int a_k = VEC ? (tid % 2) * 4 : tid % BK;
  const int a_m = VEC ? tid / 2 : tid / BK;
  const int b_k = VEC ? tid / 32 : tid / BN;
  const int b_n = VEC ? (tid % 32) * 4 : tid % BN;
  int py[4], px[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = m0 + a_m + 32 * r;
    py[r] = p < hw ? p / W : -(1 << 20);
    px[r] = p < hw ? p % W : 0;
  }

  const int kchunks = (cin + BK - 1) / BK;
  const int nsteps = 9 * kchunks;
  float ra[4], rb[4];

  auto load = [&](int step) {
    const int tap = step / kchunks;
    const int c0 = (step - tap * kchunks) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const float* wt = w + (long long)tap * cin * cout;
    if (VEC) {
      const int yy = py[0] + dy, xx = px[0] + dx, ci = c0 + a_k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && ci < cin) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xb + ((long long)yy * W + xx) * cin + ci);
        const float4 sv = *reinterpret_cast<const float4*>(sb + ci);
        v = make_float4(xv.x * sv.x, xv.y * sv.y, xv.z * sv.z, xv.w * sv.w);
      }
      ra[0] = v.x;
      ra[1] = v.y;
      ra[2] = v.z;
      ra[3] = v.w;
      const int cb = c0 + b_k, n = n0 + b_n;
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cb < cin && n < cout)
        wv = *reinterpret_cast<const float4*>(wt + (long long)cb * cout + n);
      rb[0] = wv.x;
      rb[1] = wv.y;
      rb[2] = wv.z;
      rb[3] = wv.w;
    } else {
      const int ci = c0 + a_k;
      const float sv = ci < cin ? sb[ci] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int yy = py[r] + dy, xx = px[r] + dx;
        ra[r] = (yy >= 0 && yy < H && xx >= 0 && xx < W && ci < cin)
                    ? xb[((long long)yy * W + xx) * cin + ci] * sv
                    : 0.f;
      }
      const int n = n0 + b_n;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int cb = c0 + b_k + 2 * r;
        rb[r] = (cb < cin && n < cout) ? wt[(long long)cb * cout + n] : 0.f;
      }
    }
  };
  auto store = [&]() {
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 4; ++j) As[a_k + j][a_m] = ra[j];
      *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        As[a_k][a_m + 32 * r] = ra[r];
        Bs[b_k + 2 * r][b_n] = rb[r];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int step = 0; step < nsteps; ++step) {
    const bool more = step + 1 < nsteps;
    if (more) load(step + 1);  // device-memory loads in flight during the math
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  const float nw = noise != nullptr ? noise_w[0] : 0.f;
  const float* nb = noise != nullptr ? noise + (noise_per_sample ? (long long)b * hw : 0) : nullptr;
  const float* db = d + (long long)b * cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (p >= hw) continue;
    const float nz = nb != nullptr ? nw * nb[p] : 0.f;
    float* orow = out + ((long long)b * hw + p) * cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nbase = n0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nbase + j;
        float t = n < cout ? acc[i][h * 4 + j] * db[n] + nz + bias[n] : 0.f;
        t = t >= 0.f ? t : t * slope;
        v[j] = t * gain;
      }
      if (VEC) {
        if (nbase < cout)
          *reinterpret_cast<float4*>(orow + nbase) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nbase + j < cout) orow[nbase + j] = v[j];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

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

}  // namespace

// See the header comment for the operands; all f32 and contiguous, `noise`
// may be null. Launches on `stream`; returns cudaGetLastError().
extern "C" int l2i_styled_conv3x3(const void* x, const void* w, const void* s, const void* d,
                                  const void* noise, const void* noise_w, const void* bias,
                                  void* out, int B, int H, int W, int cin, int cout,
                                  int noise_per_sample, float slope, float gain, void* stream) {
  if ((long long)B * H * W * cout <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *wf = static_cast<const float*>(w),
              *sf = static_cast<const float*>(s), *df = static_cast<const float*>(d),
              *nf = static_cast<const float*>(noise), *nwf = static_cast<const float*>(noise_w),
              *bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const long long large_blocks =
      (long long)((H * W + 127) / 128) * ((cout + 127) / 128) * B;
  if (large_blocks < 2LL * sm_count()) {  // under one wave of large tiles
    const dim3 grid((H * W + 63) / 64, (cout + 63) / 64, B);
    small_tile_kernel<<<grid, THREADS, 0, st>>>(xf, wf, sf, df, nf, nwf, bf, of, H, W, cin,
                                                cout, noise_per_sample, slope, gain);
    return (int)cudaGetLastError();
  }
  const dim3 grid((H * W + 127) / 128, (cout + 127) / 128, B);
  const bool vec = cin % 4 == 0 && cout % 4 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(s) && aligned16(out);
  if (vec) {
    large_tile_kernel<true><<<grid, THREADS, 0, st>>>(xf, wf, sf, df, nf, nwf, bf, of, H, W,
                                                      cin, cout, noise_per_sample, slope, gain);
  } else {
    large_tile_kernel<false><<<grid, THREADS, 0, st>>>(xf, wf, sf, df, nf, nwf, bf, of, H, W,
                                                       cin, cout, noise_per_sample, slope, gain);
  }
  return (int)cudaGetLastError();
}
