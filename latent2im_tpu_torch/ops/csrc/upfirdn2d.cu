// upfirdn2d: upsample by zero-stuffing, pad or crop, FIR-filter, downsample,
// over NHWC f32 images:
//
//     out[b, oy, ox, c] = sum_{ty, tx} k[kh-1-ty][kw-1-tx] * P[b, oy*down+ty, ox*down+tx, c]
//
// where P is x zero-stuffed by `up` (each sample followed by up-1 zeros, so the
// stuffed length is H*up) and then padded by (py0, py1) rows and (px0, px1)
// columns, a negative pad cropping. Correlating with the flipped kernel is
// convolving with the kernel; `k` arrives unflipped and is flipped here, once,
// as it is staged into shared memory.
//
// Replaces the TPU kernel latent2im_tpu/ops/pallas_kernels.py:upfirdn2d_pallas
// (_ufd_fwd -> _ufd_impl: _zero_stuff_pad, then _fir_down with _fir_kernel).
//
// Bound on an H100: bytes (each input element read once, each output written
// once); at most kh*kw <= 64 multiply-adds per output, of which only 1/up^2
// are non-zero taps. The TPU version materialises the zero-stuffed, padded
// tensor and a polyphase copy of it before its kernel runs; here nothing is
// materialised. Along each axis, output o reads the stuffed coordinate
// j = o*down + t - p0 for tap t, which holds a sample only where j % up == 0:
// the kernel computes the first such tap and its input index once per output
// and then steps by `up` taps and one input sample, clipped to the image, so
// zeros are never visited and the tap loop has no divisions. One thread per
// output element with the channel fastest keeps every warp's loads and stores
// coalesced and leaves no channel gate: C = 3 works as C = 512 does. Index
// arithmetic is 32-bit whenever the tensors allow it.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 64;

// Taps along one axis for output coordinate o: the first tap t0 that lands on
// an input sample, its input index j0, and how many taps (t0, t0+up, ...)
// land on samples inside [0, n).
__device__ __forceinline__ void tap_range(int o, int down, int up, int p0, int k, int n,
                                          int& t0, int& j0, int& cnt) {
  const int base = o * down - p0;  // stuffed coordinate under tap 0
  int r = base % up;
  if (r < 0) r += up;
  t0 = r == 0 ? 0 : up - r;
  j0 = (base + t0) / up;  // exact: base + t0 is a multiple of up
  if (j0 < 0) {
    t0 -= j0 * up;
    j0 = 0;
  }
  cnt = t0 < k ? (k - 1 - t0) / up + 1 : 0;
  if (cnt > n - j0) cnt = n - j0;
  if (cnt < 0) cnt = 0;
}

template <typename I>
__global__ void upfirdn2d_kernel(const float* __restrict__ x, const float* __restrict__ k,
                                 float* __restrict__ out, int B, int H, int W, int C, int OH,
                                 int OW, int kh, int kw, int up, int down, int px0, int py0) {
  __shared__ float kf[MAX_TAPS];  // flipped taps: kf[ty][tx] = k[kh-1-ty][kw-1-tx]
  for (int t = threadIdx.x; t < kh * kw; t += blockDim.x)
    kf[t] = k[(kh - 1 - t / kw) * kw + (kw - 1 - t % kw)];
  __syncthreads();

  const I n = (I)B * OH * OW * C;
  const I stride = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = (int)(i % C);
    I r = i / C;
    const int ox = (int)(r % OW);
    r /= OW;
    const int oy = (int)(r % OH);
    const int b = (int)(r / OH);
    int ty0, iy0, cy, tx0, ix0, cx;
    tap_range(oy, down, up, py0, kh, H, ty0, iy0, cy);
    tap_range(ox, down, up, px0, kw, W, tx0, ix0, cx);
    float acc = 0.f;
    for (int a = 0; a < cy; ++a) {
      const float* xrow = x + (((I)b * H + iy0 + a) * W + ix0) * C + c;
      const float* krow = kf + (ty0 + a * up) * kw + tx0;
      for (int e = 0; e < cx; ++e) acc += krow[e * up] * xrow[(I)e * C];
    }
    out[i] = acc;
  }
}

}  // namespace

// x: [B, H, W, C] f32 contiguous; k: [kh, kw] f32 taps (unflipped), kh*kw <= 64;
// out: [B, OH, OW, C] with OH = (H*up + py0 + py1 - kh) / down + 1 (likewise OW).
// The high pads only set OH and OW, which the caller passes.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int l2i_upfirdn2d(const void* x, const void* k, void* out, int B, int H, int W,
                             int C, int OH, int OW, int kh, int kw, int up, int down, int px0,
                             int py0, void* stream) {
  const long long n = (long long)B * OH * OW * C;
  if (n <= 0) return 0;
  if (kh * kw > MAX_TAPS || up < 1 || down < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132LL * 32;
  if (blocks > max_blocks) blocks = max_blocks;
  const long long in_n = (long long)B * H * W * C;
  const bool small = n < (1LL << 31) - threads * max_blocks && in_n < (1LL << 31);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* kf = static_cast<const float*>(k);
  float* of = static_cast<float*>(out);
  if (small) {
    upfirdn2d_kernel<int><<<(unsigned)blocks, threads, 0, s>>>(xf, kf, of, B, H, W, C, OH, OW,
                                                               kh, kw, up, down, px0, py0);
  } else {
    upfirdn2d_kernel<long long><<<(unsigned)blocks, threads, 0, s>>>(
        xf, kf, of, B, H, W, C, OH, OW, kh, kw, up, down, px0, py0);
  }
  return (int)cudaGetLastError();
}
