// Fused bias + LeakyReLU + gain, the StyleGAN2 activation, and its gradient:
//
//     y  = leaky_relu(x + bias, slope) * scale        (slope 0.2, scale sqrt(2))
//     dx = g * scale * (y > 0 ? 1 : slope)
//
// over a contiguous [M, C] tensor (any leading dims flattened into M, channels
// last), with the bias [C] broadcast over rows or absent. The gradient is
// keyed on the sign of the saved OUTPUT, not the input: the activation is
// monotone and y > 0 exactly where x + bias > 0, so the backward needs only y.
//
// Replaces the TPU kernel latent2im_tpu/ops/pallas_kernels.py:
// fused_leaky_relu_pallas, forward (_flrelu_fwd -> _flrelu_call with
// _flrelu_fwd_kernel) and backward (_flrelu_bwd -> _flrelu_call with
// _flrelu_bwd_kernel). The bias gradient db = sum of dx over rows stays
// outside the kernel, as the TPU version keeps it (a jnp.sum there, a
// torch.sum in the wrapper here).
//
// Bound on an H100: bytes. Each element is read once and written once
// (2 * M * C * element bytes) for three arithmetic operations, far below the
// ~20 f32 operations per byte at which the card's arithmetic would become the
// limit. The design therefore only has to stream: a grid-stride loop in which
// neighbouring threads touch neighbouring addresses, so every warp's load and
// store is one coalesced transaction; the bias is read by i % C and stays in
// L1/L2. Math is f32 for both f32 and bf16 I/O, as on the TPU. The backward
// is bound the same way: two reads (g, y) and one write per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void fused_act_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                                 T* __restrict__ y, long long n, int c, float slope,
                                 float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = load_f32(x, i);
    if (bias != nullptr) v += bias[i % c];
    v = v >= 0.f ? v : v * slope;
    store_f32(y, i, v * scale);
  }
}

template <typename T>
__global__ void fused_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                                     T* __restrict__ dx, long long n, float slope,
                                     float scale) {
  const float neg = scale * slope;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    store_f32(dx, i, load_f32(g, i) * (load_f32(y, i) > 0.f ? scale : neg));
  }
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132LL * 32;  // 32 blocks per SM, then grid-stride
  return (unsigned)(blocks > max_blocks ? max_blocks : blocks);
}

}  // namespace

// x, y: [n / c, c] contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// bias: f32 [c] or null. Launches on `stream`; returns cudaGetLastError().
extern "C" int l2i_fused_act(const void* x, const void* bias, void* y, long long n, int c,
                             int is_bf16, float slope, float scale, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = grid_for(n, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (is_bf16) {
    fused_act_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), b, static_cast<__nv_bfloat16*>(y), n, c, slope,
        scale);
  } else {
    fused_act_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), b, static_cast<float*>(y), n, c, slope, scale);
  }
  return (int)cudaGetLastError();
}

// g, y, dx: [n] contiguous, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1);
// y is the forward's output. Launches on `stream`; returns cudaGetLastError().
extern "C" int l2i_fused_act_bwd(const void* g, const void* y, void* dx, long long n,
                                 int is_bf16, float slope, float scale, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = grid_for(n, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fused_act_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(dx), n, slope, scale);
  } else {
    fused_act_bwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), static_cast<float*>(dx), n,
        slope, scale);
  }
  return (int)cudaGetLastError();
}
