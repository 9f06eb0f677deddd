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
// limit. The design therefore only has to stream. The forward is a vector
// stream: where C is a multiple of the vector (8 bf16 or 4 f32, 16 bytes) and
// x and y are 16-byte aligned, each thread owns one channel vector of a row,
// loads its bias vector once into registers, and walks rows with 16-byte loads
// and stores (2-D indexing: no per-element modulo), two rows in flight; the
// grid holds as many threads as the SMs keep resident. A ragged C or an
// unaligned tensor takes the scalar grid-stride loop, whose bias is read by
// i % C. Math is f32 for both f32 and bf16 I/O with one rounding, as on the
// TPU, so both forms equal the plain version bit for bit. The backward is
// bound the same way: two reads (g, y) and one write per element, a scalar
// grid-stride loop.
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

// 16 bytes of T as f32 and back
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The vector stream: thread (threadIdx.x, blockIdx.x) owns channel vector j
// of every row it visits; rows run over threadIdx.y, blockIdx.y, two at a
// time. x, y: [rows, cv * V], 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(256) fused_act_vec_kernel(const T* __restrict__ x,
                                                            const float* __restrict__ bias,
                                                            T* __restrict__ y, long long rows,
                                                            int cv, float slope, float scale) {
  constexpr int V = Vec<T>::N;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cv) return;
  float b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) b[e] = bias != nullptr ? __ldg(bias + (long long)j * V + e) : 0.f;
  const long long step = (long long)gridDim.y * blockDim.y;
  auto act = [&](float (&v)[V]) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float u = bias != nullptr ? v[e] + b[e] : v[e];  // no bias: no add (keeps -0)
      u = u >= 0.f ? u : u * slope;
      v[e] = u * scale;
    }
  };
  long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  for (; r + step < rows; r += 2 * step) {
    const long long o0 = (r * cv + j) * V, o1 = ((r + step) * cv + j) * V;
    float v0[V], v1[V];
    Vec<T>::load(x + o0, v0);
    Vec<T>::load(x + o1, v1);
    act(v0);
    act(v1);
    Vec<T>::store(y + o0, v0);
    Vec<T>::store(y + o1, v1);
  }
  if (r < rows) {
    const long long o = (r * cv + j) * V;
    float v[V];
    Vec<T>::load(x + o, v);
    act(v);
    Vec<T>::store(y + o, v);
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

// 256 threads: up to 32 channel vectors of a row across x, rows across y;
// blocks over rows until 8 per SM (2048 threads) are resident.
template <typename T>
void launch_vec(const T* x, const float* bias, T* y, long long rows, int cv, float slope,
                float scale, cudaStream_t s) {
  int bx = 1;
  while (bx < cv && bx < 32) bx *= 2;
  const dim3 block(bx, 256 / bx);
  const unsigned gx = (unsigned)((cv + bx - 1) / bx);
  const long long want = (8LL * sm_count() + gx - 1) / gx;
  const long long need = (rows + block.y - 1) / block.y;
  const unsigned gy = (unsigned)(need < want ? need : want);
  fused_act_vec_kernel<T><<<dim3(gx, gy), block, 0, s>>>(x, bias, y, rows, cv, slope, scale);
}

bool aligned16(const void* q) { return (reinterpret_cast<unsigned long long>(q) & 15) == 0; }

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
// bias: f32 [c] or null. The vector stream where c is a multiple of 16 bytes
// of the type and x and y are 16-byte aligned, else the scalar loop. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int l2i_fused_act(const void* x, const void* bias, void* y, long long n, int c,
                             int is_bf16, float slope, float scale, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int v = is_bf16 ? 8 : 4;
  if (c % v == 0 && aligned16(x) && aligned16(y)) {
    if (is_bf16)
      launch_vec(static_cast<const __nv_bfloat16*>(x), b, static_cast<__nv_bfloat16*>(y), n / c,
                 c / v, slope, scale, s);
    else
      launch_vec(static_cast<const float*>(x), b, static_cast<float*>(y), n / c, c / v, slope,
                 scale, s);
    return (int)cudaGetLastError();
  }
  const int threads = 256;
  const unsigned blocks = grid_for(n, threads);
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
