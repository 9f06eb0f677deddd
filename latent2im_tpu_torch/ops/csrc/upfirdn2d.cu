// upfirdn2d: upsample by zero-stuffing, pad or crop, FIR-filter, downsample,
// over NHWC f32 images:
//
//     out[b, oy, ox, c] = sum_{ty, tx} k[kh-1-ty][kw-1-tx] * P[b, oy*down+ty, ox*down+tx, c]
//
// where P is x zero-stuffed by `up` (each sample followed by up-1 zeros, so the
// stuffed length is H*up) and then padded by (py0, py1) rows and (px0, px1)
// columns, a negative pad cropping. Correlating with the flipped kernel is
// convolving with the kernel; `k` arrives unflipped and is flipped here.
//
// Replaces the TPU kernel latent2im_tpu/ops/pallas_kernels.py:upfirdn2d_pallas
// (_ufd_fwd -> _ufd_impl: _zero_stuff_pad, then _fir_down with _fir_kernel),
// and, launched with the transposed parameters, its VJP _ufd_bwd.
//
// Bound on an H100: bytes (each input element read once, each output written
// once; at most 16 multiply-adds per output at the 4x4 sites). The previous
// version ran at ~9x that bound, limited by instructions and latency, not
// bytes: one thread per output element, six runtime divisions to recover
// (b, oy, ox, c), a runtime `% up` and `/ up` per axis to find the first tap,
// tap loops with runtime bounds that could not unroll, 4-byte loads, and
// each input element fetched from memory kh*kw/up^2 = 16 times.
//
// Design: one block per tile of 8 output rows x TW output columns x a chunk
// of channels. The block stages its input window once into shared memory
// (16-byte cp.async for channels in fours, where C % 4 == 0); a pad or crop
// is an offset of the window and the image border a zero fill, both fixed
// once per block, so there is no per-element test of the image bounds and
// no zero is ever loaded from device memory. The forms the StyleGAN2 paths
// use, forward and backward, are template instances with the tap count and
// (up, down) as constants: 4x4 taps with (up, down) = (1, 1) (every blur and
// its gradient), (2, 1) (the ToRGB skip upsample) and (1, 2) (its gradient).
// For them the tile origin is shifted so that the first output of every
// tile sits on phase 0 of the stuffed grid; then which taps of each output
// land on samples, and the window offsets they read, are compile-time
// constants: no zero tap is visited and no division runs per element. Each
// thread computes a strip of 4 consecutive outputs along x from a register
// window of ((4-1)*down + kw - 1)/up + 1 samples per tap row (a 4-tap row
// gives 4 outputs from 7 loads instead of 16), as float4 over four channels
// where C % 4 == 0. Where C % 4 != 0 (the ToRGB skip's C = 3) a block takes
// all channels of a pixel run at once (C <= 16), so the window's rows are
// contiguous runs of W*C floats and its loads stay coalesced. Other shapes
// (asymmetric kernels, up = 4, up = down = 2) run the generic instance of
// the same tiled kernel: runtime taps, phases found per output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TH = 8;  // output rows per block (templated forms)
constexpr int SX = 4;  // consecutive outputs along x per thread (templated forms)
constexpr int MAX_TAPS = 64;
constexpr int SMEM_DEFAULT = 48 * 1024;

struct Params {
  const float* x;
  const float* k;
  float* out;
  int H, W, C, OH, OW, kh, kw, up, down, px0, py0;
  int th, tw, cc;      // output rows, columns and channels of a block
  int wr, wc;          // its input window, rows x columns
  int shx, shy;        // tile origin shifts (<= 0): tile t starts at output t*tw + shx
  int tiles_x;
};

__device__ __forceinline__ uint32_t smem_u32(const void* q) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(q));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// UP, DOWN, KH, KW > 0: a templated form (the host shifts the tile origin
// so the window starts on a sample); all 0: the generic form. V = 4:
// channels as float4 (C % 4 == 0, 16-byte aligned), else 1.
template <int UP, int DOWN, int KH, int KW, int V>
__global__ void __launch_bounds__(THREADS) upfirdn2d_tiled_kernel(const Params p) {
  constexpr bool FIXED = UP > 0;
  constexpr int U = FIXED ? UP : 1, D = FIXED ? DOWN : 1;
  constexpr int KHF = FIXED ? KH : 1, KWF = FIXED ? KW : 1;
  constexpr int TWF = V == 4 ? 16 : 32;
  constexpr int WRF = ((TH - 1) * D + KHF - 1) / U + 1;
  constexpr int WCF = ((TWF - 1) * D + KWF - 1) / U + 1;
  static_assert(!FIXED || ((SX * D) % U == 0 && TH % U == 0 && TWF % U == 0),
                "a templated tile must start every strip on phase 0");
  static_assert(FIXED || V == 1, "the generic form takes channels one by one");

  extern __shared__ __align__(16) float win[];  // [wr][wc][cc], then (generic) the taps
  const int th = FIXED ? TH : p.th, tw = FIXED ? TWF : p.tw;
  const int wr = FIXED ? WRF : p.wr, wc = FIXED ? WCF : p.wc;
  const int cc = V == 4 ? 32 : p.cc;
  const int up = FIXED ? U : p.up, down = FIXED ? D : p.down;
  const int b = blockIdx.z;
  const int tile_x = blockIdx.x % p.tiles_x;
  const int c0 = (blockIdx.x / p.tiles_x) * cc;
  const int oy0 = blockIdx.y * th + p.shy, ox0 = tile_x * tw + p.shx;
  // stuffed coordinate under tap 0 of the tile's first output, the input
  // sample at or before it, and the phase between them (0 when FIXED)
  const int jy0 = oy0 * down - p.py0, jx0 = ox0 * down - p.px0;
  const int iy0 = floor_div(jy0, up), ix0 = floor_div(jx0, up);
  const int ey = jy0 - iy0 * up, ex = jx0 - ix0 * up;
  const long long img = (long long)b * p.H;

  if constexpr (V == 4) {
    const int n = wr * wc * (cc / 4);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int c4 = i % (cc / 4), r = i / (cc / 4);
      const int iy = iy0 + r / wc, ix = ix0 + r % wc, c = c0 + c4 * 4;
      const bool ok = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && c < p.C;
      cp_async16(win + 4 * i, ok ? p.x + ((img + iy) * p.W + ix) * p.C + c : p.x, ok);
    }
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 0;\n");
  } else {
    const int n = wr * wc * cc;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int c = i % cc, r = i / cc;
      const int iy = iy0 + r / wc, ix = ix0 + r % wc;
      const bool ok = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && c0 + c < p.C;
      win[i] = ok ? __ldg(p.x + ((img + iy) * p.W + ix) * p.C + c0 + c) : 0.f;
    }
  }
  float* kf = win + wr * wc * cc;  // generic: flipped taps kf[ty][tx] = k[kh-1-ty][kw-1-tx]
  if constexpr (!FIXED) {
    for (int i = threadIdx.x; i < p.kh * p.kw; i += THREADS)
      kf[i] = __ldg(p.k + (p.kh - 1 - i / p.kw) * p.kw + (p.kw - 1 - i % p.kw));
  }
  __syncthreads();

  if constexpr (FIXED) {
    constexpr int R = ((SX - 1) * D + KWF - 1) / U + 1;  // register window per tap row
    float kr[KHF][KWF];
#pragma unroll
    for (int ty = 0; ty < KHF; ++ty)
#pragma unroll
      for (int tx = 0; tx < KWF; ++tx)
        kr[ty][tx] = __ldg(p.k + (KHF - 1 - ty) * KWF + (KWF - 1 - tx));
    const int groups = cc / V, strips = TWF / SX;
    for (int it = threadIdx.x; it < TH * strips * groups; it += THREADS) {
      const int cg = it % groups, rest = it / groups;
      const int sx = rest % strips, ry = rest / strips;
      const int oy = oy0 + ry, c = c0 + cg * V;
      if (oy < 0 || oy >= p.OH || c >= p.C) continue;
      float acc[SX][V];
#pragma unroll
      for (int e = 0; e < SX; ++e)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[e][v] = 0.f;
#pragma unroll
      for (int ty = 0; ty < KHF; ++ty) {
        const int jy = ry * D + ty;  // stuffed row, relative to the window's first sample
        if (jy % U != 0) continue;
        const float* row = win + ((jy / U) * wc + sx * SX * D / U) * cc + cg * V;
        float r[R][V];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if constexpr (V == 4) {
            const float4 q = *reinterpret_cast<const float4*>(row + i * cc);
            r[i][0] = q.x;
            r[i][1] = q.y;
            r[i][2] = q.z;
            r[i][3] = q.w;
          } else {
            r[i][0] = row[i * cc];
          }
        }
#pragma unroll
        for (int e = 0; e < SX; ++e)
#pragma unroll
          for (int tx = 0; tx < KWF; ++tx)
            if ((e * D + tx) % U == 0)
#pragma unroll
              for (int v = 0; v < V; ++v) acc[e][v] += kr[ty][tx] * r[(e * D + tx) / U][v];
      }
      float* orow = p.out + (((long long)b * p.OH + oy) * p.OW) * p.C + c;
#pragma unroll
      for (int e = 0; e < SX; ++e) {
        const int ox = ox0 + sx * SX + e;
        if (ox < 0 || ox >= p.OW) continue;
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(orow + (long long)ox * p.C) =
              make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
        else
          orow[(long long)ox * p.C] = acc[e][0];
      }
    }
  } else {
    for (int it = threadIdx.x; it < th * tw * cc; it += THREADS) {
      const int c = it % cc, rest = it / cc;
      const int xr = rest % tw, ry = rest / tw;
      const int oy = oy0 + ry, ox = ox0 + xr;
      if (oy < 0 || oy >= p.OH || ox < 0 || ox >= p.OW || c0 + c >= p.C) continue;
      float acc = 0.f;
      for (int ty = 0; ty < p.kh; ++ty) {
        const int jy = ey + ry * down + ty;
        if (jy % up != 0) continue;
        const float* row = win + (jy / up) * wc * cc + c;
        for (int tx = 0; tx < p.kw; ++tx) {
          const int jx = ex + xr * down + tx;
          if (jx % up == 0) acc += kf[ty * p.kw + tx] * row[(jx / up) * cc];
        }
      }
      p.out[(((long long)b * p.OH + oy) * p.OW + ox) * p.C + c0 + c] = acc;
    }
  }
}

template <int UP, int DOWN, int KH, int KW, int V>
cudaError_t launch(const Params& p, dim3 grid, int smem, cudaStream_t st) {
  auto kernel = upfirdn2d_tiled_kernel<UP, DOWN, KH, KW, V>;
  static int opted = SMEM_DEFAULT;  // over 48 KB of dynamic shared memory needs opting in
  if (smem > opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  kernel<<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// Which templated form takes (kh, kw, up, down): 1 = (1, 1), 2 = (2, 1),
// 3 = (1, 2), all with 4x4 taps; 0 = the generic form.
int fixed_form(int kh, int kw, int up, int down) {
  if (kh != 4 || kw != 4) return 0;
  if (up == 1 && down == 1) return 1;
  if (up == 2 && down == 1) return 2;
  if (up == 1 && down == 2) return 3;
  return 0;
}

bool aligned16(const void* q) { return (reinterpret_cast<unsigned long long>(q) & 15) == 0; }

// Whether a templated form takes channels as float4: C % 4 == 0 and both
// tensors 16-byte aligned.
bool vectorised(int form, int C, const void* x, const void* out) {
  return form != 0 && C % 4 == 0 && aligned16(x) && aligned16(out);
}

// Origin shift in (-up, 0] that puts the first output of every tile on
// phase 0 of the stuffed grid (down = 1; any shift is exact for up = 1).
int origin_shift(int p0, int up) {
  const int r = ((p0 % up) + up) % up;
  return r == 0 ? 0 : r - up;
}

int window(int n_out, int down, int k, int up, int phase_slack) {
  return ((n_out - 1) * down + k - 1 + phase_slack) / up + 1;
}

}  // namespace

// The kernel instance l2i_upfirdn2d takes for these arguments: 0 = generic,
// 1 = templated one channel at a time, 4 = templated float4.
extern "C" int l2i_upfirdn2d_form(const void* x, const void* out, int C, int kh, int kw,
                                  int up, int down) {
  const int form = fixed_form(kh, kw, up, down);
  if (form == 0) return 0;
  return vectorised(form, C, x, out) ? 4 : 1;
}

// x: [B, H, W, C] f32 contiguous; k: [kh, kw] f32 taps (unflipped), kh*kw <= 64;
// out: [B, OH, OW, C] with OH = (H*up + py0 + py1 - kh) / down + 1 (likewise OW).
// The high pads only set OH and OW, which the caller passes.
// Launches once on `stream`; returns cudaGetLastError().
extern "C" int l2i_upfirdn2d(const void* x, const void* k, void* out, int B, int H, int W,
                             int C, int OH, int OW, int kh, int kw, int up, int down, int px0,
                             int py0, void* stream) {
  if ((long long)B * OH * OW * C <= 0) return 0;
  if (kh * kw > MAX_TAPS || kh < 1 || kw < 1 || up < 1 || down < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.k = static_cast<const float*>(k);
  p.out = static_cast<float*>(out);
  p.H = H;
  p.W = W;
  p.C = C;
  p.OH = OH;
  p.OW = OW;
  p.kh = kh;
  p.kw = kw;
  p.up = up;
  p.down = down;
  p.px0 = px0;
  p.py0 = py0;
  const int form = fixed_form(kh, kw, up, down);
  const bool vec = vectorised(form, C, x, out);
  int smem;
  if (form != 0) {
    p.th = TH;
    p.tw = vec ? 16 : 32;
    p.cc = vec ? 32 : (C < 16 ? C : 16);
    p.shx = up > 1 ? origin_shift(px0, up) : 0;
    p.shy = up > 1 ? origin_shift(py0, up) : 0;
    p.wr = window(p.th, down, kh, up, 0);
    p.wc = window(p.tw, down, kw, up, 0);
    smem = p.wr * p.wc * p.cc * (int)sizeof(float);
  } else {
    // generic: the largest square tile of 8, 4, 2 or 1 outputs whose window
    // (with room for any phase) and taps fit the default shared memory
    p.cc = C < 16 ? C : 16;
    p.shx = p.shy = 0;
    for (int t = 8;; t /= 2) {
      p.th = p.tw = t;
      p.wr = window(t, down, kh, up, up - 1);
      p.wc = window(t, down, kw, up, up - 1);
      smem = (p.wr * p.wc * p.cc + kh * kw) * (int)sizeof(float);
      if (smem <= SMEM_DEFAULT || t == 1) break;
    }
  }
  p.tiles_x = (OW - p.shx + p.tw - 1) / p.tw;
  const int tiles_y = (OH - p.shy + p.th - 1) / p.th;
  const long long gx = (long long)p.tiles_x * ((C + p.cc - 1) / p.cc);
  if (tiles_y > 65535 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, tiles_y, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (form * 2 + (vec ? 1 : 0)) {
    case 2: e = launch<1, 1, 4, 4, 1>(p, grid, smem, st); break;
    case 3: e = launch<1, 1, 4, 4, 4>(p, grid, smem, st); break;
    case 4: e = launch<2, 1, 4, 4, 1>(p, grid, smem, st); break;
    case 5: e = launch<2, 1, 4, 4, 4>(p, grid, smem, st); break;
    case 6: e = launch<1, 2, 4, 4, 1>(p, grid, smem, st); break;
    case 7: e = launch<1, 2, 4, 4, 4>(p, grid, smem, st); break;
    default: e = launch<0, 0, 0, 0, 1>(p, grid, smem, st); break;
  }
  return (int)e;
}
