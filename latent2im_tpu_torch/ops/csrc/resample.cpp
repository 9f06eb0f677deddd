// Host C++ of utils/image.py:_pil_resize, Pillow's two-pass 8-bit resample
// (libImaging/Resample.c), equal to the numpy version bit for bit: the
// loaders' centre-crop resize on the card's path (utils/loader.py), which
// after the JPEG decode (jpeg_huffman.cpp) was the larger share of loading a
// photo in numpy. One call does both passes, its intermediate in the
// thread's own reused scratch; ctypes releases the GIL around it. Not a GPU
// kernel: nvcc hands it to the host compiler, and it links into the
// kernels' library (ops/_build.py).
#include <cstddef>
#include <cstdint>
#include <new>
#include <vector>

namespace {

// One pass along an axis: in [n_in along the axis][n_other][c] as strides
// (s_in, s_other; channels contiguous), out [n_out][n_other][c] as (o_out,
// o_other). idx/k: _pil_coeffs's first-index and fixed-point tables
// [n_out][ksize] (unused taps: index 0, coefficient 0). Each output: 1 <<
// (bits - 1) plus the taps' products, >> bits, clipped to [0, 255].
void pass(const uint8_t* in, long long s_in, long long s_other, int n_other, int c,
          const long long* idx, const long long* k, int ksize, int n_out, int bits,
          uint8_t* out, long long o_out, long long o_other) {
  for (int xo = 0; xo < n_out; ++xo) {
    const long long* ix = idx + static_cast<long long>(xo) * ksize;
    const long long* kx = k + static_cast<long long>(xo) * ksize;
    for (int o = 0; o < n_other; ++o) {
      for (int ch = 0; ch < c; ++ch) {
        int64_t acc = int64_t(1) << (bits - 1);
        const uint8_t* base = in + o * s_other + ch;
        for (int j = 0; j < ksize; ++j) acc += static_cast<int64_t>(base[ix[j] * s_in]) * kx[j];
        acc >>= bits;
        out[xo * o_out + o * o_other + ch] =
            static_cast<uint8_t>(acc < 0 ? 0 : (acc > 255 ? 255 : acc));
      }
    }
  }
}

}  // namespace

extern "C" {

// in: uint8 [h][w][c] with row stride `row` (a crop of a larger image);
// out: [out_h][out_w][c], contiguous. The horizontal pass first (its
// tables idx_w/k_w [out_w][ks_w]), then the vertical (idx_h/k_h
// [out_h][ks_h]), as _pil_resize; a null idx skips that pass (the size
// already matches; one of the two runs). -> 0, or -1 out of memory.
int l2i_resize(const uint8_t* in, long long row, int h, int w, int c, const long long* idx_w,
               const long long* k_w, int ks_w, int out_w, const long long* idx_h,
               const long long* k_h, int ks_h, int out_h, int bits, uint8_t* out) {
  try {
    thread_local std::vector<uint8_t> tmp;
    const uint8_t* src = in;
    long long src_row = row;
    if (idx_w) {
      uint8_t* dst = out;
      if (idx_h) {
        tmp.resize(static_cast<size_t>(h) * out_w * c);
        dst = tmp.data();
      }
      pass(in, c, row, h, c, idx_w, k_w, ks_w, out_w, bits, dst, c,
           static_cast<long long>(out_w) * c);
      src = dst;
      src_row = static_cast<long long>(out_w) * c;
    }
    const int cur_w = idx_w ? out_w : w;
    if (idx_h)
      pass(src, src_row, c, cur_w, c, idx_h, k_h, ks_h, out_h, bits, out,
           static_cast<long long>(cur_w) * c, c);
    return 0;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // extern "C"
