// Host C++ of the port's counterpart of the JAX package's native extension
// (latent2im_tpu_torch/native/): the same functions as their Python forms,
// bit for bit.
//
//   l2i_png_unfilter <- utils/image.py:_unfilter: the PNG row filters (None,
//                       Sub, Up, Average, Paeth) of one image or Adam7 pass
//   l2i_crop_resize  <- native/resize.py:crop_resize: the centre square,
//                       bilinear in float64 without antialias, uint8(v + 0.5)
//
// This is host code, not a GPU kernel: nvcc hands it to the host compiler,
// and it links into the kernel library (ops/_build.py), which compiles this
// file with -ffp-contract=off: a fused multiply-add would change the
// interpolation's double sums. ctypes releases the GIL around each call, so
// the loader's threads (utils/loader.py) run them in parallel.

#include <cstdint>
#include <cstdlib>

extern "C" {

// data: h rows of (1 filter byte + stride bytes), n bytes in all -> out
// [h][stride] unfiltered, bpp the bytes a pixel (at least 1). -> 0; -1 where
// the data is shorter than the rows; -2 at an unknown filter type.
int l2i_png_unfilter(const uint8_t* data, long long n, int h, long long stride, int bpp,
                     uint8_t* out) {
  if (n < static_cast<long long>(h) * (stride + 1)) return -1;
  for (long long y = 0; y < h; ++y) {
    const uint8_t* in = data + y * (stride + 1) + 1;
    const int ftype = in[-1];
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y ? cur - stride : nullptr;
    for (long long i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = prev && i >= bpp ? prev[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -2;
      }
      cur[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  return 0;
}

// img: uint8 [h][w][3] -> out [size][size][3], native/resize.py:crop_resize
void l2i_crop_resize(const uint8_t* img, int h, int w, int size, uint8_t* out) {
  const int dim = h < w ? h : w;
  const int y0 = (h - dim) / 2, x0 = (w - dim) / 2;
  const double scale = static_cast<double>(dim) / size;
  for (int y = 0; y < size; ++y) {
    const double sy = (y + 0.5) * scale - 0.5;
    const int iy = static_cast<int>(sy < 0 ? 0 : sy);
    const int iy1 = iy + 1 < dim - 1 ? iy + 1 : dim - 1;
    double fy = sy - iy;
    if (fy < 0) fy = 0;
    for (int x = 0; x < size; ++x) {
      const double sx = (x + 0.5) * scale - 0.5;
      const int ix = static_cast<int>(sx < 0 ? 0 : sx);
      const int ix1 = ix + 1 < dim - 1 ? ix + 1 : dim - 1;
      double fx = sx - ix;
      if (fx < 0) fx = 0;
      for (int ch = 0; ch < 3; ++ch) {
        auto at = [&](int yy, int xx) -> double {
          return img[(static_cast<long long>(y0 + yy) * w + (x0 + xx)) * 3 + ch];
        };
        const double v = at(iy, ix) * (1 - fy) * (1 - fx) + at(iy, ix1) * (1 - fy) * fx +
                         at(iy1, ix) * fy * (1 - fx) + at(iy1, ix1) * fy * fx;
        out[(static_cast<long long>(y) * size + x) * 3 + ch] = static_cast<uint8_t>(v + 0.5);
      }
    }
  }
}

}  // extern "C"
