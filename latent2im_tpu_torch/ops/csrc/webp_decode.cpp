// Host C++ of the WEBP decoder of utils/webp.py: the same function, bit for
// bit, on every input, with the same errors in the same order (the Python
// side turns each code into the Python version's message).
//
//   l2i_webp_dims    <- the canvas height and width _demux finds
//   l2i_webp_decode  <- webp_decode_rgb: _demux's container checks, the
//                       VP8L decoder (_decode_image, _read_code, _huffman,
//                       _decode_pixels, _inverse_transforms), the alpha
//                       chunk's checks (_alpha_check) and the VP8 decoder
//                       (_VP8Header, _parse_modes, _residuals, _reconstruct,
//                       _loop_filter, _fancy_chroma, _yuv_to_rgb)
//
// This is host code, not a GPU kernel: nvcc hands it to the host compiler,
// and it links into the same library as the kernels (ops/_build.py). One
// call decodes one photo, touching only the buffers it is given and its
// own scratch; ctypes releases the GIL around it. Every read of the file
// is bounds-checked: past the data a reader sees zeros, as the Python
// version's padded reads do.
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

// error codes (utils/webp.py:_C_ERRORS); the payload info[0], info[1]
// where the message names values
enum Err {
  W_SHORT_FILE = -100, W_NOT_WEBP = -101, W_RIFF_SIZE = -102, W_RIFF_TRUNC = -103,
  W_FRAME_TRUNC = -104, W_CHUNK_SIZE = -105, W_CHUNK_PAST = -106, W_ALPH_VP8L = -107,
  W_CHUNK_HEADER = -108, W_NO_IMAGE = -109, W_FIRST_CHUNK = -110, W_BAD_VP8X = -111,
  W_VP8X_PAST = -112, W_CANVAS_LARGE = -113, W_NO_CHUNK_AFTER_VP8X = -114,
  W_SECOND_VP8X = -115, W_IMAGE_IN_ANIM = -116, W_SECOND_IMAGE = -117,
  W_AFTER_INCOMPLETE = -118, W_BAD_ANIM = -119, W_ANMF_BEFORE_ANIM = -120,
  W_BAD_ANMF = -121, W_FRAME_LARGE = -122, W_ANMF_PAST = -123, W_NO_FRAME = -124,
  W_FLAGS = -125, W_FRAMES_IN_STILL = -126, W_INCOMPLETE = -127, W_ALPHA_AFTER = -128,
  W_EMPTY_FRAME = -129, W_SIZE_VS_CANVAS = -130, W_OUTSIDE_CANVAS = -131, W_BOMB = -132,
  W_IMAGE_CHUNK_TRUNC = -133, W_VP8L_SIGNATURE = -134, W_CODE_EMPTY = -135,
  W_CODE_OVER = -136, W_CODE_INCOMPLETE = -137, W_COUNT_PAST = -138, W_REPEAT_PAST = -139,
  W_ENDS_IN_CODE = -140, W_TRANSFORM_TWICE = -141, W_CACHE_SIZE = -142,
  W_ENDS_IN_HEADER = -143, W_LZ77 = -144, W_CACHE_CODE = -145, W_VP8L_ENDS = -146,
  W_EMPTY_ALPH = -147, W_BAD_ALPH = -148, W_ALPH_SHORT = -149, W_VP8_HEADER_TRUNC = -150,
  W_VP8_SIGNATURE = -151, W_NOT_KEY = -152, W_VP8_BAD_HEADER = -153, W_VP8_ZERO = -154,
  W_PART_LENGTH = -155, W_ENDS_SEGMENT = -156, W_ENDS_FILTER = -157, W_PART_SIZES = -158,
  W_LAST_PART = -159, W_ENDS_PART0 = -160, W_VP8_ENDS = -161, W_OUT_SIZE = -162,
  W_NOMEM = -163,
};

constexpr long long kMaxChunk = 0xFFFFFFFFLL - 8 - 1;
constexpr long long kMaxArea = 1LL << 32;
constexpr long long kPillowMaxPixels = 2LL * (1024 * 1024 * 1024 / 4 / 3);

struct Fail {
  int code;
  long long a = 0, b = 0;
};

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}
inline uint32_t le24(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
}

// ---------------------------------------------------------------------------
// VP8L (utils/webp.py:_LBits, _read_code, _huffman, _decode_image,
// _decode_pixels, _inverse_transforms)
// ---------------------------------------------------------------------------

struct LBits {
  const uint8_t* data;
  long long n, pos = 0, limit;
  LBits(const uint8_t* d, long long len) : data(d), n(len), limit(8 * (len > 8 ? len : 8)) {}
  uint64_t window(long long p) const {  // 64 bits from bit p, zeros past the data
    uint64_t v = 0;
    const long long i = p >> 3;
    for (int k = 0; k < 8; ++k) {
      const long long j = i + k;
      if (j >= 0 && j < n) v |= uint64_t(data[j]) << (8 * k);
    }
    return v >> (p & 7);
  }
  uint32_t read(int bits) {
    if (pos > limit) return 0;  // libwebp reads 0 once at the end of stream
    const uint32_t v = static_cast<uint32_t>(window(pos) & ((uint64_t(1) << bits) - 1));
    pos += bits;
    return v;
  }
  uint32_t peek(int bits) const {
    return bits ? static_cast<uint32_t>(window(pos) & ((uint64_t(1) << bits) - 1)) : 0;
  }
  bool eos() const { return pos > limit; }
};

struct Code {  // a prefix code's lookup table: symbol << 4 | length
  std::vector<int> table;
  int bits = 0;
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// utils/webp.py:_huffman
void huffman(const std::vector<int>& lengths, int alphabet, Code& out) {
  int used = 0, last = -1;
  int counts[16] = {0};
  for (int i = 0; i < alphabet; ++i)
    if (lengths[i]) {
      ++used;
      last = i;
      ++counts[lengths[i]];
    }
  if (used == 0) throw Fail{W_CODE_EMPTY};
  if (used == 1) {
    out.table.assign(1, last << 4);
    out.bits = 0;
    return;
  }
  long long left = 1;
  for (int len = 1; len < 16; ++len) {
    left = 2 * left - counts[len];
    if (left < 0) throw Fail{W_CODE_OVER};
  }
  if (left) throw Fail{W_CODE_INCOMPLETE};
  int maxlen = 0;
  for (int len = 1; len < 16; ++len)
    if (counts[len]) maxlen = len;
  out.bits = maxlen;
  out.table.assign(size_t(1) << maxlen, 0);
  // canonical codes by (length, symbol), then bit-reversed keys
  int code = 0, prev = 0;
  for (int len = 1; len <= maxlen; ++len) {
    for (int sym = 0; sym < alphabet; ++sym) {
      if (lengths[sym] != len) continue;
      if (prev) code <<= len - prev;
      prev = len;
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int k = rev; k < (1 << maxlen); k += 1 << len) out.table[k] = (sym << 4) | len;
      ++code;
    }
  }
}

// utils/webp.py:_read_code
void read_code(LBits& br, int alphabet, Code& out) {
  std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
  if (br.read(1)) {
    const uint32_t count = br.read(1) + 1;
    const uint32_t first = br.read(br.read(1) == 0 ? 1 : 8);
    lengths[first] = 1;
    if (count == 2) lengths[br.read(8)] = 1;
  } else {
    std::vector<int> clc(19, 0);
    const uint32_t n = br.read(4) + 4;
    for (uint32_t i = 0; i < n; ++i) clc[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
    Code lens;
    huffman(clc, 19, lens);
    long long max_symbol;
    if (br.read(1)) {
      max_symbol = 2 + br.read(2 + 2 * static_cast<int>(br.read(3)));
      if (max_symbol > alphabet) throw Fail{W_COUNT_PAST};
    } else {
      max_symbol = alphabet;
    }
    int prev = 8, sym = 0;
    while (sym < alphabet) {
      if (max_symbol == 0) break;
      --max_symbol;
      const int e = lens.table[br.peek(lens.bits)];
      br.pos += e & 15;
      const int code_len = e >> 4;
      if (code_len < 16) {
        lengths[sym++] = code_len;
        if (code_len) prev = code_len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int repeat = static_cast<int>(br.read(kExtra[code_len - 16])) + kOffset[code_len - 16];
        if (sym + repeat > alphabet) throw Fail{W_REPEAT_PAST};
        const int fill = code_len == 16 ? prev : 0;
        for (int k = 0; k < repeat; ++k) lengths[sym++] = fill;
      }
    }
  }
  if (br.eos()) throw Fail{W_ENDS_IN_CODE};
  huffman(lengths, alphabet, out);
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

int prefix_value(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  return ((2 + (sym & 1)) << extra) + static_cast<int>(br.read(extra)) + 1;
}

const int8_t kPlane[120][2] = {
    {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2}, {-1, 2}, {2, 1}, {-2, 1},
    {2, 2}, {-2, 2}, {0, 3}, {3, 0}, {1, 3}, {-1, 3}, {3, 1}, {-3, 1}, {2, 3}, {-2, 3},
    {3, 2}, {-3, 2}, {0, 4}, {4, 0}, {1, 4}, {-1, 4}, {4, 1}, {-4, 1}, {3, 3}, {-3, 3},
    {2, 4}, {-2, 4}, {4, 2}, {-4, 2}, {0, 5}, {3, 4}, {-3, 4}, {4, 3}, {-4, 3}, {5, 0},
    {1, 5}, {-1, 5}, {5, 1}, {-5, 1}, {2, 5}, {-2, 5}, {5, 2}, {-5, 2}, {4, 4}, {-4, 4},
    {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6}, {6, 0}, {1, 6}, {-1, 6}, {6, 1}, {-6, 1},
    {2, 6}, {-2, 6}, {6, 2}, {-6, 2}, {4, 5}, {-4, 5}, {5, 4}, {-5, 4}, {3, 6}, {-3, 6},
    {6, 3}, {-6, 3}, {0, 7}, {7, 0}, {1, 7}, {-1, 7}, {5, 5}, {-5, 5}, {7, 1}, {-7, 1},
    {4, 6}, {-4, 6}, {6, 4}, {-6, 4}, {2, 7}, {-2, 7}, {7, 2}, {-7, 2}, {3, 7}, {-3, 7},
    {7, 3}, {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5}, {8, 0}, {4, 7}, {-4, 7}, {7, 4},
    {-7, 4}, {8, 1}, {8, 2}, {6, 6}, {-6, 6}, {8, 3}, {5, 7}, {-5, 7}, {7, 5}, {-7, 5},
    {8, 4}, {6, 7}, {-6, 7}, {7, 6}, {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6}, {8, 7}};

struct Transform {
  int type, xsize, bits;
  std::vector<uint32_t> data;
};

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
         (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}

// utils/webp.py:_decode_pixels
std::vector<uint32_t> decode_pixels(LBits& br, int width, int height,
                                    const std::vector<Code>& groups, const std::vector<int>& meta,
                                    int meta_bits, int meta_w, int cache_bits, bool alpha8) {
  const long long total = static_cast<long long>(width) * height;
  std::vector<uint32_t> out(static_cast<size_t>(total), 0);
  std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
  const int shift = 32 - cache_bits;
  long long cached = 0, pos = 0;
  int x = 0, y = 0;
  const Code* g = groups.data();
  while (pos < total) {
    if (!meta.empty()) g = groups.data() + 5 * meta[(y >> meta_bits) * meta_w + (x >> meta_bits)];
    int e = g[0].table[br.peek(g[0].bits)];
    br.pos += e & 15;
    const int code = e >> 4;
    if (code < 256) {
      e = g[1].table[br.peek(g[1].bits)];
      br.pos += e & 15;
      const uint32_t red = e >> 4;
      e = g[2].table[br.peek(g[2].bits)];
      br.pos += e & 15;
      const uint32_t blue = e >> 4;
      e = g[3].table[br.peek(g[3].bits)];
      br.pos += e & 15;
      out[pos++] = (uint32_t(e >> 4) << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
      if (++x >= width) x = 0, ++y;
    } else if (code < 280) {
      const int length = prefix_value(code - 256, br);
      e = g[4].table[br.peek(g[4].bits)];
      br.pos += e & 15;
      const int dist_code = prefix_value(e >> 4, br);
      long long dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        dist = kPlane[dist_code - 1][0] + static_cast<long long>(kPlane[dist_code - 1][1]) * width;
        if (dist < 1) dist = 1;
      }
      if (br.pos > br.limit) break;
      if (dist > pos || total - pos < length) throw Fail{W_LZ77};
      for (long long k = pos; k < pos + length; ++k) out[k] = out[k - dist];
      pos += length;
      x += length;
      while (x >= width) x -= width, ++y;
    } else {
      if (cache.empty()) throw Fail{W_CACHE_CODE};
      while (cached < pos) {
        const uint32_t c = out[cached++];
        cache[static_cast<uint32_t>(c * 0x1E35A7BDu) >> shift] = c;
      }
      out[pos++] = cache[code - 280];
      if (++x >= width) x = 0, ++y;
    }
    if (br.pos > br.limit) break;
  }
  if (br.eos() && !(alpha8 && pos >= total)) throw Fail{W_VP8L_ENDS};
  return out;
}

std::vector<uint32_t> expand_palette(const std::vector<uint32_t>& pal, int n, int bits) {
  std::vector<uint32_t> out(size_t(1) << (8 >> bits), 0);
  uint32_t prev = 0;
  for (int i = 0; i < n; ++i) {
    uint32_t c = pal[i];
    if (i) c = add_px(c, prev);
    out[i] = prev = c;
  }
  return out;
}

// utils/webp.py:_decode_image -> pixels; transforms and the coded width out
std::vector<uint32_t> decode_image(LBits& br, int xsize, int ysize, bool level0,
                                   std::vector<Transform>* transforms, int* alpha8) {
  std::vector<Transform> local;
  std::vector<Transform>& tr = transforms ? *transforms : local;
  if (level0) {
    int seen = 0;
    while (br.read(1)) {
      const int type = static_cast<int>(br.read(2));
      if (seen & (1 << type)) throw Fail{W_TRANSFORM_TWICE};
      seen |= 1 << type;
      if (type == 0 || type == 1) {
        const int bits = static_cast<int>(br.read(3)) + 2;
        std::vector<uint32_t> sub = decode_image(br, subsample(xsize, bits),
                                                 subsample(ysize, bits), false, nullptr, nullptr);
        tr.push_back({type, xsize, bits, std::move(sub)});
      } else if (type == 3) {
        const int n = static_cast<int>(br.read(8)) + 1;
        const int bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
        std::vector<uint32_t> pal = decode_image(br, n, 1, false, nullptr, nullptr);
        tr.push_back({3, xsize, bits, expand_palette(pal, n, bits)});
        xsize = subsample(xsize, bits);
      } else {
        tr.push_back({2, xsize, 0, {}});
      }
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = static_cast<int>(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) throw Fail{W_CACHE_SIZE};
  }
  std::vector<int> meta;
  int meta_bits = 0, meta_w = 0, n_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = static_cast<int>(br.read(3)) + 2;
    meta_w = subsample(xsize, meta_bits);
    std::vector<uint32_t> img =
        decode_image(br, meta_w, subsample(ysize, meta_bits), false, nullptr, nullptr);
    meta.resize(img.size());
    int mx = 0;
    for (size_t i = 0; i < img.size(); ++i) {
      meta[i] = (img[i] >> 8) & 0xFFFF;
      mx = meta[i] > mx ? meta[i] : mx;
    }
    n_groups = mx + 1;
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<Code> groups(static_cast<size_t>(n_groups) * 5);
  for (int gi = 0; gi < n_groups; ++gi)
    for (int k = 0; k < 5; ++k) read_code(br, alphabets[k], groups[5 * gi + k]);
  bool a8 = false;
  if (alpha8) {
    a8 = tr.size() == 1 && tr[0].type == 3 && !cache_bits;
    for (int gi = 0; gi < n_groups && a8; ++gi)
      a8 = groups[5 * gi + 1].bits == 0 && groups[5 * gi + 2].bits == 0 &&
           groups[5 * gi + 3].bits == 0;
    *alpha8 = a8;
  }
  if (br.eos()) throw Fail{W_ENDS_IN_HEADER};
  return decode_pixels(br, xsize, ysize, groups, meta, meta_bits, meta_w, cache_bits, a8);
}

inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: {
      int d = 0;
      for (int s = 24; s >= 0; s -= 8) {
        const int t = (T >> s) & 0xFF, l = (L >> s) & 0xFF, tl = (TL >> s) & 0xFF;
        d += std::abs(l - tl) - std::abs(t - tl);
      }
      return d <= 0 ? T : L;
    }
    case 12: {
      uint32_t out = 0;
      for (int s = 24; s >= 0; s -= 8)
        out |= uint32_t(clip255(int((L >> s) & 0xFF) + int((T >> s) & 0xFF) - int((TL >> s) & 0xFF)))
               << s;
      return out;
    }
    case 13: {
      const uint32_t ave = avg2(L, T);
      uint32_t out = 0;
      for (int s = 24; s >= 0; s -= 8) {
        const int a = (ave >> s) & 0xFF, b = (TL >> s) & 0xFF;
        out |= uint32_t(clip255(a + (a - b) / 2)) << s;  // C division: towards 0
      }
      return out;
    }
    default: return 0xFF000000u;
  }
}

// utils/webp.py:_inverse_transforms (and _inverse_predictor), in place
void inverse_transforms(std::vector<uint32_t>& px, int height,
                        const std::vector<Transform>& transforms) {
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) {
    const Transform& t = *it;
    const int w = t.xsize;
    if (t.type == 0) {
      if (!w) continue;
      const int tiles_w = subsample(w, t.bits);
      px[0] = add_px(px[0], 0xFF000000u);
      for (int x = 1; x < w; ++x) px[x] = add_px(px[x], px[x - 1]);
      for (int y = 1; y < height; ++y) {
        const long long row = static_cast<long long>(y) * w, up = row - w;
        px[row] = add_px(px[row], px[up]);
        const long long trow = static_cast<long long>(y >> t.bits) * tiles_w;
        for (int x = 1; x < w; ++x) {
          const int mode = (t.data[trow + (x >> t.bits)] >> 8) & 15;
          const long long i = row + x;
          px[i] = add_px(px[i], predict(mode, px[i - 1], px[up + x], px[up + x + 1], px[up + x - 1]));
        }
      }
    } else if (t.type == 2) {
      for (uint32_t& p : px) {
        const uint32_t g = (p >> 8) & 0xFF;
        p = (p & 0xFF00FF00u) | (((p & 0x00FF00FFu) + ((g << 16) | g)) & 0x00FF00FFu);
      }
    } else if (t.type == 1) {
      const int tiles_w = subsample(w, t.bits);
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[static_cast<long long>(y >> t.bits) * tiles_w + (x >> t.bits)];
          const int g2r = int8_t(m & 0xFF), g2b = int8_t((m >> 8) & 0xFF), r2b = int8_t((m >> 16) & 0xFF);
          uint32_t& p = px[static_cast<long long>(y) * w + x];
          const int green = int8_t((p >> 8) & 0xFF);
          int red = int((p >> 16) & 0xFF) + ((g2r * green) >> 5);
          red &= 0xFF;
          int blue = int(p & 0xFF) + ((g2b * green) >> 5);
          blue += (r2b * int(int8_t(red))) >> 5;
          blue &= 0xFF;
          p = (p & 0xFF00FF00u) | (uint32_t(red) << 16) | uint32_t(blue);
        }
    } else {  // color indexing: the packed width becomes t.xsize
      const int packed = subsample(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * height);
      const int per = 1 << t.bits, bpp = 8 >> t.bits;
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t idx = (px[static_cast<long long>(y) * packed + (x >> t.bits)] >> 8) & 0xFF;
          if (t.bits) idx = (idx >> ((x % per) * bpp)) & ((1u << bpp) - 1);
          out[static_cast<long long>(y) * w + x] = t.data[idx];
        }
      px.swap(out);
    }
  }
}

// utils/webp.py:_vp8l_argb
std::vector<uint32_t> vp8l_argb(const uint8_t* data, long long n, int width, int height,
                                bool level0_header, int* alpha8) {
  LBits br(data, n);
  if (level0_header) br.pos = 40;
  std::vector<Transform> transforms;
  std::vector<uint32_t> px = decode_image(br, width, height, true, &transforms, alpha8);
  inverse_transforms(px, height, transforms);
  return px;
}

void vp8l_info(const uint8_t* data, long long n, int* w, int* h) {
  if (n < 5 || data[0] != 0x2F || (data[4] >> 5)) throw Fail{W_VP8L_SIGNATURE};
  const uint32_t v = le32(data + 1);
  *w = int(v & 0x3FFF) + 1;
  *h = int((v >> 14) & 0x3FFF) + 1;
}

// utils/webp.py:_alpha_check
void alpha_check(const uint8_t* a, long long n, int width, int height) {
  if (n <= 1) throw Fail{W_EMPTY_ALPH};
  const int method = a[0] & 3, pre = (a[0] >> 4) & 3, rsrv = a[0] >> 6;
  if (method > 1 || pre > 1 || rsrv) throw Fail{W_BAD_ALPH};
  if (method == 0) {
    if (n - 1 < static_cast<long long>(width) * height) throw Fail{W_ALPH_SHORT};
    return;
  }
  int a8 = 0;
  vp8l_argb(a + 1, n - 1, width, height, false, &a8);
}

// ---------------------------------------------------------------------------
// VP8 (utils/webp.py:_BoolDecoder, _VP8Header, _parse_modes, _residuals,
// _wht, _idct, _pred4, _pred_block, _reconstruct, _filter_edge,
// _loop_filter, _fancy_chroma, _yuv_to_rgb)
// ---------------------------------------------------------------------------

// RFC 6386's tables (utils/webp.py:_COEF_PROBS, _COEF_UPDATE, _BMODE_PROBS,
// _DC_Q, _AC_Q), flattened in C order
const uint8_t kCoefProbs[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoefUpdate[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBmodeProbs[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175, 69, 143, 80,
    85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10,
    173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55,
    19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29,
    16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80, 66, 102,
    167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107, 74, 43, 26, 146, 73, 166,
    49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104, 79, 12, 27, 217, 255, 87, 17, 7, 87,
    68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197,
    189, 23, 18, 22, 88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77, 39, 28, 85, 171,
    58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54, 32, 26, 51, 1, 81, 43,
    31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78,
    95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21,
    18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109, 88, 43,
    29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209, 100, 80, 8, 43, 154, 1,
    51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51,
    50, 17, 168, 209, 192, 23, 25, 82, 138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82,
    115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24,
    128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6,
    223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70,
    205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10,
    32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32,
    12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21, 23, 111, 59, 205,
    45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104, 85, 117, 175, 82, 95,
    84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102,
    57, 53, 41, 49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102,
    102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34, 53, 31, 243,
    192, 69, 60, 71, 38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19,
    70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32,
    201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1, 56, 8,
    17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50, 31, 137, 154, 133,
    25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135, 148, 224, 45, 183, 128, 22,
    26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60,
    138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128, 190, 80, 35, 99,
    180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32, 101, 75, 128, 139, 118, 146, 116, 128,
    85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60,
    138, 55, 70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81,
    188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const int kDcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const int kAcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

void vp8_info(const uint8_t* data, long long n, long long chunk_size) {
  if (n < 10) throw Fail{W_VP8_HEADER_TRUNC};
  if (data[3] != 0x9D || data[4] != 0x01 || data[5] != 0x2A) throw Fail{W_VP8_SIGNATURE};
  const uint32_t bits = le24(data);
  if (bits & 1) throw Fail{W_NOT_KEY};
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size)
    throw Fail{W_VP8_BAD_HEADER};
  if (!(le24(data + 6) & 0x3FFF) || !(le24(data + 8) & 0x3FFF)) throw Fail{W_VP8_ZERO};
}

struct Bool {
  const uint8_t* data;
  long long pos, end;
  uint64_t value = 0;
  int range = 254, bits = -8;
  bool eof = false;
  Bool(const uint8_t* d, long long start, long long size) : data(d), pos(start), end(start + size) {
    load();
  }
  void load() {
    if (pos < end) {
      value = (value << 8) | data[pos++];
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    int rng = range;
    const int p = bits;
    const int split = (rng * prob) >> 8;
    int b;
    if (static_cast<int64_t>(value >> p) > split) {
      rng -= split;
      value -= uint64_t(split + 1) << p;
      b = 1;
    } else {
      rng = split + 1;
      b = 0;
    }
    int len = 0;
    for (int r = rng; r; r >>= 1) ++len;
    const int shift = 8 - len;
    range = (rng << shift) - 1;
    bits = p - shift;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n > 0) v |= bit(0x80) << --n;
    return v;
  }
  int signed_bits(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

inline int16_t w16(int64_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF)); }

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
              kCat5[] = {180, 157, 141, 134, 130, 0},
              kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCats[4] = {kCat3, kCat4, kCat5, kCat6};

struct Header {
  int width = 0, height = 0, filter_type = 0, use_skip = 0, skip_p = 0, update_map = 0;
  int seg_probs[3] = {255, 255, 255};
  int quant[4][3][2];  // per segment: (y1, y2, uv) x (dc, ac)
  int fstrength[4][2][3];  // per segment and i4x4: (limit, ilevel, hev)
  uint8_t probs[4][8][3][11];
  Bool* br = nullptr;
  std::vector<Bool> parts;
};

int clipq(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void parse_header(const uint8_t* data, long long n, Header& hd, std::vector<Bool>& store) {
  if (n < 10) throw Fail{W_VP8_HEADER_TRUNC};
  const long long part0 = le24(data) >> 5;
  hd.width = le24(data + 6) & 0x3FFF;
  hd.height = le24(data + 8) & 0x3FFF;
  if (part0 > n - 10) throw Fail{W_PART_LENGTH};
  store.emplace_back(data, 10, part0);
  Bool& br = store.back();
  br.bit(0x80);
  br.bit(0x80);
  const int use_segment = br.bit(0x80);
  int absolute = 1, q[4] = {0, 0, 0, 0}, f[4] = {0, 0, 0, 0};
  if (use_segment) {
    hd.update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      absolute = br.bit(0x80);
      for (int& v : q) v = br.bit(0x80) ? br.signed_bits(7) : 0;
      for (int& v : f) v = br.bit(0x80) ? br.signed_bits(6) : 0;
    }
    if (hd.update_map)
      for (int& p : hd.seg_probs) p = br.bit(0x80) ? br.value_bits(8) : 255;
  }
  if (br.eof) throw Fail{W_ENDS_SEGMENT};
  const int simple = br.bit(0x80), level = br.value_bits(6), sharpness = br.value_bits(3);
  int ref_lf[4] = {0, 0, 0, 0}, mode_lf[4] = {0, 0, 0, 0};
  if (br.bit(0x80) && br.bit(0x80)) {
    for (int& v : ref_lf) v = br.bit(0x80) ? br.signed_bits(6) : 0;
    for (int& v : mode_lf) v = br.bit(0x80) ? br.signed_bits(6) : 0;
  }
  hd.filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) throw Fail{W_ENDS_FILTER};
  const long long last = (1 << br.value_bits(2)) - 1;
  const long long at = 10 + part0, size = n - at;
  if (size < 3 * last) throw Fail{W_PART_SIZES};
  long long start = at + 3 * last, left = size - 3 * last;
  for (long long p = 0; p < last; ++p) {
    long long psize = le24(data + at + 3 * p);
    psize = psize < left ? psize : left;
    hd.parts.emplace_back(data, start, psize);
    start += psize;
    left -= psize;
  }
  hd.parts.emplace_back(data, start, left);
  if (start >= n) throw Fail{W_LAST_PART};
  const int base = br.value_bits(7);
  int dq[5];
  for (int& v : dq) v = br.bit(0x80) ? br.signed_bits(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int qs;
    if (use_segment) {
      qs = q[s] + (absolute ? 0 : base);
    } else if (s) {
      std::memcpy(hd.quant[s], hd.quant[0], sizeof(hd.quant[0]));
      continue;
    } else {
      qs = base;
    }
    int y2_ac = (kAcQ[clipq(qs + dq[2], 127)] * 101581) >> 16;
    hd.quant[s][0][0] = kDcQ[clipq(qs + dq[0], 127)];
    hd.quant[s][0][1] = kAcQ[clipq(qs, 127)];
    hd.quant[s][1][0] = kDcQ[clipq(qs + dq[1], 127)] * 2;
    hd.quant[s][1][1] = y2_ac > 8 ? y2_ac : 8;
    hd.quant[s][2][0] = kDcQ[clipq(qs + dq[3], 117)];
    hd.quant[s][2][1] = kAcQ[clipq(qs + dq[4], 127)];
  }
  br.bit(0x80);
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 11; ++k)
          hd.probs[t][b][c][k] = static_cast<uint8_t>(
              br.bit(kCoefUpdate[t][b][c][k]) ? br.value_bits(8) : kCoefProbs[t][b][c][k]);
  hd.use_skip = br.bit(0x80);
  hd.skip_p = hd.use_skip ? br.value_bits(8) : 0;
  for (int s = 0; s < 4; ++s) {
    const int lvl = use_segment ? f[s] + (absolute ? 0 : level) : level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int lv = lvl + ref_lf[0] + (i4 ? mode_lf[0] : 0);
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          il = il < 9 - sharpness ? il : 9 - sharpness;
        }
        il = il > 1 ? il : 1;
        hd.fstrength[s][i4][0] = 2 * lv + il;
        hd.fstrength[s][i4][1] = il;
        hd.fstrength[s][i4][2] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      } else {
        hd.fstrength[s][i4][0] = hd.fstrength[s][i4][1] = hd.fstrength[s][i4][2] = 0;
      }
    }
  }
  hd.br = &br;
}

struct MB {
  int seg, skip, is_i4, modes[16], uv;
  int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

void parse_modes(Bool& br, const Header& hd, int mb_w, std::vector<int>& top, MB* row) {
  int left[4] = {0, 0, 0, 0};
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    MB& mb = row[mb_x];
    mb.seg = 0;
    if (hd.update_map)
      mb.seg = !br.bit(hd.seg_probs[0]) ? br.bit(hd.seg_probs[1]) : 2 + br.bit(hd.seg_probs[2]);
    mb.skip = hd.use_skip ? br.bit(hd.skip_p) : 0;
    mb.is_i4 = !br.bit(145);
    int* t = top.data() + 4 * mb_x;
    if (!mb.is_i4) {
      const int mode = br.bit(156) ? (br.bit(128) ? 1 : 3) : (br.bit(163) ? 2 : 0);
      mb.modes[0] = mode;
      for (int k = 0; k < 4; ++k) t[k] = left[k] = mode;
    } else {
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* p = kBmodeProbs[t[x]][ymode];
          if (!br.bit(p[0])) ymode = 0;
          else if (!br.bit(p[1])) ymode = 1;
          else if (!br.bit(p[2])) ymode = 2;
          else if (!br.bit(p[3])) ymode = !br.bit(p[4]) ? 3 : (!br.bit(p[5]) ? 4 : 5);
          else if (!br.bit(p[6])) ymode = 6;
          else if (!br.bit(p[7])) ymode = 7;
          else ymode = !br.bit(p[8]) ? 8 : 9;
          t[x] = ymode;
        }
        for (int x = 0; x < 4; ++x) mb.modes[4 * y + x] = t[x];
        left[y] = ymode;
      }
    }
    mb.uv = !br.bit(142) ? 0 : !br.bit(114) ? 2 : (br.bit(183) ? 1 : 3);
  }
}

int large_value(Bool& br, const uint8_t* p) {
  if (!br.bit(p[3])) return !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    const int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int b1 = br.bit(p[8]);
  const int cat = 2 * b1 + br.bit(p[9 + b1]);
  int v = 0;
  for (const uint8_t* tab = kCats[cat]; *tab; ++tab) v = v + v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

// the type's probabilities for coefficient n (band kBands[n]) and context
inline const uint8_t* probs_of(const Header& hd, int type, int n, int ctx) {
  return hd.probs[type][kBands[n]][ctx];
}

int coeffs(Bool& br, const Header& hd, int type, int ctx, int dq0, int dq1, int n, int32_t* out) {
  const uint8_t* p = probs_of(hd, type, n, ctx);
  while (n < 16) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      if (++n == 16) return 16;
      p = probs_of(hd, type, n, 0);
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = probs_of(hd, type, n + 1, 1);
    } else {
      v = large_value(br, p);
      p = probs_of(hd, type, n + 1, 2);
    }
    if (br.bit(0x80)) v = -v;
    out[kZigzag[n]] = w16(static_cast<int64_t>(v) * (n ? dq1 : dq0));
    ++n;
  }
  return 16;
}

void wht(const int32_t* c, int32_t* out) {
  int64_t tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int64_t a0 = c[i] + c[12 + i], a1 = c[4 + i] + c[8 + i];
    const int64_t a2 = c[4 + i] - c[8 + i], a3 = c[i] - c[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int64_t dc = tmp[4 * i] + 3;
    const int64_t a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int64_t a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[4 * i + 0] = w16((a0 + a1) >> 3);
    out[4 * i + 1] = w16((a3 + a2) >> 3);
    out[4 * i + 2] = w16((a0 - a1) >> 3);
    out[4 * i + 3] = w16((a3 - a2) >> 3);
  }
}

// utils/webp.py:_residuals -> whether all the blocks are zero
bool residuals(Bool& br, const Header& hd, const MB& mb, int* nz_top, int* nz_top_dc,
               int* nz_left, int32_t* coefs) {
  const int(*q)[2] = hd.quant[mb.seg];
  int tnz = *nz_top, tdc = *nz_top_dc, lnz = nz_left[0], ldc = nz_left[1];
  bool any = false;
  int first, ac;
  if (!mb.is_i4) {
    const int nz = coeffs(br, hd, 1, tdc + ldc, q[1][0], q[1][1], 0, coefs + 384);
    tdc = ldc = nz > 0;
    int32_t dcs[16];
    wht(coefs + 384, dcs);
    for (int k = 0; k < 16; ++k) coefs[16 * k] = dcs[k];
    first = 1;
    ac = 0;
  } else {
    first = 0;
    ac = 3;
  }
  int t = tnz & 15, lft = lnz & 15;
  for (int y = 0; y < 4; ++y) {
    int lbit = lft & 1;
    for (int x = 0; x < 4; ++x) {
      const int ctx = lbit + (t & 1);
      int32_t* b = coefs + 16 * (4 * y + x);
      const int n = coeffs(br, hd, ac, ctx, first ? q[0][1] : q[0][0], q[0][1], first, b);
      lbit = n > first;
      any |= n > 1 || b[0] != 0;
      t = (t >> 1) | (lbit << 7);
    }
    t >>= 4;
    lft = (lft >> 1) | (lbit << 7);
  }
  int out_t = t, out_l = lft >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    t = tnz >> (4 + ch);
    lft = lnz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int lbit = lft & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = lbit + (t & 1);
        int32_t* b = coefs + 256 + 32 * ch + 16 * (2 * y + x);
        const int n = coeffs(br, hd, 2, ctx, q[2][0], q[2][1], 0, b);
        lbit = n > 0;
        any |= n > 1 || b[0] != 0;
        t = (t >> 1) | (lbit << 3);
      }
      t >>= 2;
      lft = (lft >> 1) | (lbit << 5);
    }
    out_t |= (t << 4) << ch;
    out_l |= (lft & 0xF0) << ch;
  }
  *nz_top = out_t;
  *nz_top_dc = tdc;
  nz_left[0] = out_l;
  nz_left[1] = ldc;
  return !any;
}

// dec.c TransformOne -> what the block adds to its prediction (raster)
void idct(const int32_t* c, int32_t* out) {
  auto mul1 = [](int64_t a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int64_t a) { return (a * 35468) >> 16; };
  int64_t t[4][4];  // t[k][i]: column i's k-th value
  for (int i = 0; i < 4; ++i) {
    const int64_t a = int64_t(c[i]) + c[8 + i], b = int64_t(c[i]) - c[8 + i];
    const int64_t cc = mul2(c[4 + i]) - mul1(c[12 + i]), d = mul1(c[4 + i]) + mul2(c[12 + i]);
    t[0][i] = a + d;
    t[1][i] = b + cc;
    t[2][i] = b - cc;
    t[3][i] = a - d;
  }
  for (int k = 0; k < 4; ++k) {
    const int64_t dc = t[k][0] + 4;
    const int64_t a = dc + t[k][2], b = dc - t[k][2];
    const int64_t cc = mul2(t[k][1]) - mul1(t[k][3]), d = mul1(t[k][1]) + mul2(t[k][3]);
    out[4 * k + 0] = static_cast<int32_t>((a + d) >> 3);
    out[4 * k + 1] = static_cast<int32_t>((b + cc) >> 3);
    out[4 * k + 2] = static_cast<int32_t>((b - cc) >> 3);
    out[4 * k + 3] = static_cast<int32_t>((a - d) >> 3);
  }
}

inline int a3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int a2(int a, int b) { return (a + b + 1) >> 1; }

// utils/webp.py:_pred4: w is the work area [17][21]; the block's top-left
// neighbour at w[r][c] -> pred[4][4]
void pred4(const int (*w)[21], int r, int c, int mode, int pred[4][4]) {
  const int X = w[r][c];
  const int A = w[r][c + 1], B = w[r][c + 2], C = w[r][c + 3], D = w[r][c + 4];
  const int E = w[r][c + 5], F = w[r][c + 6], G = w[r][c + 7], H = w[r][c + 8];
  const int I = w[r + 1][c], J = w[r + 2][c], K = w[r + 3][c], L = w[r + 4][c];
  switch (mode) {
    case 0: {
      const int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) pred[y][x] = v;
      return;
    }
    case 1: {
      const int lv[4] = {I, J, K, L}, tv[4] = {A, B, C, D};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          const int v = tv[x] + lv[y] - X;
          pred[y][x] = v < 0 ? 0 : v > 255 ? 255 : v;
        }
      return;
    }
    case 2: {
      const int row[4] = {a3(X, A, B), a3(A, B, C), a3(B, C, D), a3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) pred[y][x] = row[x];
      return;
    }
    case 3: {
      const int col[4] = {a3(X, I, J), a3(I, J, K), a3(J, K, L), a3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) pred[y][x] = col[y];
      return;
    }
    case 4: {
      const int e[9] = {L, K, J, I, X, A, B, C, D};
      int v[7];
      for (int i = 0; i < 7; ++i) v[i] = a3(e[i], e[i + 1], e[i + 2]);
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) pred[y][x] = v[x - y + 3];
      return;
    }
    case 6: {
      const int t[9] = {A, B, C, D, E, F, G, H, H};
      int v[7];
      for (int i = 0; i < 7; ++i) v[i] = a3(t[i], t[i + 1], t[i + 2]);
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) pred[y][x] = v[x + y];
      return;
    }
    case 5: {
      const int p[4][4] = {{a2(X, A), a2(A, B), a2(B, C), a2(C, D)},
                           {a3(I, X, A), a3(X, A, B), a3(A, B, C), a3(B, C, D)},
                           {a3(J, I, X), a2(X, A), a2(A, B), a2(B, C)},
                           {a3(K, J, I), a3(I, X, A), a3(X, A, B), a3(A, B, C)}};
      std::memcpy(pred, p, sizeof(p));
      return;
    }
    case 7: {
      const int p[4][4] = {{a2(A, B), a2(B, C), a2(C, D), a2(D, E)},
                           {a3(A, B, C), a3(B, C, D), a3(C, D, E), a3(D, E, F)},
                           {a2(B, C), a2(C, D), a2(D, E), a3(E, F, G)},
                           {a3(B, C, D), a3(C, D, E), a3(D, E, F), a3(F, G, H)}};
      std::memcpy(pred, p, sizeof(p));
      return;
    }
    case 8: {
      const int p[4][4] = {{a2(I, X), a3(I, X, A), a3(X, A, B), a3(A, B, C)},
                           {a2(J, I), a3(J, I, X), a2(I, X), a3(I, X, A)},
                           {a2(K, J), a3(K, J, I), a2(J, I), a3(J, I, X)},
                           {a2(L, K), a3(L, K, J), a2(K, J), a3(K, J, I)}};
      std::memcpy(pred, p, sizeof(p));
      return;
    }
    default: {
      const int p[4][4] = {{a2(I, J), a3(I, J, K), a2(J, K), a3(J, K, L)},
                           {a2(J, K), a3(J, K, L), a2(K, L), a3(K, L, L)},
                           {a2(K, L), a3(K, L, L), L, L},
                           {L, L, L, L}};
      std::memcpy(pred, p, sizeof(p));
      return;
    }
  }
}

inline uint8_t clip1(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

struct Plane {
  std::vector<uint8_t> p;
  int w = 0, h = 0;
  uint8_t* at(int y, int x) { return p.data() + static_cast<long long>(y) * w + x; }
};

// utils/webp.py:_context and _pred_block, then the residuals added
void predict_block(Plane& P, int y0, int x0, int size, int mb_x, int mb_y, int mode,
                   const int32_t* res /* [n*n blocks][16] */) {
  int top[16], left[16];
  for (int i = 0; i < size; ++i) {
    top[i] = mb_y ? *P.at(y0 - 1, x0 + i) : 127;
    left[i] = mb_x ? *P.at(y0 + i, x0 - 1) : 129;
  }
  const int tl = !mb_y ? 127 : !mb_x ? 129 : *P.at(y0 - 1, x0 - 1);
  int dc = 0;
  if (mode == 0) {
    const int shift = size == 16 ? 5 : 4;
    long long st = 0, sl = 0;
    for (int i = 0; i < size; ++i) st += top[i], sl += left[i];
    if (mb_x && mb_y) dc = static_cast<int>((st + sl + (1 << (shift - 1))) >> shift);
    else if (mb_x) dc = static_cast<int>((sl + (1 << (shift - 2))) >> (shift - 1));
    else if (mb_y) dc = static_cast<int>((st + (1 << (shift - 2))) >> (shift - 1));
    else dc = 0x80;
  }
  const int n = size / 4;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x) {
      int pr;
      if (mode == 0) pr = dc;
      else if (mode == 1) {
        const int v = top[x] + left[y] - tl;
        pr = v < 0 ? 0 : v > 255 ? 255 : v;
      } else if (mode == 2) pr = top[x];
      else pr = left[y];
      const int32_t r = res[16 * ((y / 4) * n + x / 4) + 4 * (y % 4) + (x % 4)];
      *P.at(y0 + y, x0 + x) = clip1(pr + r);
    }
}

void reconstruct(const std::vector<MB>& mbs, const std::vector<int32_t>& res, int mb_w, int mb_h,
                 Plane& Y, Plane& U, Plane& V) {
  for (int mb_y = 0; mb_y < mb_h; ++mb_y)
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MB& mb = mbs[static_cast<size_t>(mb_y) * mb_w + mb_x];
      const int32_t* r = res.data() + (static_cast<long long>(mb_y) * mb_w + mb_x) * 384;
      const int y0 = 16 * mb_y, x0 = 16 * mb_x;
      if (mb.is_i4) {
        int w[17][21] = {};
        for (int i = 0; i < 16; ++i) {
          w[0][1 + i] = mb_y ? *Y.at(y0 - 1, x0 + i) : 127;
          w[1 + i][0] = mb_x ? *Y.at(y0 + i, x0 - 1) : 129;
        }
        w[0][0] = !mb_y ? 127 : !mb_x ? 129 : *Y.at(y0 - 1, x0 - 1);
        int tr[4];
        for (int k = 0; k < 4; ++k)
          tr[k] = !mb_y ? 127 : mb_x == mb_w - 1 ? *Y.at(y0 - 1, x0 + 15) : *Y.at(y0 - 1, x0 + 16 + k);
        for (int row : {0, 4, 8, 12})
          for (int k = 0; k < 4; ++k) w[row][17 + k] = tr[k];
        for (int nb = 0; nb < 16; ++nb) {
          const int by = 4 * (nb >> 2), bx = 4 * (nb & 3);
          int pred[4][4];
          pred4(w, by, bx, mb.modes[nb], pred);
          const int32_t* rb = r + 16 * nb;
          for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx) w[by + 1 + yy][bx + 1 + xx] = clip1(pred[yy][xx] + rb[4 * yy + xx]);
        }
        for (int yy = 0; yy < 16; ++yy)
          for (int xx = 0; xx < 16; ++xx) *Y.at(y0 + yy, x0 + xx) = static_cast<uint8_t>(w[1 + yy][1 + xx]);
      } else {
        predict_block(Y, y0, x0, 16, mb_x, mb_y, mb.modes[0], r);
      }
      predict_block(U, 8 * mb_y, 8 * mb_x, 8, mb_x, mb_y, mb.uv, r + 256);
      predict_block(V, 8 * mb_y, 8 * mb_x, 8, mb_x, mb_y, mb.uv, r + 320);
    }
}

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// utils/webp.py:_filter_edge at n positions: position i's p3..q3 at
// base + i * along + k * across for k = -4..3 (-2..1 for the simple filter)
void filter_edge(uint8_t* base, long long along, long long across, int n, int thresh, int ithresh,
                 int hev_t, int kind /* 0 simple, 1 mb, 2 inner */) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < n; ++i) {
    uint8_t* q = base + i * along;
    auto px = [&](int k) -> uint8_t& { return q[k * across]; };
    const int p1 = px(-2), p0 = px(-1), q0 = px(0), q1 = px(1);
    bool m = 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t2;
    bool hev = true;
    int p3 = 0, p2 = 0, q2 = 0, q3 = 0;
    if (kind) {
      p3 = px(-4), p2 = px(-3), q2 = px(2), q3 = px(3);
      m = m && std::abs(p3 - p2) <= ithresh && std::abs(p2 - p1) <= ithresh &&
          std::abs(p1 - p0) <= ithresh && std::abs(q3 - q2) <= ithresh &&
          std::abs(q2 - q1) <= ithresh && std::abs(q1 - q0) <= ithresh;
      hev = std::abs(p1 - p0) > hev_t || std::abs(q1 - q0) > hev_t;
    }
    if (!m) continue;
    if (hev) {  // DoFilter2
      const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
      const int a1 = sclip2((a + 4) >> 3), a2v = sclip2((a + 3) >> 3);
      px(-1) = clip1(p0 + a2v);
      px(0) = clip1(q0 - a1);
    } else if (kind == 2) {  // DoFilter4
      const int a = 3 * (q0 - p0);
      const int a1 = sclip2((a + 4) >> 3), a2v = sclip2((a + 3) >> 3), a3v = (a1 + 1) >> 1;
      px(-2) = clip1(p1 + a3v);
      px(-1) = clip1(p0 + a2v);
      px(0) = clip1(q0 - a1);
      px(1) = clip1(q1 - a3v);
    } else {  // DoFilter6
      const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
      const int a1 = (27 * a + 63) >> 7, a2v = (18 * a + 63) >> 7, a3v = (9 * a + 63) >> 7;
      px(-3) = clip1(p2 + a3v);
      px(-2) = clip1(p1 + a2v);
      px(-1) = clip1(p0 + a1);
      px(0) = clip1(q0 - a1);
      px(1) = clip1(q1 - a2v);
      px(2) = clip1(q2 - a3v);
    }
  }
}

void loop_filter(int filter_type, const std::vector<MB>& mbs, int mb_w, int mb_h, Plane& Y,
                 Plane& U, Plane& V) {
  const bool simple = filter_type == 1;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y)
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MB& mb = mbs[static_cast<size_t>(mb_y) * mb_w + mb_x];
      if (mb.limit == 0) continue;
      Plane* planes[3] = {&Y, &U, &V};
      const int np = simple ? 1 : 3;
      const int k_edge = simple ? 0 : 1, k_inner = simple ? 0 : 2;
      for (int pass = 0; pass < 4; ++pass) {
        const bool vertical_edge = pass < 2, mb_edge = pass % 2 == 0;
        if (mb_edge && (vertical_edge ? mb_x == 0 : mb_y == 0)) continue;
        if (!mb_edge && !mb.inner) continue;
        for (int pi = 0; pi < np; ++pi) {
          Plane& P = *planes[pi];
          const int n = pi ? 8 : 16, r = pi ? 8 * mb_y : 16 * mb_y, c = pi ? 8 * mb_x : 16 * mb_x;
          const int thresh = mb_edge ? mb.limit + 4 : mb.limit;
          const int kind = mb_edge ? k_edge : k_inner;
          for (int e = mb_edge ? 0 : 4; e < (mb_edge ? 1 : n); e += 4) {
            if (vertical_edge)
              filter_edge(P.at(r, c + e), P.w, 1, n, thresh, mb.ilevel, mb.hev, kind);
            else
              filter_edge(P.at(r + e, c), 1, P.w, n, thresh, mb.ilevel, mb.hev, kind);
          }
        }
      }
    }
}

// utils/webp.py:_upsample_pair for one output row: T, C chroma rows
void upsample_row(const uint8_t* T, const uint8_t* C, int width, bool top_row, int32_t* out) {
  auto vert = [&](int i) { return top_row ? (3 * T[i] + C[i] + 2) >> 2 : (3 * C[i] + T[i] + 2) >> 2; };
  out[0] = vert(0);
  const int pairs = (width - 1) >> 1;
  for (int x = 1; x <= pairs; ++x) {
    const int tl = T[x - 1], t = T[x], l = C[x - 1], uv = C[x];
    const int avg = tl + t + l + uv + 8;
    const int d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + uv)) >> 3;
    if (top_row) {
      out[2 * x - 1] = (d12 + tl) >> 1;
      out[2 * x] = (d03 + t) >> 1;
    } else {
      out[2 * x - 1] = (d03 + l) >> 1;
      out[2 * x] = (d12 + uv) >> 1;
    }
  }
  if (!(width & 1)) out[width - 1] = vert(pairs);
}

// utils/webp.py:_fancy_chroma, one output row at a time
void chroma_row(const Plane& P, int width, int height, int y, int32_t* out) {
  const int uh = (height + 1) / 2;
  auto row = [&](int k) { return P.p.data() + static_cast<long long>(k) * P.w; };
  if (y == 0) {
    upsample_row(row(0), row(0), width, true, out);
  } else if (!(height & 1) && y == height - 1) {
    upsample_row(row(uh - 1), row(uh - 1), width, true, out);
  } else {
    const int k = (y + 1) / 2;  // rows 2k - 1 (top) and 2k (bottom)
    upsample_row(row(k - 1), row(k), width, y & 1, out);
  }
}

inline int mh(int a, int k) { return (a * k) >> 8; }
inline uint8_t clip8(int v) { return (v & ~((256 << 6) - 1)) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255; }

// utils/webp.py:_vp8_rgb -> rgb [h][w][3]; hw_out the frame's (h, w)
void vp8_rgb(const uint8_t* data, long long n, const uint8_t* alpha, long long alpha_n,
             int* hw_out, std::vector<uint8_t>& rgb) {
  Header hd;
  std::vector<Bool> store;
  store.reserve(1);
  parse_header(data, n, hd, store);
  const int width = hd.width, height = hd.height;
  const int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
  std::vector<MB> mbs(static_cast<size_t>(mb_w) * mb_h);
  std::vector<int32_t> coefs(static_cast<size_t>(mb_w) * mb_h * 400, 0);
  std::vector<int> top_modes(4 * static_cast<size_t>(mb_w), 0), nz_top(mb_w, 0), nz_top_dc(mb_w, 0);
  const long long last = static_cast<long long>(hd.parts.size()) - 1;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    MB* row = mbs.data() + static_cast<size_t>(mb_y) * mb_w;
    parse_modes(*hd.br, hd, mb_w, top_modes, row);
    if (hd.br->eof) throw Fail{W_ENDS_PART0};
    Bool& tbr = hd.parts[mb_y & last];
    int nz_left[2] = {0, 0};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MB& mb = row[mb_x];
      bool zero;
      if (hd.use_skip && mb.skip) {
        nz_top[mb_x] = 0;
        if (!mb.is_i4) nz_top_dc[mb_x] = 0;
        nz_left[0] = 0;
        if (!mb.is_i4) nz_left[1] = 0;
        zero = true;
      } else {
        zero = residuals(tbr, hd, mb, &nz_top[mb_x], &nz_top_dc[mb_x], nz_left,
                         coefs.data() + (static_cast<size_t>(mb_y) * mb_w + mb_x) * 400);
      }
      if (hd.filter_type) {
        const int* fs = hd.fstrength[mb.seg][mb.is_i4];
        mb.limit = fs[0];
        mb.ilevel = fs[1];
        mb.hev = fs[2];
      }
      mb.inner = mb.is_i4 || !zero;
      if (tbr.eof) throw Fail{W_VP8_ENDS};
    }
  }
  if (alpha) alpha_check(alpha, alpha_n, width, height);
  std::vector<int32_t> res(static_cast<size_t>(mb_w) * mb_h * 384);
  for (size_t m = 0; m < mbs.size(); ++m)
    for (int b = 0; b < 24; ++b) idct(coefs.data() + m * 400 + 16 * b, res.data() + m * 384 + 16 * b);
  Plane Y{std::vector<uint8_t>(static_cast<size_t>(16 * mb_w) * 16 * mb_h), 16 * mb_w, 16 * mb_h};
  Plane U{std::vector<uint8_t>(static_cast<size_t>(8 * mb_w) * 8 * mb_h), 8 * mb_w, 8 * mb_h};
  Plane V{std::vector<uint8_t>(static_cast<size_t>(8 * mb_w) * 8 * mb_h), 8 * mb_w, 8 * mb_h};
  reconstruct(mbs, res, mb_w, mb_h, Y, U, V);
  if (hd.filter_type) loop_filter(hd.filter_type, mbs, mb_w, mb_h, Y, U, V);
  hw_out[0] = height;
  hw_out[1] = width;
  rgb.resize(static_cast<size_t>(width) * height * 3);
  std::vector<int32_t> ur(width), vr(width);
  for (int y = 0; y < height; ++y) {
    chroma_row(U, width, height, y, ur.data());
    chroma_row(V, width, height, y, vr.data());
    for (int x = 0; x < width; ++x) {
      const int yy = mh(*Y.at(y, x), 19077), u = ur[x], v = vr[x];
      uint8_t* o = rgb.data() + (static_cast<size_t>(y) * width + x) * 3;
      o[0] = clip8(yy + mh(v, 26149) - 14234);
      o[1] = clip8(yy - mh(u, 6419) - mh(v, 13320) + 8708);
      o[2] = clip8(yy + mh(u, 33050) - 17685);
    }
  }
}

// ---------------------------------------------------------------------------
// the container (utils/webp.py:_features, _store_frame, _demux)
// ---------------------------------------------------------------------------

struct Frame {
  long long x = 0, y = 0, width = 0, height = 0;
  long long alpha_start = -1, alpha_size = 0, image_start = -1, image_size = 0;
  bool complete = false;
  int num = 0;
};

void bomb_check(long long w, long long h) {
  if (w * h > kPillowMaxPixels) throw Fail{W_BOMB, w, h};
}

void features(const uint8_t* chunk, long long size, long long* w, long long* h) {
  if (size < 12) throw Fail{W_IMAGE_CHUNK_TRUNC};
  const uint8_t* data = chunk + 8;
  if (std::memcmp(chunk, "VP8 ", 4) == 0) {
    vp8_info(data, size - 8, le32(chunk + 4));
    *w = le24(data + 6) & 0x3FFF;
    *h = le24(data + 8) & 0x3FFF;
    return;
  }
  int iw, ih;
  vp8l_info(data, size - 8, &iw, &ih);
  *w = iw;
  *h = ih;
}

long long store_frame(const uint8_t* buf, long long pos, long long end, Frame& fr, int num,
                      long long min_size) {
  if (end - pos < 8 || end - pos < min_size) throw Fail{W_FRAME_TRUNC};
  int alpha_chunks = 0, image_chunks = 0;
  while (true) {
    const long long start = pos;
    const uint8_t* fourcc = buf + pos;
    const long long size = le32(buf + pos + 4);
    pos += 8;
    if (size > kMaxChunk) throw Fail{W_CHUNK_SIZE};
    const long long padded = size + (size & 1);
    if (padded > end - pos) throw Fail{W_CHUNK_PAST};
    const bool is_vp8 = std::memcmp(fourcc, "VP8 ", 4) == 0, is_vp8l = std::memcmp(fourcc, "VP8L", 4) == 0;
    if (is_vp8l && alpha_chunks) throw Fail{W_ALPH_VP8L};
    if (std::memcmp(fourcc, "ALPH", 4) == 0 && alpha_chunks == 0) {
      alpha_chunks = 1;
      fr.alpha_start = start;
      fr.alpha_size = 8 + padded;
      fr.num = num;
      pos += padded;
    } else if ((is_vp8 || is_vp8l) && image_chunks == 0) {
      long long w, h;
      features(buf + start, 8 + padded, &w, &h);
      image_chunks = 1;
      fr.image_start = start;
      fr.image_size = 8 + padded;
      fr.num = num;
      fr.width = w;
      fr.height = h;
      fr.complete = true;
      pos += padded;
    } else {
      return start;
    }
    if (pos == end) return pos;
    if (end - pos < 8) throw Fail{W_CHUNK_HEADER};
  }
}

// -> the canvas (w, h) and the first frame; *end_out the RIFF end
void demux(const uint8_t* data, long long n, long long* cw, long long* ch, Frame& first,
           long long* end_out) {
  if (n < 20) throw Fail{W_SHORT_FILE};
  if (std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4)) throw Fail{W_NOT_WEBP};
  const long long riff_size = le32(data + 4);
  if (riff_size < 12 || riff_size > kMaxChunk) throw Fail{W_RIFF_SIZE};
  const long long end = riff_size + 8;
  if (n < end) throw Fail{W_RIFF_TRUNC};
  *end_out = end;
  const uint8_t* buf = data;
  if (!std::memcmp(buf + 12, "VP8 ", 4) || !std::memcmp(buf + 12, "VP8L", 4)) {
    Frame fr;
    store_frame(buf, 12, end, fr, 1, 0);
    fr.alpha_start = -1;  // no VP8X: no alpha flag
    if (fr.width <= 0 || fr.height <= 0) throw Fail{W_NO_IMAGE};
    bomb_check(fr.width, fr.height);
    *cw = fr.width;
    *ch = fr.height;
    first = fr;
    return;
  }
  if (std::memcmp(buf + 12, "VP8X", 4)) throw Fail{W_FIRST_CHUNK};
  long long vsize = le32(buf + 16);
  if (vsize > kMaxChunk || vsize < 10) throw Fail{W_BAD_VP8X};
  vsize += vsize & 1;
  if (vsize > end - 20) throw Fail{W_VP8X_PAST};
  const int flags = buf[20];
  const long long w = 1 + le24(buf + 24), h = 1 + le24(buf + 27);
  if (w * h >= kMaxArea) throw Fail{W_CANVAS_LARGE};
  long long pos = 20 + vsize;
  if (end - pos < 8) throw Fail{W_NO_CHUNK_AFTER_VP8X};
  const bool animated = flags & 0x02;
  int anim_chunks = 0;
  std::vector<Frame> frames;
  while (true) {
    const long long start = pos;
    const uint8_t* fourcc = buf + pos;
    const long long size = le32(buf + pos + 4);
    pos += 8;
    if (size > kMaxChunk) throw Fail{W_CHUNK_SIZE};
    const long long padded = size + (size & 1);
    if (padded > end - pos) throw Fail{W_CHUNK_PAST};
    if (!std::memcmp(fourcc, "VP8X", 4)) throw Fail{W_SECOND_VP8X};
    if (!std::memcmp(fourcc, "ALPH", 4) || !std::memcmp(fourcc, "VP8 ", 4) ||
        !std::memcmp(fourcc, "VP8L", 4)) {
      if (anim_chunks || animated) throw Fail{W_IMAGE_IN_ANIM};
      if (!frames.empty()) throw Fail{W_SECOND_IMAGE};
      Frame fr;
      pos = store_frame(buf, start, end, fr, 1, 0);
      if (!(flags & 0x10)) fr.alpha_start = -1;
      frames.push_back(fr);
    } else if (!std::memcmp(fourcc, "ANIM", 4)) {
      if (padded < 6) throw Fail{W_BAD_ANIM};
      anim_chunks = 1;
      pos += padded;
    } else if (!std::memcmp(fourcc, "ANMF", 4)) {
      if (!anim_chunks) throw Fail{W_ANMF_BEFORE_ANIM};
      if (end - pos < 16 || padded < 16) throw Fail{W_BAD_ANMF};
      Frame fr;
      fr.x = 2 * static_cast<long long>(le24(buf + pos));
      fr.y = 2 * static_cast<long long>(le24(buf + pos + 3));
      const long long fw = 1 + le24(buf + pos + 6), fh = 1 + le24(buf + pos + 9);
      if (fw * fh >= kMaxArea) throw Fail{W_FRAME_LARGE};
      pos += 16;
      const long long at = pos;
      pos = store_frame(buf, pos, end, fr, static_cast<int>(frames.size()) + 1, padded - 16);
      if (pos - at > padded - 16) throw Fail{W_ANMF_PAST};
      if (animated && fr.num > 0) {
        if (!frames.empty() && !frames.back().complete) throw Fail{W_AFTER_INCOMPLETE};
        frames.push_back(fr);
      }
    } else {
      pos += padded;
    }
    if (pos == end) break;
    if (end - pos < 8) throw Fail{W_CHUNK_HEADER};
  }
  bomb_check(w, h);
  if (frames.empty()) throw Fail{W_NO_FRAME};
  if (flags & ~0x3E & 0xFF) throw Fail{W_FLAGS};
  for (const Frame& f : frames) {
    if (!animated && f.num > 1) throw Fail{W_FRAMES_IN_STILL};
    if (!f.complete) throw Fail{W_INCOMPLETE};
    if (f.alpha_start >= 0 && f.image_start >= 0 && f.alpha_start > f.image_start)
      throw Fail{W_ALPHA_AFTER};
    if (f.width <= 0 || f.height <= 0) throw Fail{W_EMPTY_FRAME};
    if (!animated) {
      if (f.x || f.y || f.width != w || f.height != h) throw Fail{W_SIZE_VS_CANVAS};
    } else if (f.x + f.width > w || f.y + f.height > h) {
      throw Fail{W_OUTSIDE_CANVAS};
    }
  }
  *cw = w;
  *ch = h;
  first = frames[0];
}

int decode(const uint8_t* data, long long n, uint8_t* out, long long out_bytes, long long* info) {
  long long cw, ch, end;
  Frame fr;
  demux(data, n, &cw, &ch, fr, &end);
  const uint8_t* image = data + fr.image_start + 8;
  const long long image_n = fr.image_size - 8;
  std::vector<uint8_t> rgb;
  int hw[2];
  if (!std::memcmp(data + fr.image_start, "VP8L", 4)) {
    int w, h;
    vp8l_info(image, image_n, &w, &h);
    std::vector<uint32_t> argb = vp8l_argb(image, image_n, w, h, true, nullptr);
    hw[0] = h;
    hw[1] = w;
    rgb.resize(static_cast<size_t>(w) * h * 3);
    for (size_t i = 0; i < argb.size(); ++i) {
      rgb[3 * i] = (argb[i] >> 16) & 0xFF;
      rgb[3 * i + 1] = (argb[i] >> 8) & 0xFF;
      rgb[3 * i + 2] = argb[i] & 0xFF;
    }
  } else {
    vp8_info(image, image_n, le32(data + fr.image_start + 4));
    const uint8_t* alpha = nullptr;
    long long alpha_n = 0;
    if (fr.alpha_start >= 0) {
      alpha = data + fr.alpha_start + 8;
      alpha_n = le32(data + fr.alpha_start + 4);
    }
    vp8_rgb(image, image_n, alpha, alpha_n, hw, rgb);
  }
  info[0] = ch;
  info[1] = cw;
  if (out == nullptr || out_bytes != 3 * cw * ch) return W_OUT_SIZE;
  std::memset(out, 0, static_cast<size_t>(out_bytes));
  for (long long y = 0; y < hw[0]; ++y)
    std::memcpy(out + ((fr.y + y) * cw + fr.x) * 3, rgb.data() + y * hw[1] * 3,
                static_cast<size_t>(hw[1]) * 3);
  return 0;
}

}  // namespace

extern "C" {

// The canvas height and width of a WEBP file (utils/webp.py:_demux) -> 0,
// or its error code.
int l2i_webp_dims(const uint8_t* data, long long n, int* hw) {
  try {
    long long cw, ch, end;
    Frame fr;
    demux(data, n, &cw, &ch, fr, &end);
    hw[0] = static_cast<int>(ch);
    hw[1] = static_cast<int>(cw);
    return 0;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return W_NOMEM;
  }
}

// utils/webp.py:webp_decode_rgb: WEBP bytes -> out, uint8 [height][width][3]
// (out_bytes = 3 height width). -> 0, or an error code (info its values
// where the message names some); W_OUT_SIZE with info = (height, width)
// when out does not fit the canvas.
int l2i_webp_decode(const uint8_t* data, long long n, uint8_t* out, long long out_bytes,
                    long long* info) {
  try {
    return decode(data, n, out, out_bytes, info);
  } catch (const Fail& f) {
    info[0] = f.a;
    info[1] = f.b;
    return f.code;
  } catch (const std::bad_alloc&) {
    return W_NOMEM;
  }
}

}  // extern "C"
