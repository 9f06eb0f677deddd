// Host C++ of the baseline JPEG decoder of utils/jpeg.py: the same
// function, bit for bit, on every input, with the same errors in the same
// order (the Python side turns each code into the Python version's message).
//
//   l2i_jpeg_decode_interval  <- _decode_interval: the Huffman decode of one
//                                restart interval, the same packed outputs
//   l2i_jpeg_dims             <- the first frame header's height and width
//   l2i_jpeg_decode           <- jpeg_decode_rgb: the markers and tables, each
//                                sequential scan through the interval decode
//                                above, each progressive one through
//                                progressive_interval (_progressive_interval),
//                                each arithmetic-coded one through
//                                arith_interval (_arith_interval), each
//                                lossless one through lossless_scan
//                                (_decode_lossless_scan, _undifference),
//                                _idct_islow, _upsample, _ycc_to_rgb,
//                                _ycck_to_cmyk and _cmyk_to_rgb
//
// This is host code, not a GPU kernel: nvcc hands it to the host compiler,
// and it links into the same library as the kernels (ops/_build.py). One
// call decodes one photo, touching only the buffers it is given and its
// thread's own scratch (thread_local, reused, so a thread in the loader's
// pool (utils/loader.py) faults no new pages per photo); ctypes releases
// the GIL around it, so the pool's threads decode in parallel. Integer
// arithmetic is int64 throughout, as the numpy version computes it; >> on a
// negative value is an arithmetic shift, as in numpy.
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// error codes; the payload (info[0]) where the message names a value
enum Err {
  E_NOT_JPEG = -10, E_REFUSE_SOF = -11, E_REFUSE_DAC = -12, E_SEGMENT = -13,
  E_SECOND_FRAME = -14, E_SHORT_SOF = -15, E_PRECISION = -16, E_NCOMP = -18, E_DNL = -19, E_BAD_SOF = -20, E_SAMPLING = -21,
  E_FRACTIONAL = -22, E_BAD_DHT = -23, E_BAD_DQT = -24, E_SCAN_NO_FRAME = -25,
  E_BAD_SOS = -26, E_SCAN_COMPONENT = -27, E_UNDEF_HUFF = -28,
  E_UNDEF_QUANT = -29, E_BAD_HUFF_TABLE = -30, E_SPECTRAL = -31,
  E_FEW_INTERVALS = -32, E_INVALID_CODE = -33, E_SCAN_TRUNC = -34,
  E_COEF_PAST = -35, E_NO_SCAN = -36, E_OUT_SIZE = -37, E_NOMEM = -38,
  E_BAD_PROGRESSION = -39, E_PROG_NO_EOI = -40,
  E_BAD_DAC = -42, E_PILLOW_BLOCK = -43, E_MARKER = -44, E_BAD_DRI = -45, E_BOMB = -46,
  E_BAD_LOSSLESS = -47, E_BAD_RESTART = -48, E_LOSSLESS_YCC = -49, E_LOSSLESS_YCCK = -50,
  E_LOSSLESS_NO_EOI = -51, E_LIBJPEG = -52,
};
// utils/jpeg.py:PILLOW_MAX_PIXELS, Pillow's DecompressionBombError limit
constexpr long long kPillowMaxPixels = 2LL * (1024 * 1024 * 1024 / 4 / 3);

// the JPEG EXTEND of `size` value bits
inline int64_t extend(int64_t bits, int size) {
  return bits < (int64_t(1) << (size - 1)) ? bits - (int64_t(1) << size) + 1 : bits;
}

// zigzag position -> natural (row-major) index (utils/jpeg.py:_ZIGZAG)
const int kZigzagNatural[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// natural (row-major) index -> zigzag position (utils/jpeg.py:_UNZIGZAG)
const int kUnzigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// The Huffman decode of one restart interval (utils/jpeg.py:_decode_interval)
// -> the bits used; -1 where it reads past the padded words (the Python
// version's IndexError), -2 at an invalid code.
// limit >= 0: libjpeg's run out of data (utils/jpeg.py:_fill_intervals): no
// MCU of per_mcu blocks starts once more than `limit` bits are used; *n_done
// the blocks decoded.
long long decode_interval(const uint8_t* data, long long n_bytes, const long long* blocks,
                          const int* comps, long long n_blocks, const int* const* dc_luts,
                          const int* const* ac_luts, long long* out_ac, long long* n_ac,
                          long long* out_dc, int64_t* preds, long long per_mcu = 1,
                          long long limit = -1, long long* n_done = nullptr) {
  const long long n_words = n_bytes / 4;
  uint64_t buf = 0;
  long long nb = 0, wi = 0, na = 0;
  const int64_t one = int64_t(1) << 16, end = int64_t(64) << 16;
#define L2I_REFILL()                                                           \
  if (nb < 32) {                                                               \
    if (wi >= n_words) return -1;                                              \
    const uint8_t* w = data + 4 * wi;                                          \
    uint64_t word = (uint64_t(w[0]) << 24) | (uint64_t(w[1]) << 16) |          \
                    (uint64_t(w[2]) << 8) | uint64_t(w[3]);                    \
    buf = ((buf & ((uint64_t(1) << nb) - 1)) << 32) | word;                    \
    wi += 1;                                                                   \
    nb += 32;                                                                  \
  }
  long long i = 0;
  for (; i < n_blocks; ++i) {
    if (limit >= 0 && i % per_mcu == 0 && wi * 32 - nb > limit) break;
    const int ci = comps[i];
    L2I_REFILL();
    const int* d = dc_luts[ci] + 2 * ((buf >> (nb - 16)) & 0xFFFF);
    int64_t n = d[0], v = d[1];
    if (n > 0) {
      nb -= n;
    } else if (n < 0) {
      nb += n;
      if (v) {
        nb -= v;
        v = extend(static_cast<int64_t>((buf >> nb) & ((uint64_t(1) << v) - 1)),
                   static_cast<int>(v));
      }
    } else {
      return -2;
    }
    preds[ci] += v;
    out_dc[i] = preds[ci];
    const int* acl = ac_luts[ci];
    const int64_t bk = static_cast<int64_t>(blocks[i]) << 23;
    int64_t kk = one;
    while (kk < end) {
      L2I_REFILL();
      const int* a = acl + 3 * ((buf >> (nb - 16)) & 0xFFFF);
      int64_t an = a[0], r = a[1], av = a[2];
      if (an > 0) {
        nb -= an;
        if (r < 0) break;
        kk += r;
        if (av) out_ac[na++] = bk + kk + av;
        kk += one;
      } else if (an < 0) {
        nb += an - av;
        int64_t bits = static_cast<int64_t>((buf >> nb) & ((uint64_t(1) << av) - 1));
        kk += r;
        out_ac[na++] = bk + kk + (extend(bits, static_cast<int>(av)) & 0xFFFF);
        kk += one;
      } else {
        return -2;
      }
    }
  }
#undef L2I_REFILL
  *n_ac = na;
  if (n_done) *n_done = i;
  return wi * 32 - nb;
}

// ---------------------------------------------------------------------------
// Huffman lookup tables (utils/jpeg.py:_lut_rows), cached per thread
// ---------------------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  uint8_t counts[16] = {};
  std::vector<uint8_t> symbols;
};

// the tables built by this thread, by (DC or AC, counts, symbols); emptied
// between photos only (decode), so the pointers a scan holds stay valid
thread_local std::unordered_map<std::string, std::vector<int>> lut_cache;

// The canonical Huffman code of t (jdhuff.c's jpeg_make_d_derived_tbl):
// (code length, symbol) of every 16-bit window, length 0 where no code
// starts -> false for a bad table.
bool code_windows(const HuffTable& t, bool dc, std::vector<int>& length,
                  std::vector<int>& symbol) {
  if (dc)
    for (uint8_t s : t.symbols)
      if (s > 15) return false;  // jdhuff.c: a DC size past 15
  length.assign(1 << 16, 0);
  symbol.assign(1 << 16, 0);
  int64_t code = 0;
  size_t i = 0;
  for (int n_bits = 1; n_bits <= 16; ++n_bits) {
    for (int c = 0; c < t.counts[n_bits - 1]; ++c) {
      if (code >= (int64_t(1) << n_bits)) return false;
      const int64_t lo = code << (16 - n_bits);
      for (int64_t w = lo; w < lo + (int64_t(1) << (16 - n_bits)); ++w) {
        length[w] = n_bits;
        symbol[w] = t.symbols[i];
      }
      ++code;
      ++i;
    }
    code <<= 1;
  }
  return true;
}

std::string table_key(char kind, const HuffTable& t) {
  std::string key(1, kind);
  key.append(reinterpret_cast<const char*>(t.counts), 16);
  key.append(t.symbols.begin(), t.symbols.end());
  return key;
}

// -> the table's rows [65536][2 | 3], or nullptr for a bad table
const int* lut_rows(const HuffTable& t, bool dc) {
  const std::string key = table_key(dc ? 'd' : 'a', t);
  auto hit = lut_cache.find(key);
  if (hit != lut_cache.end()) return hit->second.data();
  std::vector<int> length, symbol;
  if (!code_windows(t, dc, length, symbol)) return nullptr;
  const int width = dc ? 2 : 3;
  std::vector<int> rows(size_t(1 << 16) * width);
  for (int w = 0; w < (1 << 16); ++w) {
    const int len = length[w], sym = symbol[w];
    const int size = dc ? sym : (sym & 15);
    const bool fits = len + size <= 16;
    const int shift = 16 - len - size > 0 ? 16 - len - size : 0;
    int64_t value = 0;
    if (size > 0) value = extend((int64_t(w) >> shift) & ((int64_t(1) << size) - 1), size);
    const int n = len == 0 ? 0 : (fits ? len + size : -len);
    int* r = rows.data() + size_t(w) * width;
    r[0] = n;
    if (dc) {
      r[1] = static_cast<int>(fits ? value : size);
    } else {
      int run = sym >> 4;
      run = size == 0 ? (run == 15 ? 15 : -1) : run;
      r[1] = run * 65536;
      r[2] = static_cast<int>(fits ? (value & 0xFFFF) : size);
    }
  }
  return lut_cache.emplace(key, std::move(rows)).first->second.data();
}

// The progressive decoder's table (utils/jpeg.py:_sym_lut): (code length,
// symbol) for every 16-bit window [65536][2], length 0 where no code
// starts; nullptr for a bad table.
const int* sym_rows(const HuffTable& t, bool dc) {
  const std::string key = table_key(dc ? 'D' : 'A', t);
  auto hit = lut_cache.find(key);
  if (hit != lut_cache.end()) return hit->second.data();
  std::vector<int> length, symbol;
  if (!code_windows(t, dc, length, symbol)) return nullptr;
  std::vector<int> rows(size_t(1 << 16) * 2);
  for (int w = 0; w < (1 << 16); ++w) {
    rows[2 * w] = length[w];
    rows[2 * w + 1] = symbol[w];
  }
  return lut_cache.emplace(key, std::move(rows)).first->second.data();
}

// A lossless scan's table (utils/jpeg.py:_diff_lut): (code length,
// category) for every 16-bit window [65536][2]; categories run to 16.
const int* diff_rows(const HuffTable& t) {
  for (uint8_t sym : t.symbols)
    if (sym > 16) return nullptr;
  const std::string key = table_key('L', t);
  auto hit = lut_cache.find(key);
  if (hit != lut_cache.end()) return hit->second.data();
  std::vector<int> length, symbol;
  if (!code_windows(t, false, length, symbol)) return nullptr;
  std::vector<int> rows(size_t(1 << 16) * 2);
  for (int w = 0; w < (1 << 16); ++w) {
    rows[2 * w] = length[w];
    rows[2 * w + 1] = symbol[w];
  }
  return lut_cache.emplace(key, std::move(rows)).first->second.data();
}

// ---------------------------------------------------------------------------
// progressive scans (utils/jpeg.py:_Bits, _progressive_interval)
// ---------------------------------------------------------------------------

// The bit reader of one restart interval: unstuffed bytes read as
// big-endian 32-bit words (zero-padded); a read past them fails.
struct Bits {
  const uint8_t* data;
  long long n_words, wi = 0, nb = 0;
  uint64_t buf = 0;
  bool past = false, bad_code = false;
  bool refill() {
    if (nb >= 32) return true;
    if (wi >= n_words) return !(past = true);
    const uint8_t* w = data + 4 * wi;
    const uint64_t word = (uint64_t(w[0]) << 24) | (uint64_t(w[1]) << 16) |
                          (uint64_t(w[2]) << 8) | uint64_t(w[3]);
    buf = ((buf & ((uint64_t(1) << nb) - 1)) << 32) | word;
    wi += 1;
    nb += 32;
    return true;
  }
  // n in [1, 16] bits; false once a read fails
  bool get(int n, int64_t* v) {
    if (!refill()) return false;
    nb -= n;
    *v = static_cast<int64_t>((buf >> nb) & ((uint64_t(1) << n) - 1));
    return true;
  }
  bool huff(const int* lut, int* sym) {
    if (!refill()) return false;
    const int* e = lut + 2 * ((buf >> (nb - 16)) & 0xFFFF);
    if (!e[0]) return !(bad_code = true);
    nb -= e[0];
    *sym = e[1];
    return true;
  }
  long long used() const { return wi * 32 - nb; }
};

inline int16_t w16(int64_t v) {  // a JCOEF: int16, wrapping
  return static_cast<int16_t>(static_cast<uint16_t>(static_cast<uint64_t>(v)));
}

// One restart interval of a progressive scan into coef (every block's 64
// coefficients in zigzag order): jdphuff.c's decode_mcu_DC_first,
// _DC_refine, _AC_first and _AC_refine. -> false where a read fails (see
// rd.past / rd.bad_code).
// limit >= 0: as decode_interval's; *last the index of the last block
// started.
bool progressive_interval(Bits& rd, const long long* blocks, const int* comps, long long n_blocks,
                          const int* const* luts, int16_t* coef, int ss, int se, int ah, int al,
                          long long per_mcu = 1, long long limit = -1, long long* last = nullptr) {
  int64_t v;
  int sym;
#define L2I_MCU_START()                                                     \
  if (limit >= 0 && i % per_mcu == 0 && rd.used() > limit) return true; \
  if (last) *last = i;
  if (ss == 0 && ah == 0) {  // DC first
    int64_t preds[4] = {0, 0, 0, 0};  // ns <= fr.n <= 4: decode_progressive_scan
    for (long long i = 0; i < n_blocks; ++i) {
      L2I_MCU_START();
      const int ci = comps[i];
      if (!rd.huff(luts[ci], &sym)) return false;
      int64_t diff = 0;
      if (sym) {
        if (!rd.get(sym, &v)) return false;
        diff = extend(v, sym);
      }
      preds[ci] += diff;
      coef[blocks[i] * 64] = w16(preds[ci] * (int64_t(1) << al));
    }
    return true;
  }
  if (ss == 0) {  // DC refine: one bit a block
    const int p1 = 1 << al;
    for (long long i = 0; i < n_blocks; ++i) {
      L2I_MCU_START();
      if (!rd.get(1, &v)) return false;
      if (v) coef[blocks[i] * 64] = static_cast<int16_t>(coef[blocks[i] * 64] | p1);
    }
    return true;
  }
  const int* lut = luts[0];
  int64_t eobrun = 0;
  if (ah == 0) {  // AC first
    for (long long i = 0; i < n_blocks; ++i) {
      L2I_MCU_START();
      if (eobrun) {
        --eobrun;
        continue;
      }
      int16_t* b = coef + blocks[i] * 64;
      for (int k = ss; k <= se; ++k) {
        if (!rd.huff(lut, &sym)) return false;
        const int r = sym >> 4, size = sym & 15;
        if (size) {
          k += r;
          if (!rd.get(size, &v)) return false;
          b[k < 63 ? k : 63] = w16(extend(v, size) * (int64_t(1) << al));
        } else if (r == 15) {  // ZRL
          k += 15;
        } else {  // EOBr
          eobrun = int64_t(1) << r;
          if (r) {
            if (!rd.get(r, &v)) return false;
            eobrun += v;
          }
          --eobrun;
          break;
        }
      }
    }
    return true;
  }
  const int p1 = 1 << al, m1 = -p1;  // AC refine
  for (long long i = 0; i < n_blocks; ++i) {
    L2I_MCU_START();
    int16_t* b = coef + blocks[i] * 64;
    int k = ss;
    if (!eobrun) {
      for (; k <= se; ++k) {
        if (!rd.huff(lut, &sym)) return false;
        int r = sym >> 4, size = sym & 15;
        if (size) {  // a newly nonzero coefficient (size 1; libjpeg warns on others)
          if (!rd.get(1, &v)) return false;
          size = v ? p1 : m1;
        } else if (r != 15) {
          eobrun = int64_t(1) << r;
          if (r) {
            if (!rd.get(r, &v)) return false;
            eobrun += v;
          }
          break;
        }
        // past r zero-history coefficients, correcting the nonzero ones
        while (true) {
          const int16_t c = b[k];
          if (c) {
            if (!rd.get(1, &v)) return false;
            if (v && !(c & p1)) b[k] = w16(int64_t(c) + (c >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          if (++k > se) break;
        }
        if (size) b[k < 63 ? k : 63] = static_cast<int16_t>(size);
      }
    }
    if (eobrun) {  // the end-of-band run: correction bits only
      for (; k <= se; ++k) {
        const int16_t c = b[k];
        if (c) {
          if (!rd.get(1, &v)) return false;
          if (v && !(c & p1)) b[k] = w16(int64_t(c) + (c >= 0 ? p1 : m1));
        }
      }
      --eobrun;
    }
  }
#undef L2I_MCU_START
  return true;
}

// ---------------------------------------------------------------------------
// IDCT, upsampling, colour (utils/jpeg.py:_idct_islow, _upsample,
// _ycc_to_rgb)
// ---------------------------------------------------------------------------

// jidctint.c's 1-D ISLOW stage, as utils/jpeg.py:_islow_butterfly
inline void islow_butterfly(const int64_t* c, int64_t* o) {
  int64_t z1 = (c[2] + c[6]) * 4433;
  int64_t tmp2 = z1 + c[6] * -15137;
  int64_t tmp3 = z1 + c[2] * 6270;
  // << 13 of numpy's int64, written as a product (a left shift of a negative
  // value is undefined in C++17)
  int64_t tmp0 = (c[0] + c[4]) * 8192;
  int64_t tmp1 = (c[0] - c[4]) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = c[7], t1 = c[5], t2 = c[3], t3 = c[1];
  int64_t a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  int64_t z5 = (a3 + a4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  a1 *= -7373;
  a2 *= -20995;
  a3 = a3 * -16069 + z5;
  a4 = a4 * -3196 + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  o[0] = tmp10 + t3;
  o[1] = tmp11 + t2;
  o[2] = tmp12 + t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
  o[5] = tmp12 - t1;
  o[6] = tmp11 - t2;
  o[7] = tmp10 - t3;
}

// libjpeg's post-IDCT range limit indexed by (value & 1023)
inline uint8_t range_limit(int64_t v) {
  int i = static_cast<int>(v & 1023);
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

// Dequantise and inverse-transform a component's bh x bw blocks (64 int16
// coefficients each in zigzag order, block raster order) into its plane
// [bh * 8][bw * 8]; quant: the 64 steps in natural order.
void idct_plane(const int16_t* coef, const int64_t* quant, int bh, int bw, uint8_t* plane) {
  const long long stride = static_cast<long long>(bw) * 8;
  for (long long b = 0; b < static_cast<long long>(bh) * bw; ++b) {
    const int16_t* cz = coef + 64 * b;
    int64_t c[64], ws[64], col[8], res[8];
    for (int k = 0; k < 64; ++k) c[k] = static_cast<int64_t>(cz[kUnzigzag[k]]) * quant[k];
    for (int x = 0; x < 8; ++x) {  // pass 1: each column; DESCALE(, 11)
      for (int k = 0; k < 8; ++k) col[k] = c[8 * k + x];
      islow_butterfly(col, res);
      for (int k = 0; k < 8; ++k) ws[8 * k + x] = (res[k] + 1024) >> 11;
    }
    uint8_t* out = plane + (b / bw) * 8 * stride + (b % bw) * 8;
    for (int y = 0; y < 8; ++y) {  // pass 2: each row; DESCALE(, 18)
      islow_butterfly(ws + 8 * y, res);
      for (int k = 0; k < 8; ++k)
        out[y * stride + k] = range_limit((res[k] + (int64_t(1) << 17)) >> 18);
    }
  }
}

// One component's valid samples p [h][w] (row stride `stride`) upsampled by
// (fh, fv) as jdsample.c does with fancy upsampling on, cropped to
// [out_h][out_w], written with a step of `step` bytes between samples.
void upsample(const uint8_t* p, long long stride, int h, int w, int fh, int fv, int out_h,
              int out_w, uint8_t* out, int step) {
  auto at = [&](int y, int x) -> int {
    y = y < 0 ? 0 : (y >= h ? h - 1 : y);
    x = x < 0 ? 0 : (x >= w ? w - 1 : x);
    return p[y * stride + x];
  };
  const bool fancy = (fh == 2 && fv == 1) || (fh == 1 && fv == 2) || (fh == 2 && fv == 2);
  const bool box = fh == 2 && (fv == 1 || fv == 2) && w <= 2;  // h2v1_/h2v2_upsample
  for (int oy = 0; oy < out_h; ++oy) {
    uint8_t* o = out + static_cast<long long>(oy) * out_w * step;
    if (!fancy || box) {  // a copy (1, 1), box or int_upsample: replication
      const int y = oy / fv;
      for (int ox = 0; ox < out_w; ++ox) o[ox * step] = static_cast<uint8_t>(at(y, ox / fh));
    } else if (fv == 1) {  // h2v1_fancy_upsample
      for (int ox = 0; ox < out_w; ++ox) {
        const int x = ox >> 1, s = 3 * at(oy, x);
        o[ox * step] = static_cast<uint8_t>((ox & 1) ? (s + at(oy, x + 1) + 2) >> 2
                                                     : (s + at(oy, x - 1) + 1) >> 2);
      }
    } else if (fh == 1) {  // h1v2_fancy_upsample
      const int y = oy >> 1;
      for (int ox = 0; ox < out_w; ++ox) {
        const int s = 3 * at(y, ox);
        o[ox * step] = static_cast<uint8_t>((oy & 1) ? (s + at(y + 1, ox) + 2) >> 2
                                                     : (s + at(y - 1, ox) + 1) >> 2);
      }
    } else {  // h2v2_fancy_upsample: the row above or below as context
      const int y = oy >> 1, ny = (oy & 1) ? y + 1 : y - 1;
      auto cs = [&](int x) { return 3 * at(y, x) + at(ny, x); };
      for (int ox = 0; ox < out_w; ++ox) {
        const int x = ox >> 1, c = 3 * cs(x);
        o[ox * step] = static_cast<uint8_t>((ox & 1) ? (c + cs(x + 1) + 7) >> 4
                                                     : (c + cs(x - 1) + 8) >> 4);
      }
    }
  }
}

inline int fix(double x) { return static_cast<int>(x * 65536 + 0.5); }

// jdcolor.c's ycc_rgb_convert, in place on interleaved [n][3] samples
void ycc_rgb(uint8_t* px, long long n) {
  static int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  static const bool ready = [] {
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + half) >> 16;
      cb_b[i] = (fix(1.77200) * x + half) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    return true;
  }();
  (void)ready;
  auto clip = [](int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (long long i = 0; i < n; ++i) {
    uint8_t* q = px + 3 * i;
    const int64_t y = q[0];
    const int cb = q[1], cr = q[2];
    q[0] = clip(y + cr_r[cr]);
    q[1] = clip(y + ((cb_g[cb] + cr_g[cr]) >> 16));
    q[2] = clip(y + cb_b[cb]);
  }
}

// ---------------------------------------------------------------------------
// the file (utils/jpeg.py:jpeg_decode_rgb, _Frame, _decode_scan,
// _scan_blocks, _assemble)
// ---------------------------------------------------------------------------

struct Frame {
  int height = 0, width = 0, n = 0, hmax = 0, vmax = 0, mcux = 0, mcuy = 0;
  bool progressive = false, arith = false, lossless = false;
  int unit = 8, per = 64;  // a data unit: an 8 x 8 block, or one lossless sample
  int coef_bits[4][64];
  std::vector<std::vector<int32_t>> samples;  // lossless: each component's values
  int pt[4] = {0, 0, 0, 0};  // progressive: each coefficient's Al so far, -1 unscanned
  std::vector<int> ids, h, v, tq, bw, bh;
  std::vector<long long> offset;  // in coefficients
  std::vector<bool> scanned;
  std::vector<std::vector<int64_t>> quant;  // empty: not latched yet
  // libjpeg mode (utils/jpeg.py:_decode_libjpeg): libjpeg-turbo 2.1's Al
  // values before each component's last scan, the last iMCU row decoded
  // with data (-1: every row), the scans started
  bool libjpeg = false;
  int prev_bits[4][64];
  long long last_good = -1;
  int scans = 0;
  int dw(int c) const { return static_cast<int>((int64_t(width) * h[c] + hmax - 1) / hmax); }
  int dh(int c) const { return static_cast<int>((int64_t(height) * v[c] + vmax - 1) / vmax); }
  int index_of(int cid) const {
    for (int i = 0; i < n; ++i)
      if (ids[i] == cid) return i;
    return -1;
  }
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// an SOS segment's length and components as libjpeg checks them: at most
// 4 components, each named once, and no byte more or less
struct Frame;
bool valid_sos(const Frame& fr, const uint8_t* body, long long blen, int ns);

int parse_frame(const uint8_t* body, long long blen, Frame& fr, long long* info) {
  if (blen < 6) return E_SHORT_SOF;
  const int precision = body[0];
  fr.height = be16(body + 1);
  fr.width = be16(body + 3);
  fr.n = body[5];
  if (precision != 8) return info[0] = precision, E_PRECISION;
  if (fr.n != 1 && fr.n != 3 && fr.n != 4) return info[0] = fr.n, E_NCOMP;
  if (fr.height == 0) return E_DNL;
  if (fr.width == 0 || blen != 6 + 3 * fr.n) return E_BAD_SOF;
  for (int i = 0; i < fr.n; ++i) {
    const uint8_t* c = body + 6 + 3 * i;
    if (!(1 <= (c[1] >> 4) && (c[1] >> 4) <= 4 && 1 <= (c[1] & 15) && (c[1] & 15) <= 4))
      return E_SAMPLING;
    fr.ids.push_back(c[0]);
    fr.h.push_back(c[1] >> 4);
    fr.v.push_back(c[1] & 15);
    fr.tq.push_back(c[2]);
  }
  fr.hmax = fr.vmax = 0;
  for (int i = 0; i < fr.n; ++i) {
    fr.hmax = fr.h[i] > fr.hmax ? fr.h[i] : fr.hmax;
    fr.vmax = fr.v[i] > fr.vmax ? fr.v[i] : fr.vmax;
  }
  for (int i = 0; i < fr.n; ++i)
    if (fr.hmax % fr.h[i] || fr.vmax % fr.v[i]) return E_FRACTIONAL;
  if (fr.libjpeg) {  // JPEG_MAX_DIMENSION; no 4-component to RGB conversion
    if (fr.width > 65500 || fr.height > 65500 || fr.n == 4) return E_LIBJPEG;
  } else if (static_cast<long long>(fr.width) * fr.height > kPillowMaxPixels) {
    return info[0] = (static_cast<long long>(fr.height) << 16) | fr.width, E_BOMB;
  }
  fr.mcux = (fr.width + fr.unit * fr.hmax - 1) / (fr.unit * fr.hmax);
  fr.mcuy = (fr.height + fr.unit * fr.vmax - 1) / (fr.unit * fr.vmax);
  fr.offset.assign(1, 0);
  for (int i = 0; i < fr.n; ++i) {
    fr.bw.push_back(fr.mcux * fr.h[i]);
    fr.bh.push_back(fr.mcuy * fr.v[i]);
    fr.offset.push_back(fr.offset.back() + static_cast<long long>(fr.bw[i]) * fr.bh[i] * fr.per);
  }
  fr.samples.assign(fr.n, {});
  fr.scanned.assign(fr.n, false);
  fr.quant.assign(fr.n, {});
  for (auto& bits : fr.coef_bits)
    for (int& b : bits) b = -1;
  for (auto& bits : fr.prev_bits)
    for (int& b : bits) b = 0;
  return 0;
}

bool valid_sos(const Frame& fr, const uint8_t* body, long long blen, int ns) {
  if (ns < 1 || ns > fr.n || blen != 4 + 2 * ns) return false;
  for (int i = 0; i < ns; ++i)
    for (int j = 0; j < i; ++j)
      if (body[1 + 2 * i] == body[1 + 2 * j]) return false;
  return true;
}

inline int64_t w16a(int64_t v) { return ((v + 32768) & 0xFFFF) - 32768; }

// utils/jpeg.py:_simd_butterfly: islow_butterfly with c0 + c4, c0 - c4,
// c7 + c3 and c5 + c1 added in 16 bits, wrapping, as libjpeg-turbo's SSE2
// and AVX2 ISLOW compute them
inline void simd_butterfly(const int64_t* c, int64_t* o) {
  const int64_t s04 = w16a(c[0] + c[4]), d04 = w16a(c[0] - c[4]);
  int64_t z3 = w16a(c[7] + c[3]), z4 = w16a(c[5] + c[1]);
  const int64_t z1 = (c[2] + c[6]) * 4433;
  const int64_t tmp2 = z1 + c[6] * -15137, tmp3 = z1 + c[2] * 6270;
  const int64_t tmp0 = s04 * 8192, tmp1 = d04 * 8192;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t t0 = c[7], t1 = c[5], t2 = c[3], t3 = c[1];
  const int64_t z5 = (z3 + z4) * 9633;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  const int64_t u0 = t0 * 2446 + (t0 + t3) * -7373 + z3;
  const int64_t u1 = t1 * 16819 + (t1 + t2) * -20995 + z4;
  const int64_t u2 = t2 * 25172 + (t1 + t2) * -20995 + z3;
  const int64_t u3 = t3 * 12299 + (t0 + t3) * -7373 + z4;
  o[0] = tmp10 + u3; o[7] = tmp10 - u3;
  o[1] = tmp11 + u2; o[6] = tmp11 - u2;
  o[2] = tmp12 + u1; o[5] = tmp12 - u1;
  o[3] = tmp13 + u0; o[4] = tmp13 - u0;
}

inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) { return v < lo ? lo : v > hi ? hi : v; }

// utils/jpeg.py:_idct_islow_simd: idct_plane as libjpeg-turbo 2.1 computes
// it on x86-64 (16-bit dequantisation, pass 1's DC shortcut where rows 1-7
// are zero, int16 saturation after each pass, [-128, 127] before the +128)
void idct_plane_simd(const int16_t* coef, const int64_t* quant, int bh, int bw, uint8_t* plane) {
  const long long stride = static_cast<long long>(bw) * 8;
  for (long long b = 0; b < static_cast<long long>(bh) * bw; ++b) {
    const int16_t* cz = coef + 64 * b;
    int64_t raw[64], c[64], ws[64], col[8], res[8];
    bool ac_rows = false;
    for (int k = 0; k < 64; ++k) {
      raw[k] = cz[kUnzigzag[k]];
      c[k] = w16a(raw[k] * quant[k]);
      ac_rows = ac_rows || (k >= 8 && raw[k] != 0);
    }
    for (int x = 0; x < 8; ++x) {
      if (!ac_rows) {
        for (int k = 0; k < 8; ++k) ws[8 * k + x] = w16a(c[x] * 4);
        continue;
      }
      for (int k = 0; k < 8; ++k) col[k] = c[8 * k + x];
      simd_butterfly(col, res);
      for (int k = 0; k < 8; ++k) ws[8 * k + x] = clampi((res[k] + 1024) >> 11, -32768, 32767);
    }
    uint8_t* out = plane + (b / bw) * 8 * stride + (b % bw) * 8;
    for (int y = 0; y < 8; ++y) {
      simd_butterfly(ws + 8 * y, res);
      for (int k = 0; k < 8; ++k)
        out[y * stride + k] =
            static_cast<uint8_t>(clampi((res[k] + (int64_t(1) << 17)) >> 18, -128, 127) + 128);
    }
  }
}

struct Scratch {  // per thread, reused from photo to photo
  std::vector<int16_t> coef;
  std::vector<long long> blk, out_ac, out_dc;
  std::vector<int> sel;
  std::vector<uint8_t> raw, plane, four;
};

// The blocks of a scan in decode order (utils/jpeg.py:_scan_blocks) into
// s.blk (block numbers) and s.sel (component index in the scan) -> the
// blocks per MCU.
long long scan_blocks(const Frame& fr, const std::vector<int>& comps, Scratch& s) {
  s.blk.clear();
  s.sel.clear();
  const int ns = static_cast<int>(comps.size());
  if (ns == 1) {  // non-interleaved: the component's own block raster
    const int c = comps[0];
    const int nby = (fr.dh(c) + fr.unit - 1) / fr.unit, nbx = (fr.dw(c) + fr.unit - 1) / fr.unit;
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx) {
        s.blk.push_back(fr.offset[c] / fr.per + static_cast<long long>(by) * fr.bw[c] + bx);
        s.sel.push_back(0);
      }
    return 1;
  }
  long long per_mcu = 0;
  for (int c : comps) per_mcu += static_cast<long long>(fr.v[c]) * fr.h[c];
  for (int my = 0; my < fr.mcuy; ++my)
    for (int mx = 0; mx < fr.mcux; ++mx)
      for (int i = 0; i < ns; ++i) {
        const int c = comps[i];
        for (int yy = 0; yy < fr.v[c]; ++yy)
          for (int xx = 0; xx < fr.h[c]; ++xx) {
            s.blk.push_back(fr.offset[c] / fr.per +
                            (static_cast<long long>(my) * fr.v[c] + yy) * fr.bw[c] +
                            static_cast<long long>(mx) * fr.h[c] + xx);
            s.sel.push_back(i);
          }
      }
  return per_mcu;
}

// The end of a scan's entropy-coded data (a marker other than RSTn) and its
// restart intervals' byte ranges.
long long scan_pieces(const uint8_t* data, long long n, long long pos, int restart,
                      std::vector<std::pair<long long, long long>>& pieces) {
  long long end = n;
  for (long long i = pos; i + 1 < n; ++i)
    if (data[i] == 0xFF && data[i + 1] != 0x00 && !(data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7)) {
      end = i;
      break;
    }
  pieces.clear();
  long long start = pos;
  if (restart) {
    for (long long i = pos; i < end;) {
      if (data[i] == 0xFF && i + 1 < end && data[i + 1] >= 0xD0 && data[i + 1] <= 0xD7) {
        pieces.emplace_back(start, i);
        i += 2;
        start = i;
      } else {
        ++i;
      }
    }
  }
  pieces.emplace_back(start, end);
  return end;
}

// One interval's bytes unstuffed into s.raw, zero-padded to a multiple of 4
// (and 4 to 12 bytes past its end) -> its unstuffed length.
long long unstuff(const uint8_t* data, long long a, long long b, Scratch& s) {
  s.raw.clear();
  for (long long i = a; i < b; ++i) {
    s.raw.push_back(data[i]);
    if (data[i] == 0xFF && i + 1 < b && data[i + 1] == 0x00) ++i;
  }
  const long long n_raw = static_cast<long long>(s.raw.size());
  s.raw.resize(n_raw + 12 - n_raw % 4, 0);
  return n_raw;
}

// utils/jpeg.py:_fill_intervals for interval k of a scan whose entropy-coded
// data ends at `end`: its bytes unstuffed into s.raw (a lone 0xFF at the
// end of the file dropped: a marker's first byte), zero-padded by kFillPad
// -> the bits it has; -1 where it decodes nothing (its restart marker never
// came and the interval before ran out).
constexpr long long kFillPad = 4096;  // utils/jpeg.py:_FILL_PAD
long long fill_interval(const uint8_t* data, long long n, long long end,
                        const std::vector<std::pair<long long, long long>>& pieces, long long k,
                        bool ran_out, Scratch& s) {
  s.raw.clear();
  if (k < static_cast<long long>(pieces.size())) {
    long long a = pieces[k].first, b = pieces[k].second;
    if (end == n && k == static_cast<long long>(pieces.size()) - 1)
      while (b > a && data[b - 1] == 0xFF) --b;
    for (long long i = a; i < b; ++i) {
      s.raw.push_back(data[i]);
      if (data[i] == 0xFF && i + 1 < b && data[i + 1] == 0x00) ++i;
    }
  } else if (ran_out) {
    return -1;
  }
  const long long n_raw = static_cast<long long>(s.raw.size());
  s.raw.resize(n_raw + kFillPad - n_raw % 4, 0);
  return 8 * n_raw;
}

int decode_scan(Frame& fr, const uint8_t* body, long long blen, const uint8_t* data,
                long long n, long long pos, const std::vector<int64_t>* qt, const bool* qt_def,
                const HuffTable* dc_tabs, const HuffTable* ac_tabs, int restart,
                Scratch& s, long long* end_out, long long* info) {
  const int ns = blen ? body[0] : 0;
  if (!valid_sos(fr, body, blen, ns)) return E_BAD_SOS;
  std::vector<int> comps;
  std::vector<const int*> dcls, acls;
  for (int i = 0; i < ns; ++i) {
    const int cid = body[1 + 2 * i], t = body[2 + 2 * i];
    const int c = fr.index_of(cid);
    if (c < 0) return info[0] = cid, E_SCAN_COMPONENT;
    if (!dc_tabs[t >> 4].defined || !ac_tabs[t & 15].defined) return E_UNDEF_HUFF;
    if (fr.quant[c].empty()) {
      if (fr.tq[c] > 15 || !qt_def[fr.tq[c]]) return E_UNDEF_QUANT;
      fr.quant[c] = qt[fr.tq[c]];
    }
    fr.scanned[c] = true;
    comps.push_back(c);
    const int* d = lut_rows(dc_tabs[t >> 4], true);
    if (!d) return E_BAD_HUFF_TABLE;
    const int* a = lut_rows(ac_tabs[t & 15], false);
    if (!a) return E_BAD_HUFF_TABLE;
    dcls.push_back(d);
    acls.push_back(a);
  }
  const uint8_t* sa = body + 1 + 2 * ns;
  if (!(sa[0] == 0 && sa[1] == 63 && sa[2] == 0) && !fr.libjpeg) return E_SPECTRAL;

  std::vector<std::pair<long long, long long>> pieces;
  const long long end = scan_pieces(data, n, pos, restart, pieces);
  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  if (fr.libjpeg) {  // libjpeg over a whole buffer (utils/jpeg.py:_fill_intervals)
    s.out_ac.resize(static_cast<size_t>(n_blocks) * 63);
    s.out_dc.resize(n_blocks);
    std::vector<char> done(n_blocks, 0);
    std::vector<int64_t> preds(ns);
    long long total = 0;
    const long long per_interval = span * per_mcu;
    bool ran_out = false;
    for (long long k = 0; k < n_int; ++k) {
      const long long bits = fill_interval(data, n, end, pieces, k, ran_out, s);
      if (bits < 0) break;
      const long long lo = k * per_interval;
      const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
      long long n_ac = 0, n_done = 0;
      for (int i = 0; i < ns; ++i) preds[i] = 0;
      const long long used = decode_interval(
          s.raw.data(), static_cast<long long>(s.raw.size()), s.blk.data() + lo,
          s.sel.data() + lo, hi - lo, dcls.data(), acls.data(), s.out_ac.data() + total, &n_ac,
          s.out_dc.data() + lo, preds.data(), per_mcu, bits, &n_done);
      if (used == -2) return E_INVALID_CODE;
      if (used == -1) return E_SCAN_TRUNC;
      for (long long i = lo; i < lo + n_done; ++i) done[i] = 1;
      total += n_ac;
      ran_out = used > bits;
    }
    for (long long i = 0; i < n_blocks; ++i)
      if (done[i]) s.coef[s.blk[i] * 64] = static_cast<int16_t>(s.out_dc[i]);
    for (long long i = 0; i < total; ++i) {  // past 63: libjpeg's padded order
      const long long ac = s.out_ac[i], k = (ac >> 16) & 127;
      s.coef[(ac >> 23) * 64 + (k < 63 ? k : 63)] =
          static_cast<int16_t>(static_cast<uint16_t>(ac & 0xFFFF));
    }
    *end_out = end;
    return 0;
  }
  if (static_cast<long long>(pieces.size()) < n_int) return E_FEW_INTERVALS;

  s.out_ac.resize(static_cast<size_t>(n_blocks) * 63);  // at most 63 a block
  s.out_dc.resize(n_blocks);
  std::vector<int64_t> preds(ns);
  long long total = 0;
  const long long per_interval = span * per_mcu;
  for (long long k = 0; k < n_int; ++k) {
    const long long n_raw = unstuff(data, pieces[k].first, pieces[k].second, s);
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    long long n_ac = 0;
    for (int i = 0; i < ns; ++i) preds[i] = 0;
    const long long used = decode_interval(
        s.raw.data(), static_cast<long long>(s.raw.size()), s.blk.data() + lo,
        s.sel.data() + lo, hi - lo, dcls.data(), acls.data(), s.out_ac.data() + total, &n_ac,
        s.out_dc.data() + lo, preds.data());
    if (used == -2) return E_INVALID_CODE;
    if (used == -1 || used > 8 * n_raw) return E_SCAN_TRUNC;
    total += n_ac;
  }
  for (long long i = 0; i < n_blocks; ++i)
    s.coef[s.blk[i] * 64] = static_cast<int16_t>(s.out_dc[i]);  // JCOEF
  for (long long i = 0; i < total; ++i)
    if (((s.out_ac[i] >> 16) & 127) > 63) return E_COEF_PAST;
  for (long long i = 0; i < total; ++i) {
    const long long ac = s.out_ac[i];
    s.coef[(ac >> 23) * 64 + ((ac >> 16) & 127)] =
        static_cast<int16_t>(static_cast<uint16_t>(ac & 0xFFFF));
  }
  *end_out = end;
  return 0;
}

// utils/jpeg.py:_decode_progressive_scan: one progressive scan into s.coef.
int decode_progressive_scan(Frame& fr, const uint8_t* body, long long blen, const uint8_t* data,
                            long long n, long long pos, const std::vector<int64_t>* qt,
                            const bool* qt_def, const HuffTable* dc_tabs, const HuffTable* ac_tabs,
                            int restart, Scratch& s, long long* end_out, long long* info) {
  const int ns = blen ? body[0] : 0;
  if (!valid_sos(fr, body, blen, ns)) return E_BAD_SOS;
  const uint8_t* sa = body + 1 + 2 * ns;
  const int ss = sa[0], se = sa[1], ah = sa[2] >> 4, al = sa[2] & 15;
  // jdphuff.c start_pass_phuff_decoder's checks
  if ((ss == 0 && se != 0) || (ss > 0 && (se < ss || se > 63 || ns != 1)) ||
      (ah && al != ah - 1) || al > 13)
    return E_BAD_PROGRESSION;
  const bool dc_refine = ss == 0 && ah;
  std::vector<int> comps;
  std::vector<const int*> luts;
  for (int i = 0; i < ns; ++i) {
    const int cid = body[1 + 2 * i], t = body[2 + 2 * i];
    const int c = fr.index_of(cid);
    if (c < 0) return info[0] = cid, E_SCAN_COMPONENT;
    const HuffTable& tab = ss == 0 ? dc_tabs[t >> 4] : ac_tabs[t & 15];
    if (!dc_refine && !tab.defined) return E_UNDEF_HUFF;  // DC refine reads no table
    if (fr.quant[c].empty()) {
      if (fr.tq[c] > 15 || !qt_def[fr.tq[c]]) return E_UNDEF_QUANT;
      fr.quant[c] = qt[fr.tq[c]];
    }
    fr.scanned[c] = true;
    comps.push_back(c);
    const int* lut = nullptr;
    if (!dc_refine) {
      lut = sym_rows(tab, ss == 0);
      if (!lut) return E_BAD_HUFF_TABLE;
    }
    luts.push_back(lut);
    for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); ++k)  // jdphuff.c start_pass
      fr.prev_bits[c][k] = fr.scans > 1 ? fr.coef_bits[c][k] : 0;
    for (int k = ss; k <= se; ++k) fr.coef_bits[c][k] = al;
  }
  std::vector<std::pair<long long, long long>> pieces;
  const long long end = scan_pieces(data, n, pos, restart, pieces);
  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  if (fr.libjpeg) {  // as decode_scan's, and jdcoefct.c's last_good_iMCU_row
    const long long per_interval = span * per_mcu;
    bool ran_out = false;
    long long last = -1;
    for (long long k = 0; k < n_int; ++k) {
      const long long bits = fill_interval(data, n, end, pieces, k, ran_out, s);
      if (bits < 0) break;
      const long long lo = k * per_interval;
      const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
      Bits rd{s.raw.data(), static_cast<long long>(s.raw.size()) / 4};
      long long started = -1;
      const bool ok = progressive_interval(rd, s.blk.data() + lo, s.sel.data() + lo, hi - lo,
                                           luts.data(), s.coef.data(), ss, se, ah, al, per_mcu,
                                           bits, &started);
      if (!ok && rd.bad_code) return E_INVALID_CODE;
      if (!ok) return E_SCAN_TRUNC;
      if (started >= 0) last = lo + started;
      ran_out = rd.used() > bits;
    }
    if (last >= 0) {  // the iMCU row of the last MCU started
      const int c = comps[s.sel[last]];
      fr.last_good = (s.blk[last] - fr.offset[c] / fr.per) / fr.bw[c] / fr.v[c];
    }
    *end_out = end;
    return 0;
  }
  if (static_cast<long long>(pieces.size()) < n_int) return E_FEW_INTERVALS;
  const long long per_interval = span * per_mcu;
  for (long long k = 0; k < n_int; ++k) {
    const long long n_raw = unstuff(data, pieces[k].first, pieces[k].second, s);
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    Bits rd{s.raw.data(), static_cast<long long>(s.raw.size()) / 4};
    const bool ok = progressive_interval(rd, s.blk.data() + lo, s.sel.data() + lo, hi - lo,
                                         luts.data(), s.coef.data(), ss, se, ah, al);
    if (!ok && rd.bad_code) return E_INVALID_CODE;
    if (!ok || rd.used() > 8 * n_raw) return E_SCAN_TRUNC;
  }
  *end_out = end;
  return 0;
}

// jdcoefct.c:smoothing_ok once every scan is in (utils/jpeg.py:_smoothed)
bool smoothed(const Frame& fr) {
  bool useful = false;
  for (int c = 0; c < fr.n; ++c) {
    if (fr.quant[c].empty()) return false;
    for (int i : kZigzagNatural)
      if (fr.quant[c][i] == 0) return false;
    if (fr.coef_bits[c][0] < 0) return false;
    for (int k = 1; k < 10; ++k) useful |= fr.coef_bits[c][k] != 0;
  }
  return useful;
}

// utils/jpeg.py:_SMOOTH_AC and _SMOOTH_DC: jdcoefct.c decompress_smooth_data's
// estimates: zigzag position (also the coef_bits index), whether it is made
// without DC interpolation, and the 5 x 5 DC weights without and with it
struct SmoothAC {
  int zz;
  bool plain_used;
  int plain[25], interp[25];
};
const SmoothAC kSmoothAC[9] = {
    {1, true, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1}},
    {2, true, {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0}, {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1}},
    {3, true, {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0}, {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0}},
    {4, true, {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0}, {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1}},
    {5, true, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0}},
    {6, false, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}},
    {7, false, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0}},
    {8, false, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}},
    {9, false, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}},
};
const int kSmoothDC[25] = {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2};

inline int16_t w16s(int64_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF)); }

// utils/jpeg.py:_smooth_rows and _smooth, in place on s.coef (the DC values
// read are the coded ones, kept in a copy first); in libjpeg mode
// _smooth_rows_21, _smooth_cols_21 and, past fr.last_good, the bits from
// before each component's last scan (-1 after a single scan)
void smooth(const Frame& fr, std::vector<int16_t>& coef) {
  int minus[64];
  for (int& b : minus) b = -1;
  for (int c = 0; c < fr.n; ++c) {
    const std::vector<int64_t>& q = fr.quant[c];
    const int bw = fr.bw[c], bh = fr.bh[c];
    int16_t* grid = coef.data() + fr.offset[c];
    std::vector<int64_t> dcv(static_cast<size_t>(bw) * bh);
    for (long long b = 0; b < static_cast<long long>(bw) * bh; ++b) dcv[b] = grid[b * 64];
    const int cols = (fr.dw(c) + 7) / 8, height = (fr.dh(c) + 7) / 8;
    const int v = fr.v[c], total = fr.mcuy;
    // each block's five DC columns (utils/jpeg.py:_smooth_cols_21 in libjpeg mode)
    std::vector<int> x5(static_cast<size_t>(cols) * 5);
    int regs[5] = {0, 0, 0, 0, 0};
    for (int x = 0; x < cols; ++x) {
      if (fr.libjpeg) {
        if (x == 0 && x < cols - 1) regs[3] = 1;
        if (x + 1 < cols - 1) regs[4] = x + 2;
        for (int k = 0; k < 5; ++k) x5[5 * x + k] = regs[k];
        for (int k = 0; k < 4; ++k) regs[k] = regs[k + 1];
      } else {
        for (int k = 0; k < 5; ++k) {
          const int xc = x + k - 2;
          x5[5 * x + k] = xc < 0 ? 0 : xc > cols - 1 ? cols - 1 : xc;
        }
      }
    }
    for (int i = 0; i < total; ++i) {
      const int rows = i < total - 1 ? v : (height % v ? height % v : v);
      const int count = rows * total;
      const bool late = fr.libjpeg && fr.last_good >= 0 && i > fr.last_good;
      const int* bits = !late ? fr.coef_bits[c] : fr.scans <= 1 ? minus : fr.prev_bits[c];
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      for (int b = 0; b < rows; ++b) {
        const int at = i * rows + b, row = i * v + b;
        int up, up2, down, down2;
        if (fr.libjpeg) {  // libjpeg-turbo 2.1: only the iMCU rows it accesses
          up = b > 0 || i > 0 ? row - 1 : row;
          up2 = b > 1 || i > 1 ? row - 2 : up;
          down = b < rows - 1 || i < total - 1 ? row + 1 : row;
          down2 = b < rows - 2 || i + 1 < total - 1 ? row + 2 : down;
        } else {
          up = at > 0 ? row - 1 : row;
          up2 = at > 1 ? row - 2 : up;
          down = at < count - 1 ? row + 1 : row;
          down2 = at < count - 2 ? row + 2 : down;
        }
        const int r5[5] = {up2, up, row, down, down2};
        for (int x = 0; x < cols; ++x) {
          int64_t dc[25];
          for (int rr = 0; rr < 5; ++rr)
            for (int cc = 0; cc < 5; ++cc)
              dc[5 * rr + cc] = dcv[static_cast<long long>(r5[rr]) * bw + x5[5 * x + cc]];
          int16_t* blk = grid + (static_cast<long long>(row) * bw + x) * 64;
          int16_t upd[10];
          bool set[10] = {false};
          for (const SmoothAC& e : kSmoothAC) {
            const int al = bits[e.zz];
            const int* wts = change_dc ? e.interp : (e.plain_used ? e.plain : nullptr);
            if (al == 0 || !wts || blk[e.zz] != 0) continue;
            int64_t sum = 0;
            for (int k = 0; k < 25; ++k) sum += wts[k] * dc[k];
            const int64_t qk = q[kZigzagNatural[e.zz]], num = q[0] * sum;
            int64_t mag = ((qk << 7) + (num < 0 ? -num : num)) / (qk << 8);
            if (al > 0 && mag > (int64_t(1) << al) - 1) mag = (int64_t(1) << al) - 1;
            upd[e.zz] = w16s(num >= 0 ? mag : -mag);
            set[e.zz] = true;
          }
          if (change_dc) {
            int64_t sum = 0;
            for (int k = 0; k < 25; ++k) sum += kSmoothDC[k] * dc[k];
            const int64_t num = q[0] * sum;
            const int64_t mag = ((q[0] << 7) + (num < 0 ? -num : num)) / (q[0] << 8);
            upd[0] = w16s(num >= 0 ? mag : -mag);
            set[0] = true;
          }
          for (int k = 0; k < 10; ++k)
            if (set[k]) blk[k] = upd[k];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// arithmetic-coded scans (utils/jpeg.py:_ArithBits, _arith_dc,
// _arith_ac_value, _arith_interval, _decode_arith_scan; libjpeg's jdarith.c)
// ---------------------------------------------------------------------------

// jaricom.c's jpeg_aritab (utils/jpeg.py:ARITAB): Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; state 113 is the fixed bin
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x80b0412, 0x3d80514, 0x1da0617, 0xe50719, 0x6f081c,
    0x36091e, 0x1a0a21, 0x0d0b23, 0x060c09, 0x030d0a, 0x010d0c, 0x5a7f0f8f, 0x3f251024,
    0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0xcef152b, 0x9a1162d, 0x72f172e, 0x55c1830,
    0x4061931, 0x3031a33, 0x2401b34, 0x1b11c36, 0x1441d38, 0xf51e39, 0xb71f3b, 0x8a203c,
    0x68213e, 0x4e223f, 0x3b2320, 0x2c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843,
    0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48, 0x11772d49, 0xe742e4a, 0xbfb2f4b, 0x9f8304d,
    0x861314e, 0x706324f, 0x5cd3330, 0x4de3432, 0x40f3532, 0x3633633, 0x2d43734, 0x25c3835,
    0x1f83936, 0x1a43a37, 0x1603b38, 0x1253c39, 0xf63d3a, 0xcb3e3b, 0xab3f3d, 0x8f203d,
    0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0xf6b4d4a, 0xd514e4b, 0xbb64f4d, 0xa40304d,
    0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a, 0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756,
    0x557059d8, 0x4ca95a5f, 0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b,
    0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
};
constexpr long long kPillowBlock = 65536;  // utils/jpeg.py:PILLOW_BLOCK

// jdarith.c's decoder over one restart interval's stuffed bytes
// data[p, end): past `end` a marker supplies zeros; with no marker after it
// (eof) a read past it fails, and so does one at or past `limit` (Pillow's
// reads). err holds the failure; ct -1 is libjpeg's error state.
struct ArithBits {
  const uint8_t* data;
  long long p, end, limit;
  bool eof;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool marker = false;
  int err = 0;
  int byte() {
    if (marker || err) return 0;
    if (p < end && data[p] != 0xFF) {
      if (p >= limit) return err = E_PILLOW_BLOCK, 0;
      return data[p++];
    }
    long long q = p;
    while (q < end && data[q] == 0xFF) ++q;  // fill bytes
    if (q >= end && eof) return err = E_SCAN_TRUNC, 0;
    if ((q < end ? q : end + 1) >= limit) return err = E_PILLOW_BLOCK, 0;
    if (q < end && data[q] == 0) {
      p = q + 1;
      return 0xFF;
    }
    p = q;
    marker = true;
    return 0;
  }
  int bit(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const uint32_t e = kAritab[sv & 0x7F];
    const int64_t qe = e >> 16;
    const int nm = (e >> 8) & 0xFF, nl = e & 0xFF;
    a -= qe;
    const int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// F.19-F.24 for one DC difference from bin S0 = st[ctx] -> false at a
// magnitude overflow; *v the difference, *next the next context.
bool arith_dc(ArithBits& rd, uint8_t* st, int ctx, int lo, int hi, int* v, int* next) {
  if (!rd.bit(st + ctx)) {
    *v = 0;
    *next = 0;
    return true;
  }
  const int sign = rd.bit(st + ctx + 1);
  int i = ctx + 2 + sign;
  int m = rd.bit(st + i);
  if (m) {
    i = 20;
    while (rd.bit(st + i)) {
      if ((m <<= 1) == 0x8000) return false;
      ++i;
    }
  }
  if (m < ((1 << lo) >> 1))
    *next = 0;
  else if (m > ((1 << hi) >> 1))
    *next = 12 + sign * 4;
  else
    *next = 4 + sign * 4;
  int val = m;
  i += 14;
  while (m >>= 1)
    if (rd.bit(st + i)) val |= m;
  val += 1;
  *v = sign ? -val : val;
  return true;
}

// an AC coefficient's magnitude after its sign, bin i = SP of position k ->
// |v|, or 0 at a magnitude overflow
int arith_ac_value(ArithBits& rd, uint8_t* st, int i, int k, int kx) {
  int m = rd.bit(st + i);
  if (m && rd.bit(st + i)) {
    m = 2;
    i = k <= kx ? 189 : 217;
    while (rd.bit(st + i)) {
      if ((m <<= 1) == 0x8000) return 0;
      ++i;
    }
  }
  int v = m;
  i += 14;
  while (m >>= 1)
    if (rd.bit(st + i)) v |= m;
  return v + 1;
}

struct Dac {
  int lo[16], hi[16], kx[16];
};

// utils/jpeg.py:_arith_interval: one restart interval of an
// arithmetic-coded scan into coef (64 int16 a block, zigzag order).
void arith_interval(ArithBits& rd, const long long* blocks, const int* comps, long long n_blocks,
                    const int* dtab, const int* atab, uint8_t (*dcs)[64], uint8_t (*acs)[256],
                    const Dac& dac, int16_t* coef, bool progressive, int ss, int se, int ah,
                    int al) {
  uint8_t fixed = 113;
  if (!progressive || (ss == 0 && ah == 0)) {
    int ctxs[4] = {0, 0, 0, 0};
    int64_t last[4] = {0, 0, 0, 0};
    for (long long b = 0; b < n_blocks; ++b) {
      if (rd.ct == -1 || rd.err) return;
      const int ci = comps[b], dt = dtab[ci], at = atab[ci];
      int v = 0;
      if (!arith_dc(rd, dcs[dt], ctxs[ci], dac.lo[dt], dac.hi[dt], &v, &ctxs[ci])) {
        rd.ct = -1;
        return;
      }
      int16_t* blk = coef + blocks[b] * 64;
      if (progressive) {
        last[ci] += v;
        blk[0] = w16(last[ci] * (int64_t(1) << al));
        continue;
      }
      last[ci] = (last[ci] + v) & 0xFFFF;
      blk[0] = w16(last[ci]);
      uint8_t* st = acs[at];
      for (int k = 1; k <= 63; ++k) {
        int i = 3 * (k - 1);
        if (rd.bit(st + i)) break;  // end of block
        while (!rd.bit(st + i + 1)) {
          i += 3;
          if (++k > 63) {
            rd.ct = -1;
            return;
          }
        }
        const int sign = rd.bit(&fixed);
        const int m = arith_ac_value(rd, st, i + 2, k, dac.kx[at]);
        if (!m) {
          rd.ct = -1;
          return;
        }
        blk[k] = w16(sign ? -m : m);
      }
    }
    return;
  }
  if (ss == 0) {  // DC refine
    const int p1 = 1 << al;
    for (long long b = 0; b < n_blocks; ++b)
      if (rd.bit(&fixed)) coef[blocks[b] * 64] = static_cast<int16_t>(coef[blocks[b] * 64] | p1);
    return;
  }
  const int at = atab[0];
  uint8_t* st = acs[at];
  if (ah == 0) {  // AC first
    for (long long b = 0; b < n_blocks; ++b) {
      if (rd.ct == -1 || rd.err) return;
      int16_t* blk = coef + blocks[b] * 64;
      for (int k = ss; k <= se; ++k) {
        int i = 3 * (k - 1);
        if (rd.bit(st + i)) break;
        while (!rd.bit(st + i + 1)) {
          i += 3;
          if (++k > se) {
            rd.ct = -1;
            return;
          }
        }
        const int sign = rd.bit(&fixed);
        const int m = arith_ac_value(rd, st, i + 2, k, dac.kx[at]);
        if (!m) {
          rd.ct = -1;
          return;
        }
        blk[k] = w16(static_cast<int64_t>(sign ? -m : m) * (int64_t(1) << al));
      }
    }
    return;
  }
  const int p1 = 1 << al, m1 = -(1 << al);  // AC refine
  for (long long b = 0; b < n_blocks; ++b) {
    if (rd.ct == -1 || rd.err) return;
    int16_t* blk = coef + blocks[b] * 64;
    int kex = se;
    while (kex > 0 && !blk[kex]) --kex;
    for (int k = ss; k <= se; ++k) {
      int i = 3 * (k - 1);
      if (k > kex && rd.bit(st + i)) break;
      while (true) {
        const int c = blk[k];
        if (c) {
          if (rd.bit(st + i + 2)) blk[k] = w16(c + (c < 0 ? m1 : p1));
          break;
        }
        if (rd.bit(st + i + 1)) {
          blk[k] = static_cast<int16_t>(rd.bit(&fixed) ? m1 : p1);
          break;
        }
        i += 3;
        if (++k > se) {
          rd.ct = -1;
          return;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// lossless scans (utils/jpeg.py:_decode_lossless_scan, _undifference,
// _assemble_lossless; libjpeg-turbo's jdlhuff.c, jdpred.c, jdlossls.c)
// ---------------------------------------------------------------------------

// utils/jpeg.py:_undifference: one component's differences (h rows of w,
// row stride `stride`) into its values modulo 2^16; first[y]: row y
// starts the image or a restart interval.
void undifference(const int16_t* diff, long long stride, int h, int w, int psv, int pt,
                  const std::vector<char>& first, int32_t* out) {
  const int32_t init = 1 << (8 - pt - 1);
  for (int y = 0; y < h; ++y) {
    const int16_t* row = diff + y * stride;
    int32_t* cur = out + static_cast<long long>(y) * w;
    if (first[y]) {
      int32_t ra = init;
      for (int x = 0; x < w; ++x) cur[x] = ra = (row[x] + ra) & 0xFFFF;
      continue;
    }
    const int32_t* prev = cur - w;
    int32_t rb = prev[0];
    int32_t ra = cur[0] = (row[0] + rb) & 0xFFFF;
    for (int x = 1; x < w; ++x) {
      const int32_t rc = rb;
      rb = prev[x];
      int32_t p;
      switch (psv) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      cur[x] = ra = (row[x] + p) & 0xFFFF;
    }
  }
}

// utils/jpeg.py:_decode_lossless_scan: one lossless scan's differences
// into s.coef (int16: 32768 wraps to -32768, the same modulo 2^16), then
// each of its components undifferenced into fr.samples.
int decode_lossless_scan(Frame& fr, const uint8_t* body, long long blen, const uint8_t* data,
                         long long n, long long pos, const HuffTable* dc_tabs, int restart,
                         Scratch& s, long long* end_out, long long* info) {
  const int ns = blen ? body[0] : 0;
  if (!valid_sos(fr, body, blen, ns)) return E_BAD_SOS;
  const uint8_t* sa = body + 1 + 2 * ns;
  const int psv = sa[0], pt = sa[2] & 15;
  if (psv < 1 || psv > 7 || sa[1] || (sa[2] >> 4) || pt >= 8) return E_BAD_LOSSLESS;
  std::vector<int> comps;
  std::vector<const int*> luts;
  for (int i = 0; i < ns; ++i) {
    const int cid = body[1 + 2 * i], t = body[2 + 2 * i];
    const int c = fr.index_of(cid);
    if (c < 0) return info[0] = cid, E_SCAN_COMPONENT;
    if (!dc_tabs[t >> 4].defined) return E_UNDEF_HUFF;
    fr.scanned[c] = true;
    comps.push_back(c);
    const int* lut = diff_rows(dc_tabs[t >> 4]);
    if (!lut) return E_BAD_HUFF_TABLE;
    luts.push_back(lut);
  }
  const long long per_row = ns == 1 ? fr.dw(comps[0]) : fr.mcux;
  if (restart % per_row) return E_BAD_RESTART;
  std::vector<std::pair<long long, long long>> pieces;
  const long long end = scan_pieces(data, n, pos, restart, pieces);
  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  if (static_cast<long long>(pieces.size()) < n_int) return E_FEW_INTERVALS;
  const long long per_interval = span * per_mcu;
  for (long long k = 0; k < n_int; ++k) {
    const long long n_raw = unstuff(data, pieces[k].first, pieces[k].second, s);
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    Bits rd{s.raw.data(), static_cast<long long>(s.raw.size()) / 4};
    bool ok = true;
    for (long long b = lo; b < hi && ok; ++b) {
      int sym = 0;
      int64_t v = 0;
      ok = rd.huff(luts[s.sel[b]], &sym);
      if (ok && sym == 16) {
        v = 32768;
      } else if (ok && sym) {
        int64_t bits = 0;
        ok = rd.get(sym, &bits);
        v = extend(bits, sym);
      }
      s.coef[s.blk[b]] = w16(v);
    }
    if (!ok && rd.bad_code) return E_INVALID_CODE;
    if (!ok || rd.used() > 8 * n_raw) return E_SCAN_TRUNC;
  }
  const long long interval_rows = restart ? span / per_row : 0;
  for (int c : comps) {
    const int w = fr.dw(c), h = fr.dh(c), v = ns == 1 ? 1 : fr.v[c];
    std::vector<char> first(h, 0);
    for (int r = 0; r < h; r += v)
      first[r] = r == 0 || (interval_rows && (r / v) % interval_rows == 0);
    fr.samples[c].assign(static_cast<size_t>(h) * w, 0);
    undifference(s.coef.data() + fr.offset[c], fr.bw[c], h, w, psv, pt, first,
                 fr.samples[c].data());
    fr.pt[c] = pt;
  }
  *end_out = end;
  return 0;
}

// utils/jpeg.py:_decode_arith_scan: one arithmetic-coded scan into s.coef.
int decode_arith_scan(Frame& fr, const uint8_t* body, long long blen, const uint8_t* data,
                      long long n, long long pos, const std::vector<int64_t>* qt,
                      const bool* qt_def, const Dac& dac, int restart, long long limit,
                      Scratch& s, long long* end_out, long long* info) {
  const int ns = blen ? body[0] : 0;
  if (!valid_sos(fr, body, blen, ns)) return E_BAD_SOS;
  const uint8_t* sa = body + 1 + 2 * ns;
  const int ss = sa[0], se = sa[1], ah = sa[2] >> 4, al = sa[2] & 15;
  if (fr.progressive) {  // jdarith.c start_pass's checks
    if ((ss == 0 && se != 0) || (ss > 0 && (se < ss || se > 63 || ns != 1)) ||
        (ah && al != ah - 1) || al > 13)
      return E_BAD_PROGRESSION;
  } else if (!(ss == 0 && se == 63 && sa[2] == 0) && !fr.libjpeg) {  // libjpeg only warns
    return E_SPECTRAL;
  }
  std::vector<int> comps;
  int dtab[4], atab[4];
  for (int i = 0; i < ns; ++i) {
    const int cid = body[1 + 2 * i], t = body[2 + 2 * i];
    const int c = fr.index_of(cid);
    if (c < 0) return info[0] = cid, E_SCAN_COMPONENT;
    if (fr.quant[c].empty()) {
      if (fr.tq[c] > 15 || !qt_def[fr.tq[c]]) return E_UNDEF_QUANT;
      fr.quant[c] = qt[fr.tq[c]];
    }
    fr.scanned[c] = true;
    comps.push_back(c);
    dtab[i] = t >> 4;
    atab[i] = t & 15;
    if (fr.progressive)
      for (int k = ss; k <= se; ++k) fr.coef_bits[c][k] = al;
  }
  std::vector<std::pair<long long, long long>> pieces;
  const long long end = scan_pieces(data, n, pos, restart, pieces);
  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  if (fr.libjpeg) {  // the fake EOI: a marker, zeros past the data, no limit
    while (static_cast<long long>(pieces.size()) < n_int) pieces.emplace_back(n, n);
    limit = n + 2;
  }
  if (static_cast<long long>(pieces.size()) < n_int) return E_FEW_INTERVALS;
  const long long per_interval = span * per_mcu;
  static thread_local uint8_t dcs[16][64], acs[16][256];
  bool met = true;
  for (long long k = 0; k < n_int; ++k) {
    // read_restart_marker reads the marker before the interval to its end
    if (!met && pieces[k].first > limit) return E_PILLOW_BLOCK;
    std::memset(dcs, 0, sizeof(dcs));  // statistics reset at every restart
    std::memset(acs, 0, sizeof(acs));
    ArithBits rd{data, pieces[k].first, pieces[k].second, limit,
                 pieces[k].second == n && !fr.libjpeg};
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    arith_interval(rd, s.blk.data() + lo, s.sel.data() + lo, hi - lo, dtab, atab, dcs, acs,
                   dac, s.coef.data(), fr.progressive, ss, se, ah, al);
    if (rd.err) return rd.err;
    met = rd.marker;
  }
  *end_out = end;
  return 0;
}

inline uint8_t clip8(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

inline int64_t muldiv255(int64_t a, int64_t b) {
  const int64_t t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// lj: utils/jpeg.py:_decode_libjpeg (libjpeg-turbo 2.1 over a whole buffer)
int decode(const uint8_t* data, long long n, uint8_t* out, long long out_bytes,
           long long* info, bool lj) {
  if (lj ? n < 2 || data[0] != 0xFF || data[1] != 0xD8
         : n < 3 || data[0] != 0xFF || data[1] != 0xD8 || data[2] != 0xFF)
    return E_NOT_JPEG;
  thread_local Scratch s;
  thread_local std::vector<uint8_t> ext;  // the data and jpeg_mem_src's fake EOIs
  if (lut_cache.size() > 64) lut_cache.clear();  // a file defines at most 32
  std::vector<int64_t> qt[16];
  bool qt_def[16] = {};
  HuffTable dc_tabs[16], ac_tabs[16];
  int restart = 0, adobe = -1;
  Dac dac;
  for (int i = 0; i < 16; ++i) dac.lo[i] = 0, dac.hi[i] = 1, dac.kx[i] = 5;
  long long limit = kPillowBlock;
  int scans = 0;
  bool jfif = false, have_frame = false, eoi = false, extended = false;
  Frame fr;
  fr.libjpeg = lj;
  long long pos = 2;
  while (true) {
    const void* f = pos < n ? std::memchr(data + pos, 0xFF, n - pos) : nullptr;
    if (!f) break;  // no EOI: the scans decoded so far must cover the image
    pos = static_cast<const uint8_t*>(f) - data + 1;
    while (pos < n && data[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= n) break;
    const int marker = data[pos++];
    if (marker == 0xD9) {
      eoi = true;
      break;
    }
    if (marker == 0x00 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (marker == 0x01 && (scans || lj)) continue;  // TEM (Pillow refuses it before a scan)
    if (lj && (marker < 0xC0 || marker == 0xC3 || marker == 0xC8 || marker == 0xD8 ||
               marker == 0xDE || marker == 0xDF || (marker >= 0xF0 && marker <= 0xFD) ||
               marker == 0xC5 || marker == 0xC6 || marker == 0xC7 || marker == 0xCB ||
               marker == 0xCD || marker == 0xCE || marker == 0xCF))
      return info[0] = marker, E_LIBJPEG;
    if (marker < 0xC0 || marker == 0xC8 || marker == 0xD8 || marker == 0xDE || marker == 0xDF ||
        (marker >= 0xF0 && marker <= 0xFD))
      return info[0] = marker, E_MARKER;
    if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 || marker == 0xCB ||
        marker == 0xCD || marker == 0xCE || marker == 0xCF)
      return info[0] = marker, E_REFUSE_SOF;
    if (lj && !extended && (pos + 2 > n || be16(data + pos) < 2 || pos + be16(data + pos) > n)) {
      // the segment runs into the fake EOI bytes, and so does what follows
      ext.assign(data, data + n);
      for (int k = 0; k < 32768; ++k) ext.push_back(0xFF), ext.push_back(0xD9);
      data = ext.data();
      n = static_cast<long long>(ext.size());
      extended = true;
    }
    if (pos + 2 > n) return E_SEGMENT;
    const long long len = be16(data + pos);
    if (len < 2 || pos + len > n) return E_SEGMENT;
    const uint8_t* body = data + pos + 2;
    const long long blen = len - 2;
    long long after = pos + len;
    while (after > limit) limit += kPillowBlock;  // libjpeg suspends; Pillow reads on
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 || marker == 0xC3 || marker == 0xC9 ||
        marker == 0xCA) {
      if (have_frame) return E_SECOND_FRAME;
      fr.lossless = marker == 0xC3;
      fr.unit = fr.lossless ? 1 : 8;
      fr.per = fr.unit * fr.unit;
      const int rc = parse_frame(body, blen, fr, info);
      if (rc) return rc;
      fr.progressive = marker == 0xC2 || marker == 0xCA;
      fr.arith = marker >= 0xC9;
      have_frame = true;
      s.coef.assign(fr.offset.back(), 0);
    } else if (marker == 0xCC) {  // DAC (jdmarker.c get_dac)
      if (blen % 2) return E_BAD_DAC;
      for (long long i = 0; i < blen; i += 2) {
        const int index = body[i], val = body[i + 1];
        if (index >= 32 || (index < 16 && (val & 15) > (val >> 4))) return E_BAD_DAC;
        if (index >= 16) {
          dac.kx[index - 16] = val;
        } else {
          dac.lo[index] = val & 15;
          dac.hi[index] = val >> 4;
        }
      }
    } else if (marker == 0xC4) {  // DHT
      long long i = 0;
      while (i < blen) {
        const int tc_th = body[i];
        const long long nc = blen - i - 1 < 16 ? (blen - i - 1 > 0 ? blen - i - 1 : 0) : 16;
        long long sum = 0;
        for (long long k = 0; k < nc; ++k) sum += body[i + 1 + k];
        if (nc < 16 || i + 17 + sum > blen || (tc_th >> 4) > 1 || (tc_th & 15) > 3 || sum > 256)
          return E_BAD_DHT;
        HuffTable& t = (tc_th >> 4) ? ac_tabs[tc_th & 15] : dc_tabs[tc_th & 15];
        t.defined = true;
        std::memcpy(t.counts, body + i + 1, 16);
        t.symbols.assign(body + i + 17, body + i + 17 + sum);
        i += 17 + sum;
      }
    } else if (marker == 0xDB) {  // DQT
      long long i = 0;
      while (i < blen) {
        const int pq = body[i] >> 4, tq = body[i] & 15;
        const long long size = pq ? 128 : 64;
        if (i + 1 + size > blen || tq > 3) return E_BAD_DQT;
        std::vector<int64_t> q(64);
        for (int k = 0; k < 64; ++k) {
          const int z = kUnzigzag[k];
          q[k] = pq ? be16(body + i + 1 + 2 * z) : body[i + 1 + z];
        }
        qt[tq] = std::move(q);
        qt_def[tq] = true;
        i += 1 + size;
      }
    } else if (marker == 0xDD) {  // DRI
      if (blen != 2) return E_BAD_DRI;
      restart = be16(body);
    } else if (marker == 0xDC) {
      if (!lj) return E_DNL;  // libjpeg skips it
    } else if (marker == 0xE0 && blen >= 14 && std::memcmp(body, "JFIF\0", 5) == 0) {
      jfif = true;
    } else if (marker == 0xEE && blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
      adobe = body[11];
    } else if (marker == 0xDA) {  // SOS
      if (!have_frame) return E_SCAN_NO_FRAME;
      fr.scans = ++scans;
      const int rc =
          fr.lossless ? decode_lossless_scan(fr, body, blen, data, n, after, dc_tabs, restart, s,
                                             &after, info)
          : fr.arith ? decode_arith_scan(fr, body, blen, data, n, after, qt, qt_def, dac, restart,
                                       limit, s, &after, info)
          : fr.progressive
              ? decode_progressive_scan(fr, body, blen, data, n, after, qt, qt_def, dc_tabs,
                                        ac_tabs, restart, s, &after, info)
              : decode_scan(fr, body, blen, data, n, after, qt, qt_def, dc_tabs, ac_tabs,
                            restart, s, &after, info);
      if (rc) return rc;
    }
    pos = after;
  }
  if (!have_frame) return E_NO_SCAN;
  if (lj) {  // jpeg_read_header's JERR_NO_IMAGE; the rest read as it came
    if (!scans) return E_NO_SCAN;
  } else {
    for (int c = 0; c < fr.n; ++c)
      if (!fr.scanned[c]) return E_NO_SCAN;
    if (fr.progressive && !eoi) return E_PROG_NO_EOI;  // more scans may have been to come
  }
  if (fr.progressive && smoothed(fr)) smooth(fr, s.coef);

  if (fr.lossless) {  // utils/jpeg.py:_assemble_lossless's colour spaces
    if (!eoi) return E_LOSSLESS_NO_EOI;  // libjpeg-turbo reads on for its last bits
    if (fr.n == 4 && adobe > 0) return E_LOSSLESS_YCCK;
    if (fr.n == 3 && (jfif || adobe > 0)) return E_LOSSLESS_YCC;
  }
  info[0] = fr.height;
  info[1] = fr.width;
  const long long npx = static_cast<long long>(fr.height) * fr.width;
  if (out == nullptr || out_bytes != 3 * npx) return E_OUT_SIZE;
  if (fr.lossless) {
    // each component's samples shifted back by its Pt, replicated up to the
    // frame (no smoothing in lossless mode); gray into all three channels,
    // RGB as it is, CMYK through Pillow's conversion
    uint8_t* planes = out;
    int step = 3;
    if (fr.n == 4) {
      s.four.resize(static_cast<size_t>(npx) * 4);
      planes = s.four.data();
      step = 4;
    }
    for (int c = 0; c < fr.n; ++c) {
      const int fy = fr.vmax / fr.v[c], fx = fr.hmax / fr.h[c], w = fr.dw(c);
      const int32_t* smp = fr.samples[c].data();
      for (long long y = 0; y < fr.height; ++y)
        for (long long x = 0; x < fr.width; ++x)
          planes[(y * fr.width + x) * step + c] =
              static_cast<uint8_t>((smp[(y / fy) * w + x / fx] << fr.pt[c]) & 0xFF);
    }
    if (fr.n == 1)
      for (long long i = 0; i < npx; ++i) out[3 * i + 1] = out[3 * i + 2] = out[3 * i];
    if (fr.n == 4)
      for (long long i = 0; i < npx; ++i) {
        const uint8_t* q = planes + 4 * i;
        const int64_t nk = q[3];
        for (int k = 0; k < 3; ++k) out[3 * i + k] = clip8(nk - muldiv255(255 - q[k], nk));
      }
    return 0;
  }
  // each component upsampled into its channel of the output (a grayscale
  // plane into all three; four into a scratch), then the colour conversion
  uint8_t* planes = out;
  int step = 3;
  if (fr.n == 4) {
    s.four.resize(static_cast<size_t>(npx) * 4);
    planes = s.four.data();
    step = 4;
  }
  for (int c = 0; c < fr.n; ++c) {
    s.plane.resize(static_cast<size_t>(fr.bh[c]) * fr.bw[c] * 64);
    const std::vector<int64_t> none(64, 0);  // a component never scanned
    const int64_t* q = fr.quant[c].empty() ? none.data() : fr.quant[c].data();
    (lj ? idct_plane_simd : idct_plane)(s.coef.data() + fr.offset[c], q, fr.bh[c], fr.bw[c],
                                        s.plane.data());
    const int fh = fr.hmax / fr.h[c], fv = fr.vmax / fr.v[c];
    upsample(s.plane.data(), static_cast<long long>(fr.bw[c]) * 8, fr.dh(c), fr.dw(c), fh, fv,
             fr.height, fr.width, planes + c, step);
  }
  if (fr.n == 4) {
    // YCCK (an Adobe transform other than 0) to CMYK as jdcolor.c's
    // ycck_cmyk_convert; then Pillow's "CMYK;I" (each inverted) and its
    // Convert.c:cmyk2rgb, nk = 255 - K
    int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + half) >> 16;
      cb_b[i] = (fix(1.77200) * x + half) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    const bool ycck = adobe > 0;
    for (long long i = 0; i < npx; ++i) {
      const uint8_t* q = planes + 4 * i;
      int64_t cmy[3] = {q[0], q[1], q[2]};
      if (ycck) {
        const int64_t y = q[0];
        const int cb = q[1], cr = q[2];
        cmy[0] = clip8(255 - (y + cr_r[cr]));
        cmy[1] = clip8(255 - (y + ((cb_g[cb] + cr_g[cr]) >> 16)));
        cmy[2] = clip8(255 - (y + cb_b[cb]));
      }
      const int64_t nk = q[3];
      for (int k = 0; k < 3; ++k) out[3 * i + k] = clip8(nk - muldiv255(255 - cmy[k], nk));
    }
    return 0;
  }
  if (fr.n == 1) {
    for (long long i = 0; i < npx; ++i) out[3 * i + 1] = out[3 * i + 2] = out[3 * i];
    return 0;
  }
  // jdapimin.c default_decompress_parms: JFIF means YCbCr, else Adobe's
  // transform (0: RGB), else the component ids ('R', 'G', 'B': RGB)
  const bool rgb = (!jfif && adobe == 0) ||
                   (!jfif && adobe < 0 && fr.ids[0] == 82 && fr.ids[1] == 71 && fr.ids[2] == 66);
  if (!rgb) ycc_rgb(out, npx);
  return 0;
}

}  // namespace

extern "C" {

// utils/jpeg.py:_decode_interval over one restart interval's unstuffed
// bytes `data` (n_bytes, a multiple of 4, zero-padded past the interval,
// read as big-endian 32-bit words). blocks[i] is the block number, comps[i]
// its component's index in the scan; dc_luts[c] ([65536][2]) and
// ac_luts[c] ([65536][3]) are utils/jpeg.py:_lut_rows' tables. Each non-zero
// AC coefficient goes to out_ac as block << 23 | zigzag position << 16 |
// value & 0xFFFF (*n_ac of them, at most 63 a block), each DC value (the
// predictor's running sum from 0) to out_dc[i]. -> the bits used; -1 where
// the decode reads past the words, -2 at an invalid Huffman code.
long long l2i_jpeg_decode_interval(const uint8_t* data, long long n_bytes,
                                   const long long* blocks, const int* comps,
                                   long long n_blocks, const int* const* dc_luts,
                                   const int* const* ac_luts, long long* out_ac,
                                   long long* n_ac, long long* out_dc) {
  int n_comps = 0;
  for (long long i = 0; i < n_blocks; ++i) n_comps = comps[i] + 1 > n_comps ? comps[i] + 1 : n_comps;
  std::vector<int64_t> preds(n_comps);
  return decode_interval(data, n_bytes, blocks, comps, n_blocks, dc_luts, ac_luts, out_ac, n_ac,
                         out_dc, preds.data());
}

// The height and width of the first frame header (SOF0-3, SOF9-10) -> 0, or -1
// where the markers before it do not lead to one.
int l2i_jpeg_dims(const uint8_t* data, long long n, int* hw) {
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  long long pos = 2;
  while (pos < n) {
    const void* f = std::memchr(data + pos, 0xFF, n - pos);
    if (!f) return -1;
    pos = static_cast<const uint8_t*>(f) - data + 1;
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos + 2 >= n) return -1;
    const int marker = data[pos++];
    if (marker == 0x00 || marker == 0x01 || marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7))
      continue;
    const long long len = be16(data + pos);
    if (len < 2 || pos + len > n) return -1;
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 || marker == 0xC3 || marker == 0xC9 ||
        marker == 0xCA) {
      if (len < 7) return -1;
      hw[0] = be16(data + pos + 3);
      hw[1] = be16(data + pos + 5);
      return 0;
    }
    if (marker == 0xDA || marker == 0xD9) return -1;
    pos += len;
  }
  return -1;
}

// utils/jpeg.py:jpeg_decode_rgb: JPEG bytes -> out, uint8
// [height][width][3] (out_bytes = 3 height width). -> 0, or an error code
// (info[0] its value where the message names one); E_OUT_SIZE with
// info = (height, width) when out does not fit the decoded frame.
// libjpeg != 0: utils/jpeg.py's jpeg_decode_rgb(..., libjpeg=True).
int l2i_jpeg_decode(const uint8_t* data, long long n, uint8_t* out, long long out_bytes,
                    long long* info, int libjpeg) {
  try {
    return decode(data, n, out, out_bytes, info, libjpeg != 0);
  } catch (const std::bad_alloc&) {
    return E_NOMEM;
  }
}

}  // extern "C"
