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
//                                _idct_islow_simd, _upsample, _ycc_to_rgb,
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
  E_UNDEF_QUANT = -29, E_BAD_HUFF_TABLE = -30,
  E_FEW_INTERVALS = -32, E_SCAN_TRUNC = -34,
  E_NO_SCAN = -36, E_OUT_SIZE = -37, E_NOMEM = -38,
  E_BAD_PROGRESSION = -39, E_PROG_NO_EOI = -40,
  E_BAD_DAC = -42, E_PILLOW_BLOCK = -43, E_MARKER = -44, E_BAD_DRI = -45, E_BOMB = -46,
  E_BAD_LOSSLESS = -47, E_BAD_RESTART = -48, E_LOSSLESS_YCC = -49, E_LOSSLESS_YCCK = -50,
  E_LOSSLESS_NO_EOI = -51, E_LIBJPEG = -52, E_SECOND_SCAN = -53, E_RUNS_DRY = -54,
};
// utils/jpeg.py:PILLOW_MAX_PIXELS, Pillow's DecompressionBombError limit
constexpr long long kPillowMaxPixels = 2LL * (1024 * 1024 * 1024 / 4 / 3);
constexpr long long kPillowBlock = 65536;  // utils/jpeg.py:PILLOW_BLOCK

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
// version's IndexError). A bad code (no code in the next 16 bits) reads 17
// bits as a zero symbol (jdhuff.c, JWRN_HUFF_BAD_CODE).
// limit >= 0: libjpeg's run out of data (utils/jpeg.py:_huffman_intervals):
// no MCU of per_mcu blocks starts once more than `limit` bits are used;
// *n_done the blocks decoded.
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
    } else {  // a bad code: a 0 difference
      nb -= 17;
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
      } else {  // a bad code: the end of the block
        nb -= 17;
        break;
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
  bool past = false;
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
    if (!e[0]) {  // a bad code: jpeg_huff_decode reads 17 bits, gives 0
      nb -= 17;
      *sym = 0;
      return true;
    }
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
// _DC_refine, _AC_first and _AC_refine. -> false where a read fails
// (rd.past).
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
// upsampling, colour (utils/jpeg.py:_upsample, _ycc_to_rgb)
// ---------------------------------------------------------------------------

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

// utils/jpeg.py:_simd_butterfly: jidctint.c's 1-D ISLOW stage with c0 + c4,
// c0 - c4, c7 + c3 and c5 + c1 added in 16 bits, wrapping, as
// libjpeg-turbo's SSE2 and AVX2 ISLOW compute them (<< 13 written as a
// product: a left shift of a negative value is undefined in C++17)
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

// utils/jpeg.py:_idct_islow_simd: dequantise and inverse-transform a
// component's bh x bw blocks (64 int16 coefficients each in zigzag order,
// block raster order; quant the 64 steps in natural order) into its plane
// [bh * 8][bw * 8] as libjpeg-turbo computes them on x86-64 (16-bit
// dequantisation, pass 1's DC shortcut where rows 1-7 are zero, int16
// saturation after each pass, [-128, 127] before the +128)
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

// utils/jpeg.py:_next_marker: jdmarker.c next_marker from data[p] -> false
// at the end of the data; in fill mode the buffer's fake EOI there (at the
// 0xFF bytes the data ends with).
struct Marker {
  long long start = 0, after = 0;
  int code = 0;
};

bool next_marker(const uint8_t* data, long long n, long long p, bool fill, Marker* m) {
  for (long long q = p; q < n;) {
    const void* f = std::memchr(data + q, 0xFF, n - q);
    if (!f) break;
    q = static_cast<const uint8_t*>(f) - data;
    long long r = q + 1;
    while (r < n && data[r] == 0xFF) ++r;
    if (r >= n) break;
    if (data[r]) {
      m->start = q;
      m->code = data[r];
      m->after = r + 1;
      return true;
    }
    q = r + 1;  // a stuffed byte
  }
  if (!fill) return false;
  long long end = n;
  while (end > p && data[end - 1] == 0xFF) --end;
  m->start = end;
  m->code = 0xD9;
  m->after = n;
  return true;
}

// utils/jpeg.py:_resync: jpeg_resync_to_restart's action for `code` where
// RST`want` was due
int resync(int code, int want) {
  if (code < 0xC0) return 2;
  if (code < 0xD0 || code > 0xD7) return 3;
  if (code == 0xD0 + ((want + 1) & 7) || code == 0xD0 + ((want + 2) & 7)) return 3;
  if (code == 0xD0 + ((want - 1) & 7) || code == 0xD0 + ((want - 2) & 7)) return 2;
  return 1;
}

// utils/jpeg.py:_Walk: a scan's restart intervals as libjpeg reads them.
// limit < 0: none.
struct Walk {
  const uint8_t* data;
  long long n;
  bool fill;
  long long at, limit;
  bool unread = false;
  Marker mk;
  int rst = 0;
  int marker(long long p, bool check, Marker* m) const {
    if (!next_marker(data, n, p, fill, m)) return E_FEW_INTERVALS;
    if (check && limit >= 0 && m->after > limit) return E_PILLOW_BLOCK;
    return 0;
  }
  // the next interval's data [*a, *b); *at_eof where no marker follows
  // (Pillow mode) -> false where it starts at an unread marker
  bool interval(long long* a, long long* b, bool* at_eof) const {
    if (unread) return false;
    Marker m;
    *a = at;
    *at_eof = !next_marker(data, n, at, fill, &m);
    if (*at_eof) {
      long long end = n;
      while (end > at && data[end - 1] == 0xFF) --end;
      *b = end;
    } else {
      *b = m.start;
    }
    return true;
  }
  // read_restart_marker -> 0 or an error code; *stays whether a marker
  // stays unread
  int restart(bool met, bool* stays) {
    if (!unread) {
      const int rc = marker(at, !met, &mk);
      if (rc) return rc;
      unread = true;
    }
    while (true) {
      const int action = mk.code == 0xD0 + rst ? 1 : resync(mk.code, rst);
      if (action == 1) {
        at = mk.after;
        unread = false;
        break;
      }
      if (action == 3) break;
      const int rc = marker(mk.after, true, &mk);
      if (rc) return rc;
    }
    rst = (rst + 1) & 7;
    *stays = unread;
    return 0;
  }
  long long end() const { return unread ? mk.start : at; }
};

// utils/jpeg.py:_Walk.raw: an interval's bytes data[a, b) unstuffed into
// s.raw (a run of 0xFF then 0x00 is one 0xFF), zero-padded by `pad` bytes to
// a multiple of 4 -> its bits.
constexpr long long kFillPad = 4096;  // utils/jpeg.py:_FILL_PAD
long long unstuff_fill(const uint8_t* data, long long a, long long b, Scratch& s,
                       long long pad = kFillPad) {
  s.raw.clear();
  for (long long i = a; i < b; ++i) {
    s.raw.push_back(data[i]);
    if (data[i] == 0xFF) {
      long long r = i + 1;
      while (r < b && data[r] == 0xFF) ++r;
      if (r < b && data[r] == 0x00) i = r;
    }
  }
  const long long n_raw = static_cast<long long>(s.raw.size());
  s.raw.resize(n_raw + pad - n_raw % 4, 0);
  return 8 * n_raw;
}

// utils/jpeg.py:_runs_dry: does libjpeg-turbo, decoding the blocks of a
// sequential scan's last interval from data[start, n) to the end of the file,
// ever read ahead past that end, as Pillow feeds it PILLOW_BLOCK bytes at a
// time (avail: the end of what it has so far)? dcs, acs: the scan's
// sym_rows tables by index in the scan.
constexpr int kMinGetBits = 57, kBufSize = 512;
struct DryRun {
  const uint8_t* ub;
  const long long *ends, *unit_end;
  const char* multi_ff;
  long long n_units;
  long long avail;
  long long consumed = 0, units = 0, left = 0;  // bits consumed, units read, bits buffered
  void code(const int* lut, int* length, int* sym) const {
    const long long i = consumed >> 3;
    uint32_t w = 0;
    for (int k = 0; k < 4; ++k) w = (w << 8) | (i + k < n_units ? ub[i + k] : 0);
    const int* e = lut + 2 * ((w >> (16 - (consumed & 7))) & 0xFFFF);
    *length = e[0] ? e[0] : 17;
    *sym = e[1];
  }
  bool fill() {  // false: suspended
    while (left < kMinGetBits) {
      if (units >= n_units || ends[units] > avail) return false;
      ++units;
      left += 8;
    }
    return true;
  }
  bool need(int k) { return left >= k || fill(); }
  void take(int k) {
    consumed += k;
    left -= k;
  }
  bool huff_slow(const int* lut, int* sym) {
    if (!need(8)) return false;
    int length = 0;
    code(lut, &length, sym);
    if (length <= 8) {
      take(length);
      return true;
    }
    if (!need(9)) return false;
    take(9);
    for (int k = 9; k < length; ++k) {
      if (!need(1)) return false;
      take(1);
    }
    return true;
  }
  bool fill_fast() {  // false: a 0xFF 0xFF pair, read as a marker
    if (left > 16) return true;
    for (int k = 0; k < 6; ++k) {
      if (units >= n_units || multi_ff[units]) return false;
      ++units;
      left += 8;
    }
    return true;
  }
  bool huff_fast(const int* lut, int* sym) {
    if (!fill_fast()) return false;
    int length = 0;
    code(lut, &length, sym);
    take(length);
    return true;
  }
  bool mcu(const int* sel, long long count, const int* const* dcs, const int* const* acs,
           bool fast) {
    for (long long b = 0; b < count; ++b) {
      const int ci = sel[b];
      int s = 0;
      if (!(fast ? huff_fast(dcs[ci], &s) : huff_slow(dcs[ci], &s))) return false;
      if (s) {
        if (!(fast ? fill_fast() : need(s))) return false;
        take(s);
      }
      for (int k = 1; k < 64; ++k) {
        int rs = 0;
        if (!(fast ? huff_fast(acs[ci], &rs) : huff_slow(acs[ci], &rs))) return false;
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (!(fast ? fill_fast() : need(s))) return false;
          take(s);
        } else if (r != 15) {
          break;
        } else {
          k += 15;
        }
      }
    }
    return true;
  }
};

bool runs_dry(const uint8_t* data, long long n, long long start, const int* sel,
              long long n_blocks, long long per_mcu, const int* const* dcs,
              const int* const* acs, int restart, long long avail) {
  std::vector<uint8_t> ub;
  std::vector<long long> ends, unit_end{start};
  std::vector<char> multi_ff;
  for (long long p = start; p < n;) {
    const uint8_t c = data[p];
    long long q = p + 1;
    if (c == 0xFF) {
      while (q < n && data[q] == 0xFF) ++q;
      if (q >= n) break;  // 0xFF bytes that end the file
      multi_ff.push_back(q - p > 1);
      ++q;  // the stuffed 0x00
    } else {
      multi_ff.push_back(0);
    }
    ub.push_back(c);
    ends.push_back(q);
    unit_end.push_back(q);
    p = q;
  }
  DryRun d{ub.data(), ends.data(), unit_end.data(), multi_ff.data(),
           static_cast<long long>(ub.size()), avail < n ? avail : n};
  for (long long m = 0; m < n_blocks; m += per_mcu) {
    const long long count = n_blocks - m < per_mcu ? n_blocks - m : per_mcu;
    while (true) {
      const long long c0 = d.consumed, u0 = d.units, l0 = d.left;
      const bool fast = !restart && d.avail - d.unit_end[d.units] >= kBufSize * per_mcu;
      if (fast && d.mcu(sel + m, count, dcs, acs, true)) break;
      d.consumed = c0, d.units = u0, d.left = l0;  // a marker: the slow path decodes it
      if (d.mcu(sel + m, count, dcs, acs, false)) break;
      d.consumed = c0, d.units = u0, d.left = l0;  // suspended
      if (d.avail >= n) return true;
      d.avail = d.avail + kPillowBlock < n ? d.avail + kPillowBlock : n;
    }
  }
  return false;
}

// utils/jpeg.py:_decode_scan: one sequential scan into s.coef; limit: the
// end of Pillow's reads so far.
int decode_scan(Frame& fr, const uint8_t* body, long long blen, const uint8_t* data,
                long long n, long long pos, const std::vector<int64_t>* qt, const bool* qt_def,
                const HuffTable* dc_tabs, const HuffTable* ac_tabs, int restart, long long limit,
                Scratch& s, long long* end_out, long long* info) {
  const int ns = blen ? body[0] : 0;
  if (!valid_sos(fr, body, blen, ns)) return E_BAD_SOS;
  std::vector<int> comps;
  std::vector<const int*> dcls, acls, dsyms, asyms;
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
    dsyms.push_back(sym_rows(dc_tabs[t >> 4], true));
    asyms.push_back(sym_rows(ac_tabs[t & 15], false));
  }
  // Ss, Se, Ah, Al other than 0, 63, 0, 0: JWRN_NOT_SEQUENTIAL, read as they were

  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  s.out_ac.resize(static_cast<size_t>(n_blocks) * 63);  // at most 63 a block
  s.out_dc.resize(n_blocks);
  std::vector<char> done(n_blocks, 0);
  std::vector<int64_t> preds(ns);
  long long total = 0;
  const long long per_interval = span * per_mcu;
  // utils/jpeg.py:_huffman_intervals: short is jdhuff.c's insufficient_data
  Walk walk{data, n, fr.libjpeg, pos, -1};
  bool short_ = false;
  for (long long k = 0; k < n_int; ++k) {
    if (k) {
      bool stays = false;
      const int rc = walk.restart(false, &stays);
      if (rc) return rc;
      if (!stays) short_ = false;
    }
    if (short_) continue;
    long long a = 0, b = 0;
    bool at_eof = false;
    if (!walk.interval(&a, &b, &at_eof)) a = b = 0;
    const long long bits = unstuff_fill(data, a, b, s);
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    long long n_ac = 0, n_done = 0;
    for (int i = 0; i < ns; ++i) preds[i] = 0;
    const long long used = decode_interval(
        s.raw.data(), static_cast<long long>(s.raw.size()), s.blk.data() + lo,
        s.sel.data() + lo, hi - lo, dcls.data(), acls.data(), s.out_ac.data() + total, &n_ac,
        s.out_dc.data() + lo, preds.data(), per_mcu, bits, &n_done);
    if (used == -1) return E_SCAN_TRUNC;
    for (long long i = lo; i < lo + n_done; ++i) done[i] = 1;
    total += n_ac;
    if (at_eof && used > bits) return E_SCAN_TRUNC;
    if (at_eof) {
      const long long blocks_in = kPillowBlock * (1 + (walk.at - 1) / kPillowBlock);
      if (runs_dry(data, n, walk.at, s.sel.data() + lo, hi - lo, per_mcu, dsyms.data(),
                   asyms.data(), restart, limit > blocks_in ? limit : blocks_in))
        return E_RUNS_DRY;
    }
    short_ = used > bits;
  }
  for (long long i = 0; i < n_blocks; ++i)
    if (done[i]) s.coef[s.blk[i] * 64] = static_cast<int16_t>(s.out_dc[i]);  // JCOEF
  for (long long i = 0; i < total; ++i) {  // past 63: libjpeg's padded natural order
    const long long ac = s.out_ac[i], k = (ac >> 16) & 127;
    s.coef[(ac >> 23) * 64 + (k < 63 ? k : 63)] =
        static_cast<int16_t>(static_cast<uint16_t>(ac & 0xFFFF));
  }
  *end_out = walk.end();
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
  // jdphuff.c start_pass_phuff_decoder's checks (a scan out of the
  // progression's order is JWRN_BOGUS_PROGRESSION: read as it is)
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
  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  const long long per_interval = span * per_mcu;
  Walk walk{data, n, fr.libjpeg, pos, -1};
  bool short_ = false;
  long long last = -1;
  for (long long k = 0; k < n_int; ++k) {
    if (k) {
      bool stays = false;
      const int rc = walk.restart(false, &stays);
      if (rc) return rc;
      if (!stays) short_ = false;
    }
    if (short_) continue;
    long long a = 0, b = 0;
    bool at_eof = false;
    if (!walk.interval(&a, &b, &at_eof)) a = b = 0;
    const long long bits = unstuff_fill(data, a, b, s);
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    Bits rd{s.raw.data(), static_cast<long long>(s.raw.size()) / 4};
    long long started = -1;
    const bool ok = progressive_interval(rd, s.blk.data() + lo, s.sel.data() + lo, hi - lo,
                                         luts.data(), s.coef.data(), ss, se, ah, al, per_mcu,
                                         bits, &started);
    if (!ok) return E_SCAN_TRUNC;
    if (started >= 0) last = lo + started;
    if (at_eof && rd.used() > bits) return E_SCAN_TRUNC;
    short_ = rd.used() > bits;
  }
  if (last >= 0) {  // libjpeg-turbo's last_good_iMCU_row: the last MCU decoded with data
    const int c = comps[s.sel[last]];
    fr.last_good = (s.blk[last] - fr.offset[c] / fr.per) / fr.bw[c] / fr.v[c];
  }
  *end_out = walk.end();
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
      const bool late = fr.last_good >= 0 && i > fr.last_good;
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
  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  const long long per_interval = span * per_mcu;
  const long long row = per_row * per_mcu;  // the samples of an MCU row: one decode_mcus call
  std::vector<char> fresh(n_mcu / per_row + 1, 0);  // MCU rows undifferenced afresh
  fresh[0] = 1;
  Walk walk{data, n, false, pos, -1};
  bool short_ = false;  // jdhuff.c's insufficient_data
  for (long long b = 0; b < n_blocks; ++b) s.coef[s.blk[b]] = 0;
  for (long long k = 0; k < n_int; ++k) {
    if (k) {
      bool stays = false;
      const int rc = walk.restart(false, &stays);
      if (rc) return rc;
      if (!stays) short_ = false;
      fresh[k * span / per_row] = 1;
    }
    long long a = 0, b = 0;
    bool at_eof = false;
    if (!walk.interval(&a, &b, &at_eof)) a = b = 0;
    if (at_eof) return E_LOSSLESS_NO_EOI;  // libjpeg-turbo reads ahead, and Pillow has no more
    const long long bits = unstuff_fill(data, a, b, s, kFillPad + 4 * row);
    Bits rd{s.raw.data(), static_cast<long long>(s.raw.size()) / 4};
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    for (long long r0 = lo; r0 < hi; r0 += row) {
      if (short_) {  // zero differences, the predictors restarted
        fresh[r0 / row] = 1;
        continue;
      }
      bool ok = true;
      for (long long b = r0; b < r0 + row && ok; ++b) {
        int sym = 0;
        int64_t v = 0;
        ok = rd.huff(luts[s.sel[b]], &sym);
        if (ok && sym == 16) {
          v = 32768;
        } else if (ok && sym) {
          int64_t vb = 0;
          ok = rd.get(sym, &vb);
          v = extend(vb, sym);
        }
        s.coef[s.blk[b]] = w16(v);
      }
      if (!ok) return E_SCAN_TRUNC;
      short_ = rd.used() > bits;
    }
  }
  for (int c : comps) {
    const int w = fr.dw(c), h = fr.dh(c), v = ns == 1 ? 1 : fr.v[c];
    std::vector<char> first(h, 0);
    for (long long m = 0; m < static_cast<long long>(fresh.size()); ++m)
      if (fresh[m] && m * v < h) first[m * v] = 1;
    fr.samples[c].assign(static_cast<size_t>(h) * w, 0);
    undifference(s.coef.data() + fr.offset[c], fr.bw[c], h, w, psv, pt, first,
                 fr.samples[c].data());
    fr.pt[c] = pt;
  }
  *end_out = walk.end();
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
  }  // a sequential scan's Ss, Se, Ah, Al: JWRN_NOT_SEQUENTIAL, read as 0, 63, 0, 0
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
  const long long per_mcu = scan_blocks(fr, comps, s);
  const long long n_blocks = static_cast<long long>(s.blk.size());
  const long long n_mcu = n_blocks / per_mcu;
  const long long span = restart ? restart : n_mcu;
  const long long n_int = (n_mcu + span - 1) / span;
  const long long per_interval = span * per_mcu;
  // libjpeg mode: the fake EOI, a marker, zeros past the data, no limit
  const long long lim = fr.libjpeg ? n + 2 : limit;
  Walk walk{data, n, fr.libjpeg, pos, fr.libjpeg ? -1 : limit};
  static thread_local uint8_t dcs[16][64], acs[16][256];
  bool met = true;
  for (long long k = 0; k < n_int; ++k) {
    if (k) {  // read_restart_marker reads to the marker unless the decoder met it
      bool stays = false;
      const int rc = walk.restart(met, &stays);
      if (rc) return rc;
    }
    std::memset(dcs, 0, sizeof(dcs));  // statistics reset at every restart
    std::memset(acs, 0, sizeof(acs));
    long long a = 0, b = 0;
    bool at_eof = false;
    const bool has = walk.interval(&a, &b, &at_eof);
    if (!has) a = b = walk.end();  // a marker left unread: zeros
    ArithBits rd{data, a, b, lim, at_eof};
    rd.marker = !has;
    const long long lo = k * per_interval;
    const long long hi = lo + per_interval < n_blocks ? lo + per_interval : n_blocks;
    arith_interval(rd, s.blk.data() + lo, s.sel.data() + lo, hi - lo, dtab, atab, dcs, acs,
                   dac, s.coef.data(), fr.progressive, ss, se, ah, al);
    if (rd.err) return rd.err;
    met = rd.marker;
  }
  *end_out = walk.end();
  return 0;
}

// utils/jpeg.py:_STD_DC, _STD_AC: jstdhuff.c's tables (T.81 K.3), DC and AC,
// luminance (slot 0) and chrominance (slot 1): 16 counts, then the symbols
const uint8_t kStdDc[2][28] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const char* const kStdAc[2] = {
    "0002010303020403050504040000017d"
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718"
    "191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475"
    "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    "00020102040403040705040400010277"
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125"
    "f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a7374"
    "75767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
    "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"};

void std_table(HuffTable& t, const uint8_t* counts_then_symbols, int n_symbols) {
  t.defined = true;
  std::memcpy(t.counts, counts_then_symbols, 16);
  t.symbols.assign(counts_then_symbols + 16, counts_then_symbols + 16 + n_symbols);
}

void std_tables(HuffTable* dc_tabs, HuffTable* ac_tabs) {
  for (int k = 0; k < 2; ++k) {
    if (!dc_tabs[k].defined) std_table(dc_tabs[k], kStdDc[k], 12);
    if (!ac_tabs[k].defined) {
      uint8_t bytes[16 + 162];
      const char* hex = kStdAc[k];
      for (int i = 0; i < 16 + 162; ++i) {
        auto nib = [](char c) { return c <= '9' ? c - '0' : c - 'a' + 10; };
        bytes[i] = static_cast<uint8_t>(nib(hex[2 * i]) << 4 | nib(hex[2 * i + 1]));
      }
      std_table(ac_tabs[k], bytes, 162);
    }
  }
}

// utils/jpeg.py:_tail_end: the end of what Pillow has handed libjpeg once a
// single-scan image's scan (its data ending at `end`) is decoded
long long tail_end(const uint8_t* data, long long n, long long end, long long limit, bool arith) {
  if (arith) return limit < n ? limit : n;
  Marker m;
  if (!next_marker(data, n, end, false, &m)) return n;
  const long long blocks = kPillowBlock * (1 + (m.after - 1) / kPillowBlock);
  const long long got = limit > blocks ? limit : blocks;
  return got < n ? got : n;
}

// utils/jpeg.py:_runs_out: does libjpeg, reading a marker segment cut short
// by the end of the file (seg, its length field on), run out of data
// before it finds fault with it?
bool runs_out(int marker, const uint8_t* seg, long long avail) {
  if (avail < 2) return true;
  long long n = be16(seg) - 2;
  if (n < 0) return false;
  const uint8_t* body = seg + 2;
  const long long have = avail - 2;
  if (marker == 0xDD) return n == 2;  // get_dri checks the length first
  if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 || marker == 0xC3 || marker == 0xC9 ||
      marker == 0xCA)
    return false;
  if (marker == 0xC4) {  // get_dht: each table's counts, then its symbols
    long long i = 0;
    while (n > 16) {
      if (i + 17 > have) return true;
      long long count = 0;
      for (int k = 1; k <= 16; ++k) count += body[i + k];
      n -= 17;
      if (count > 256 || count > n) return false;
      if (i + 17 + count > have) return true;
      if ((body[i] & 0x0F) > 3 || (body[i] >> 4) > 1) return false;
      n -= count;
      i += 17 + count;
    }
    return false;
  }
  if (marker == 0xDB) return have == 0 || (body[0] & 0x0F) <= 3;  // get_dqt
  if (marker == 0xCC) {  // get_dac
    for (long long i = 0; i + 1 < have; i += 2) {
      const int index = body[i], val = body[i + 1];
      if (index >= 32 || (index < 16 && (val & 15) > (val >> 4))) return false;
    }
    return true;
  }
  if (marker == 0xDA)  // get_sos: its length against its component count
    return have == 0 || (body[0] >= 1 && body[0] <= 4 && n == 4 + 2 * body[0]);
  return true;
}

// utils/jpeg.py:_start_scan: an SOS marker's checks before its scan ->
// 0 or an error code; *multi: has_multiple_scans
int start_scan(const Frame& fr, bool have_frame, const uint8_t* body, long long blen, int scans,
               bool* multi, HuffTable* dc_tabs, HuffTable* ac_tabs) {
  if (!have_frame) return E_SCAN_NO_FRAME;
  if (scans == 0) {
    if (!(fr.progressive || fr.arith || fr.lossless)) std_tables(dc_tabs, ac_tabs);
    *multi = fr.progressive || (blen ? body[0] : 0) < fr.n;
    return 0;
  }
  return *multi ? 0 : E_SECOND_SCAN;
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
  bool jfif = false, have_frame = false, eoi = false, extended = false, multi = true;
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
    if (pos + 2 > n || be16(data + pos) < 2 || pos + be16(data + pos) > n) {
      // a single-scan image is out: jpeg_finish_decompress suspends, and
      // Pillow keeps the image
      if (!lj && !multi && runs_out(marker, data + pos, n - pos)) break;
      return E_SEGMENT;
    }
    const long long len = be16(data + pos);
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
      const int sc = start_scan(fr, have_frame, body, blen, scans, &multi, dc_tabs, ac_tabs);
      if (sc) return sc;
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
                            restart, limit, s, &after, info);
      if (rc) return rc;
      // the image is out: jpeg_finish_decompress reads the rest from
      // Pillow's read so far, and a suspension ends the decode
      if (!lj && !multi) n = tail_end(data, n, after, limit, fr.arith);
    }
    pos = after;
  }
  if (!have_frame) return E_NO_SCAN;
  if (lj) {  // jpeg_read_header's JERR_NO_IMAGE; the rest read as it came
    if (!scans) return E_NO_SCAN;
  } else {
    for (int c = 0; c < fr.n; ++c)
      if (!fr.scanned[c]) return E_NO_SCAN;
    // more scans may have been to come: jpeg_start_decompress reads to the EOI
    if (multi && !eoi && !fr.lossless) return info[0] = fr.progressive, E_PROG_NO_EOI;
  }
  if (fr.progressive && smoothed(fr)) smooth(fr, s.coef);

  if (fr.lossless) {  // utils/jpeg.py:_assemble_lossless's colour spaces
    if (multi && !eoi) return E_LOSSLESS_NO_EOI;  // jpeg_start_decompress reads to the EOI
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
    idct_plane_simd(s.coef.data() + fr.offset[c], q, fr.bh[c], fr.bw[c], s.plane.data());
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
// the decode reads past the words (a bad code reads 17 bits as a zero
// symbol).
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
