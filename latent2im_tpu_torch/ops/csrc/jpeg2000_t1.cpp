// Host C++ of utils/jpeg2000.py's tier-1 (_t1_block): OpenJPEG 2.5's MQ
// decoder and its significance, refinement and cleanup passes over every
// code-block that tier-2 gathered, equal to the Python version bit for bit.
// Tier-2, dequantization, the DWT and the colour steps stay numpy; the MQ
// loop is what takes seconds in Python at photo size. Not a GPU kernel:
// nvcc hands it to the host compiler, and it links into the kernels'
// library (ops/_build.py).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

// (Qe, next index on MPS, next index on LPS, switch): ISO 15444-1 Table C.2
const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
    0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum { kSC = 9, kMag = 14, kAgg = 17, kUni = 18 };
enum { kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kSegSym = 32 };

struct MQ {
  uint8_t state[19][2];  // {index, mps}
  std::vector<uint8_t> buf;
  size_t bp = 0;
  uint32_t c = 0, a = 0;
  int ct = 0;

  void reset() {
    std::memset(state, 0, sizeof(state));
    state[kUni][0] = 46;
    state[kAgg][0] = 3;
    state[0][0] = 4;
  }

  void bytein() {
    if (buf[bp] == 0xFF) {
      if (buf[bp + 1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(buf[bp]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(buf[bp]) << 8;
      ct = 8;
    }
  }

  void init(const uint8_t* p, int len, bool raw) {
    buf.assign(p, p + len);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    bp = 0;
    if (raw) {
      c = 0;
      ct = 0;
      return;
    }
    c = static_cast<uint32_t>(len ? buf[0] : 0xFF) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int decode(int cx) {
    uint8_t* st = state[cx];
    const uint32_t qe = kQe[st[0]];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = st[1];
        st[0] = kNmps[st[0]];
      } else {
        d = 1 - st[1];
        if (kSwitch[st[0]]) st[1] = static_cast<uint8_t>(d);
        st[0] = kNlps[st[0]];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return st[1];
      if (a < qe) {
        d = 1 - st[1];
        if (kSwitch[st[0]]) st[1] = static_cast<uint8_t>(d);
        st[0] = kNlps[st[0]];
      } else {
        d = st[1];
        st[0] = kNmps[st[0]];
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
    return d;
  }

  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (buf[bp] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = buf[bp++];
          ct = 7;
        }
      } else {
        c = buf[bp++];
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// [orient][h][v][d] -> zero-coding context (ISO 15444-1 Table D.1)
int zc_table[4][3][3][5];

void init_tables() {
  for (int o = 0; o < 4; ++o)
    for (int h = 0; h < 3; ++h)
      for (int v = 0; v < 3; ++v)
        for (int d = 0; d < 5; ++d) {
          int hh = o == 1 ? v : h, vv = o == 1 ? h : v, c;
          if (o == 3) {
            int hv = hh + vv;
            if (d >= 3) c = 8;
            else if (d == 2) c = hv >= 1 ? 7 : 6;
            else if (d == 1) c = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
            else c = hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
          } else if (hh == 2) {
            c = 8;
          } else if (hh == 1) {
            c = vv >= 1 ? 7 : (d >= 1 ? 6 : 5);
          } else {
            c = vv == 2 ? 4 : (vv == 1 ? 3 : (d >= 2 ? 2 : (d == 1 ? 1 : 0)));
          }
          zc_table[o][h][v][d] = c;
        }
}

struct Block {
  int w, h, W;
  std::vector<uint8_t> sig, neg, vis, ref;
  std::vector<int32_t> val;
  bool vsc;

  Block(int w_, int h_, bool vsc_) : w(w_), h(h_), W(w_ + 2), vsc(vsc_) {
    size_t n = static_cast<size_t>(W) * (h + 2);
    sig.assign(n, 0);
    neg.assign(n, 0);
    vis.assign(n, 0);
    ref.assign(n, 0);
    val.assign(n, 0);
  }

  void nb(int i, int y, int& hh, int& vv, int& dd) const {
    bool south = !(vsc && y % 4 == 3);
    hh = sig[i - 1] + sig[i + 1];
    vv = sig[i - W] + (south ? sig[i + W] : 0);
    dd = sig[i - W - 1] + sig[i - W + 1] + (south ? sig[i + W - 1] + sig[i + W + 1] : 0);
  }

  int con(int j) const { return sig[j] ? (neg[j] ? -1 : 1) : 0; }

  void sign_ctx(int i, int y, int& cx, int& xb) const {
    bool south = !(vsc && y % 4 == 3);
    int hc = con(i - 1) + con(i + 1);
    int vc = con(i - W) + (south ? con(i + W) : 0);
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    // Table D.3: (1,1) 13, (1,0) 12, (1,-1) 11, (0,1) 10, (0,0) 9, then mirrored with xor 1
    static const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};  // [1 - hc][1 - vc]
    cx = ctx[1 - hc][1 - vc];
    xb = (hc < 0 || (hc == 0 && vc < 0)) ? 1 : 0;
  }
};

// One code-block -> out [h * w] at twice the coefficients' size; -2 at 31 or
// more bit planes.
int decode_block(const uint8_t* data, const int32_t* segs, int nsegs, int numbps, int orient,
                 int sty, int w, int h, int roishift, int32_t* out) {
  std::memset(out, 0, sizeof(int32_t) * static_cast<size_t>(w) * h);
  if (!w || !h) return 0;
  int bpno = roishift + numbps;
  if (bpno >= 31) return -2;
  Block b(w, h, (sty & kVsc) != 0);
  const int W = b.W;
  MQ mq;
  mq.reset();
  const int(*zc)[3][5] = zc_table[orient];
  int passtype = 2;
  size_t pos = 0;
  auto decode_sign = [&](int i, int y, bool raw) {
    if (raw) return mq.raw();
    int cx, xb;
    b.sign_ctx(i, y, cx, xb);
    return mq.decode(cx) ^ xb;
  };
  for (int s = 0; s < nsegs; ++s) {
    const int length = segs[2 * s], npasses = segs[2 * s + 1];
    const bool raw = (sty & kLazy) && passtype < 2 && bpno <= numbps - 4;
    mq.init(data + pos, length, raw);
    pos += static_cast<size_t>(length);
    for (int p = 0; p < npasses; ++p) {
      if (bpno < 1) break;
      const int32_t one = int32_t(1) << bpno, half = one >> 1, oph = one | half;
      if (passtype == 0) {
        for (int y0 = 0; y0 < h; y0 += 4)
          for (int x = 0; x < w; ++x)
            for (int y = y0; y < y0 + 4 && y < h; ++y) {
              int i = (y + 1) * W + x + 1, hh, vv, dd;
              if (b.sig[i]) continue;
              b.nb(i, y, hh, vv, dd);
              if (!(hh || vv || dd)) continue;
              b.vis[i] = 1;
              int bit = raw ? mq.raw() : mq.decode(zc[hh][vv][dd]);
              if (bit) {
                b.neg[i] = static_cast<uint8_t>(decode_sign(i, y, raw));
                b.sig[i] = 1;
                b.val[i] = oph;
              }
            }
      } else if (passtype == 1) {
        for (int y0 = 0; y0 < h; y0 += 4)
          for (int x = 0; x < w; ++x)
            for (int y = y0; y < y0 + 4 && y < h; ++y) {
              int i = (y + 1) * W + x + 1;
              if (!b.sig[i] || b.vis[i]) continue;
              int bit;
              if (raw) {
                bit = mq.raw();
              } else {
                int cx;
                if (b.ref[i]) {
                  cx = kMag + 2;
                } else {
                  int hh, vv, dd;
                  b.nb(i, y, hh, vv, dd);
                  cx = kMag + ((hh || vv || dd) ? 1 : 0);
                }
                bit = mq.decode(cx);
              }
              b.val[i] += bit ? half : -half;
              b.ref[i] = 1;
            }
      } else {
        for (int y0 = 0; y0 < h; y0 += 4)
          for (int x = 0; x < w; ++x) {
            int y = y0;
            if (y0 + 4 <= h) {
              bool run = true;
              for (int k = 0; k < 4 && run; ++k) {
                int i = (y0 + k + 1) * W + x + 1, hh, vv, dd;
                b.nb(i, y0 + k, hh, vv, dd);
                if (b.sig[i] || b.vis[i] || hh || vv || dd) run = false;
              }
              if (run) {
                if (!mq.decode(kAgg)) continue;
                int k = mq.decode(kUni) << 1;
                k |= mq.decode(kUni);
                y = y0 + k;
                int i = (y + 1) * W + x + 1;
                b.neg[i] = static_cast<uint8_t>(decode_sign(i, y, false));
                b.sig[i] = 1;
                b.val[i] = oph;
                ++y;
              }
            }
            for (; y < y0 + 4 && y < h; ++y) {
              int i = (y + 1) * W + x + 1, hh, vv, dd;
              if (b.sig[i] || b.vis[i]) continue;
              b.nb(i, y, hh, vv, dd);
              if (mq.decode(zc[hh][vv][dd])) {
                b.neg[i] = static_cast<uint8_t>(decode_sign(i, y, false));
                b.sig[i] = 1;
                b.val[i] = oph;
              }
            }
          }
        if (sty & kSegSym)
          for (int k = 0; k < 4; ++k) mq.decode(kUni);
        std::fill(b.vis.begin(), b.vis.end(), 0);
      }
      if ((sty & kReset) && !raw) mq.reset();
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
  }
  const int32_t thresh = roishift ? (int32_t(1) << roishift) : 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int i = (y + 1) * W + x + 1;
      int32_t v = b.val[i];
      if (roishift && v >= thresh) v >>= roishift;
      out[static_cast<size_t>(y) * w + x] = b.neg[i] ? -v : v;
    }
  return 0;
}

}  // namespace

// data: every block's bytes one after another; meta [n][8] {bytes, segments,
// numbps, orient, style, w, h, roishift}; segs [total segments][2] {length,
// passes}; out: each block's [h][w] one after another -> 0, -1 out of memory,
// -2 a block of 31 or more bit planes (what the Python version raises for).
extern "C" int l2i_j2k_t1(const uint8_t* data, const int32_t* meta, const int32_t* segs, int n,
                          int32_t* out) {
  static const bool ready = (init_tables(), true);
  (void)ready;
  try {
    size_t at = 0, seg = 0, o = 0;
    for (int k = 0; k < n; ++k) {
      const int32_t* m = meta + 8 * k;
      int rc = decode_block(data + at, segs + 2 * seg, m[1], m[2], m[3], m[4], m[5], m[6], m[7],
                            out + o);
      if (rc) return rc;
      at += static_cast<size_t>(m[0]);
      seg += static_cast<size_t>(m[1]);
      o += static_cast<size_t>(m[5]) * m[6];
    }
  } catch (const std::bad_alloc&) {
    return -1;
  }
  return 0;
}
