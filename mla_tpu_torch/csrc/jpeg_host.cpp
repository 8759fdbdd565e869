// Host loops of the port's JPEG decoder, loaded through ctypes by
// mla_tpu_torch/native/jpeg_host.py: the entropy decoding of one scan
// (Huffman, baseline and progressive, restart intervals), the two integer
// inverse DCTs of libjpeg-turbo (jidctfst.c's fast AAN one, which
// TensorFlow's decode_image runs, and jidctint.c's accurate one, which
// Pillow runs), its fancy upsampling (jdsample.c) and its fixed-point
// YCbCr -> RGB conversion (jdcolor.c). The markers are parsed in Python
// (vla/rlds/jpeg.py); each function here has a plain version beside its
// wrapper, and the two give the same bytes.

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <initializer_list>

namespace {

// zigzag index -> natural (row-major) index of an 8 x 8 block
const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
                          41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
                          30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// the AAN scale factors of jddctmgr.c, 14 fractional bits
const int32_t kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,  19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,  4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

struct Error {
  char* msg;
  int len;
  int fail(const char* text) {
    if (len > 0) snprintf(msg, len, "%s", text);
    return 1;
  }
};

// A Huffman table in decoding form: for each code length, the largest code
// and the offset from a code to its value's index; a 9-bit lookahead.
struct Huffman {
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];
  uint16_t look[512];  // (length << 8) | value, 0 where the code is longer than 9 bits

  // bits[l - 1] codes of length l, values in order; false where the counts
  // overflow the code space
  bool build(const uint8_t* bits, const uint8_t* values) {
    int code = 0, k = 0;
    memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      valoff[l] = k - code;
      for (int i = 0; i < bits[l - 1]; ++i, ++code, ++k) {
        if (k >= 256) return false;
        vals[k] = values[k];
        if (l <= 9)
          for (int j = code << (9 - l); j < (code + 1) << (9 - l); ++j) look[j] = uint16_t((l << 8) | values[k]);
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      if (code >= (1 << l)) return false;  // no code may be all ones
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // never reached: the slow path stops at 16
    return true;
  }
};

// The bit reader of one entropy-coded segment: 0xFF 0x00 is a data byte
// 0xFF, any other marker ends the data. Past the data it supplies zero
// bits, and counts them: a decode that consumes one has run past its data.
struct Bits {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t acc = 0;
  int bits = 0;
  int phantom = 0;  // zero bits in acc that lie past the data (always its lowest)
  bool at_marker = false;
  int64_t marker = 0;  // where the marker (or the end of the data) starts

  void restart(int64_t at) {
    pos = at;
    acc = 0;
    bits = phantom = 0;
    at_marker = false;
  }
  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
          marker = n;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          int64_t p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;
          if (p < n && d[p] == 0x00) {
            b = 0xFF;
            pos = p + 1;
          } else {
            at_marker = true;
            marker = pos;
          }
        }
      }
      if (at_marker) phantom += 8;
      acc = (acc << 8) | b;
      bits += 8;
    }
  }
  bool overrun() const { return bits < phantom; }
  int peek(int k) {
    if (bits < k) fill();
    return int((acc >> (bits - k)) & ((1u << k) - 1));
  }
  int get(int k) {
    if (k == 0) return 0;
    const int v = peek(k);
    bits -= k;
    return v;
  }
  // the value of a Huffman code, or -1 for a code no table holds
  int decode(const Huffman& h) {
    if (bits < 16) fill();
    const int look = h.look[(acc >> (bits - 9)) & 511];
    if (look) {
      bits -= look >> 8;
      return look & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      const int code = int((acc >> (bits - l)) & ((1u << l) - 1));
      if (code <= h.maxcode[l]) {
        bits -= l;
        return h.vals[code + h.valoff[l]];
      }
    }
    return -1;
  }
};

// F.12's EXTEND: a value of s bits to its signed coefficient
inline int extend(int v, int s) { return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v); }

struct ScanComp {
  int h, v, stride, bw, bh, dc, ac;
  int16_t* coef;
  int pred;
};


// The QM-coder of ITU T.81 Annex D as jdarith.c runs it: `c`, `a` and
// `ct` its registers, the Qe table packed as libjpeg packs it
// ((Qe << 16) | (next MPS << 8) | (switch << 7) | next LPS). A marker
// inside the data stops the input, and zeros are fed from there, as the
// standard allows; reading past the end of the data is a truncation.
struct Arith {
  const uint8_t* d;
  int64_t n, pos;
  const int32_t* tab;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false, past_end = false;
  int64_t marker = 0;
  int byte() {
    if (at_marker) return 0;
    if (pos >= n) {
      past_end = true;
      return 0;
    }
    int b = d[pos++];
    if (b != 0xFF) return b;
    int64_t p = pos;
    while (p < n && d[p] == 0xFF) ++p;
    if (p >= n) {
      past_end = true;
      return 0;
    }
    if (d[p] == 0) {
      pos = p + 1;
      return 0xFF;
    }
    at_marker = true;
    marker = pos - 1;
    return 0;
  }
  void restart(int64_t at) {
    pos = at, c = 0, a = 0, ct = -16, at_marker = false;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = tab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

}  // namespace

extern "C" {

// Entropy-decode one arithmetic-coded scan (jdarith.c), with the arguments
// of jpeg_decode_scan but for the tables: `cond` holds the conditioning of
// the DAC segments, [DC L of tables 0..3, DC U of 0..3, AC K of 0..3], and
// `aritab` the 114 packed Qe entries. A spectral or magnitude overflow
// stops the scan's decoding as libjpeg does (a warning there). Returns 0,
// or 1 with a message.
int jpeg_decode_scan_arith(const uint8_t* data, int64_t n, int64_t start, const int32_t* scan, const int32_t* comps,
                           int16_t* const* coefs, const int32_t* cond, const int32_t* aritab, int64_t* end, char* err,
                           int errlen) {
  Error e{err, errlen};
  const int ns = scan[0], Ss = scan[1], Se = scan[2], Ah = scan[3], Al = scan[4], interval = scan[5];
  const int mcus_x = scan[6], mcus_y = scan[7], progressive = scan[8];
  if (ns < 1 || ns > 4) return e.fail("a scan of no or more than 4 components");
  ScanComp sc[4];
  for (int i = 0; i < ns; ++i) {
    const int32_t* c = comps + 8 * i;
    sc[i] = ScanComp{c[0], c[1], c[2], c[3], c[4], c[5], c[6], coefs[i], 0};
  }
  static thread_local uint8_t dc_stats[4][64], ac_stats[4][256];
  int dc_context[4] = {0, 0, 0, 0};
  uint8_t fixed = 113;
  auto reset = [&]() {
    for (int i = 0; i < ns; ++i) {
      if (!progressive || (Ss == 0 && Ah == 0)) memset(dc_stats[sc[i].dc], 0, 64);
      if (!progressive || Ss) memset(ac_stats[sc[i].ac], 0, 256);
      sc[i].pred = 0;
      dc_context[i] = 0;
    }
  };
  reset();
  Arith ar{data, n, start, aritab};
  const int64_t total = ns == 1 ? int64_t(sc[0].bw) * sc[0].bh : int64_t(mcus_x) * mcus_y;
  const int p1 = 1 << Al, m1 = -(1 << Al);
  bool stopped = false;  // after a spectral or magnitude overflow
  int rst = 0;
  auto block_at = [&](const ScanComp& c, int64_t row, int64_t col) { return c.coef + (row * c.stride + col) * 64; };
  // F.1.4.4.1 / G.1.3.1: a DC difference of component i into b[0]
  auto dc_diff = [&](int i, int& out) -> bool {
    ScanComp& c = sc[i];
    uint8_t* st = dc_stats[c.dc] + dc_context[i];
    if (ar.decode(st) == 0) {
      dc_context[i] = 0;
      out = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = dc_stats[c.dc] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    if (m < int((1L << cond[c.dc]) >> 1)) dc_context[i] = 0;
    else if (m > int((1L << cond[4 + c.dc]) >> 1)) dc_context[i] = 12 + sign * 4;
    else dc_context[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    out = sign ? -v : v;
    return true;
  };
  // F.1.4.4.2 / G.1.3.2: an AC magnitude at band position k, its st at SP
  auto ac_value = [&](int tbl, int k, uint8_t* st, int& out) -> bool {
    const int sign = ar.decode(&fixed);
    st += 2;
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= cond[8 + tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    out = sign ? -v : v;
    return true;
  };
  auto decode_block = [&](int i, int16_t* b) -> bool {
    ScanComp& c = sc[i];
    if (!progressive || (Ss == 0 && Ah == 0)) {
      int diff;
      if (!dc_diff(i, diff)) return false;
      c.pred = (c.pred + diff) & 0xFFFF;
      b[0] = int16_t(progressive ? int16_t(c.pred) * (1 << Al) : int16_t(c.pred));
      if (progressive) return true;
    } else if (Ss == 0) {
      if (ar.decode(&fixed)) b[0] = int16_t(b[0] | p1);
      return true;
    }
    const int lo = progressive ? Ss : 1, hi = progressive ? Se : 63;
    if (!progressive || Ah == 0) {
      for (int k = lo; k <= hi; ++k) {
        uint8_t* st = ac_stats[c.ac] + 3 * (k - 1);
        if (ar.decode(st)) break;
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++k > hi) return false;
        }
        int v;
        if (!ac_value(c.ac, k, st, v)) return false;
        b[kNatural[k]] = int16_t(progressive ? v * (1 << Al) : v);
      }
      return true;
    }
    int kex = Se;
    for (; kex > 0; --kex)
      if (b[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = ac_stats[c.ac] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;
      for (;;) {
        int16_t* coef = b + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2)) *coef = int16_t(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = int16_t(ar.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) return false;
      }
    }
    return true;
  };
  for (int64_t m = 0; m < total; ++m) {
    if (interval && m && m % interval == 0) {
      int64_t p = ar.at_marker ? ar.marker : ar.pos;
      // the marker reader skips anything up to the next marker
      for (;;) {
        while (p < n && data[p] != 0xFF) ++p;
        while (p < n && data[p] == 0xFF) ++p;
        if (p >= n) return e.fail("the data ends inside a scan (truncated)");
        if (data[p] != 0) break;
        ++p;
      }
      if (data[p] != 0xD0 + (rst & 7)) return e.fail("a missing or misnumbered restart marker");
      ++rst;
      ar.restart(p + 1);
      reset();
      stopped = false;
    }
    if (!stopped) {
      bool ok = true;
      if (ns == 1) {
        ScanComp& c = sc[0];
        ok = decode_block(0, block_at(c, m / c.bw, m % c.bw));
      } else {
        const int64_t my = m / mcus_x, mx = m % mcus_x;
        for (int i = 0; i < ns && ok; ++i)
          for (int y = 0; y < sc[i].v && ok; ++y)
            for (int x = 0; x < sc[i].h && ok; ++x)
              ok = decode_block(i, block_at(sc[i], my * sc[i].v + y, mx * sc[i].h + x));
      }
      stopped = !ok;
    }
    if (ar.past_end) return e.fail("the data ends inside a scan (truncated)");
  }
  int64_t p = ar.at_marker ? ar.marker : ar.pos;
  for (;;) {  // the next marker, past any bytes the decoder left
    while (p < n && data[p] != 0xFF) ++p;
    int64_t q = p;
    while (q < n && data[q] == 0xFF) ++q;
    if (q >= n) return e.fail("the data ends inside a scan (truncated)");
    if (data[q] != 0) {
      *end = p;
      return 0;
    }
    p = q + 1;
  }
}

// Entropy-decode one scan. `scan` holds [components in the scan, Ss, Se,
// Ah, Al, restart interval (MCUs, 0 for none), MCUs across, MCUs down,
// progressive]; `comps` 8 ints a component: [h, v, blocks a row of its
// coefficient array, blocks across and down that it codes alone, DC table
// slot, AC table slot, 0]; `coefs` a pointer a component to its int16
// [rows, stride, 64] coefficients in natural order, updated in place;
// `tables` 8 slots (4 DC, then 4 AC) of 16 counts and 256 values. The
// segment starts at data[start]; *end gets where the marker that ends it
// starts (n where the data ends first). Returns 0, or 1 with a message.
int jpeg_decode_scan(const uint8_t* data, int64_t n, int64_t start, const int32_t* scan, const int32_t* comps,
                     int16_t* const* coefs, const uint8_t* tables, int64_t* end, char* err, int errlen) {
  Error e{err, errlen};
  const int ns = scan[0], Ss = scan[1], Se = scan[2], Ah = scan[3], Al = scan[4], interval = scan[5];
  const int mcus_x = scan[6], mcus_y = scan[7], progressive = scan[8];
  if (ns < 1 || ns > 4) return e.fail("a scan of no or more than 4 components");
  Huffman huff[8];
  bool built[8] = {false};
  ScanComp sc[4];
  for (int i = 0; i < ns; ++i) {
    const int32_t* c = comps + 8 * i;
    sc[i] = ScanComp{c[0], c[1], c[2], c[3], c[4], c[5], 4 + c[6], coefs[i], 0};
    for (int slot : {sc[i].dc, sc[i].ac})
      if (!built[slot]) {
        if (!huff[slot].build(tables + 272 * slot, tables + 272 * slot + 16))
          return e.fail("a Huffman table whose counts overflow its code space");
        built[slot] = true;
      }
  }
  const bool dc_scan = Ss == 0, refine = Ah != 0;
  const int64_t total = ns == 1 ? int64_t(sc[0].bw) * sc[0].bh : int64_t(mcus_x) * mcus_y;
  const int p1 = 1 << Al, m1 = -(1 << Al);
  Bits br{data, n, start};
  int eobrun = 0, rst = 0;

  auto block_at = [&](const ScanComp& c, int64_t row, int64_t col) { return c.coef + (row * c.stride + col) * 64; };

  // one block of component c: returns 0, or 1 with a message
  auto decode_block = [&](ScanComp& c, int16_t* b) -> int {
    if (!progressive) {
      const int t = br.decode(huff[c.dc]);
      if (t < 0 || t > 15) return e.fail("a bad Huffman code in a DC coefficient");
      c.pred += extend(br.get(t), t);
      b[0] = int16_t(c.pred);
      for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(huff[c.ac]);
        if (rs < 0) return e.fail("a bad Huffman code in an AC coefficient");
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) return e.fail("an AC run past the end of its block");
          b[kNatural[k]] = int16_t(extend(br.get(s), s));
        } else if (r == 15) {
          k += 15;
        } else {
          break;
        }
      }
      return 0;
    }
    if (dc_scan) {
      if (!refine) {
        const int t = br.decode(huff[c.dc]);
        if (t < 0 || t > 15) return e.fail("a bad Huffman code in a DC coefficient");
        c.pred += extend(br.get(t), t);
        b[0] = int16_t(c.pred * (1 << Al));
      } else if (br.get(1)) {
        b[0] = int16_t(b[0] | p1);
      }
      return 0;
    }
    if (!refine) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return 0;
      }
      for (int k = Ss; k <= Se; ++k) {
        const int rs = br.decode(huff[c.ac]);
        if (rs < 0) return e.fail("a bad Huffman code in an AC coefficient");
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > Se) return e.fail("an AC run past the end of its band");
          b[kNatural[k]] = int16_t(extend(br.get(s), s) * (1 << Al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = (1 << r) - 1;
          if (r) eobrun += br.get(r);
          break;
        }
      }
      return 0;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        const int rs = br.decode(huff[c.ac]);
        if (rs < 0) return e.fail("a bad Huffman code in an AC refinement");
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) return e.fail("an AC refinement of more than one bit");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = b + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= Se);
        if (s) {
          if (k > Se) return e.fail("an AC refinement past the end of its band");
          b[kNatural[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* coef = b + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
    return 0;
  };

  for (int64_t m = 0; m < total; ++m) {
    if (interval && m && m % interval == 0) {
      // the interval's data must end here: at most its last byte's padding
      br.fill();
      if (!br.at_marker || br.bits - br.phantom >= 8) return e.fail("data past the end of a restart interval");
      int64_t p = br.marker;
      while (p < n && data[p] == 0xFF) ++p;
      if (p >= n) return e.fail("the data ends inside a scan (truncated)");
      if (data[p] != 0xD0 + (rst & 7)) return e.fail("a missing or misnumbered restart marker");
      ++rst;
      br.restart(p + 1);
      for (int i = 0; i < ns; ++i) sc[i].pred = 0;
      eobrun = 0;
    }
    if (ns == 1) {
      ScanComp& c = sc[0];
      if (decode_block(c, block_at(c, m / c.bw, m % c.bw))) return 1;
    } else {
      const int64_t my = m / mcus_x, mx = m % mcus_x;
      for (int i = 0; i < ns; ++i)
        for (int y = 0; y < sc[i].v; ++y)
          for (int x = 0; x < sc[i].h; ++x)
            if (decode_block(sc[i], block_at(sc[i], my * sc[i].v + y, mx * sc[i].h + x))) return 1;
    }
    if (br.overrun()) return e.fail(br.marker >= n ? "the data ends inside a scan (truncated)"
                                                   : "a scan's data ends before its last block");
  }
  br.fill();
  if (!br.at_marker || br.bits - br.phantom >= 8) return e.fail("data past the end of a scan");
  *end = br.marker;
  return 0;
}

// Entropy-decode one scan of a lossless frame (ITU T.81 Annex H, as
// jdlhuff.c, jddiffct.c and jdlossls.c run it) and undo its prediction:
// `scan` holds [components, predictor (1..7), 0, 0, point transform,
// restart interval, MCUs across, MCUs down, sample precision]; `comps` 8
// ints a component: [h, v, samples a row of its plane, samples across and
// down that it codes alone, DC table slot, 0, 0]; `planes` a pointer a
// component to its int32 [rows, stride] samples, written with the values
// before the point transform is undone. An interleaved MCU is h x v samples
// of each component; the restart interval must cover whole MCU rows, and
// the first sample row of the scan and of each restart interval is
// predicted from 2^(P - Pt - 1) and its left neighbours. Returns 0, or 1
// with a message.
int jpeg_decode_scan_lossless(const uint8_t* data, int64_t n, int64_t start, const int32_t* scan, const int32_t* comps,
                              int32_t* const* planes, const uint8_t* tables, int64_t* end, char* err, int errlen) {
  Error e{err, errlen};
  const int ns = scan[0], predictor = scan[1], Pt = scan[4], interval = scan[5];
  const int mcus_x = scan[6], mcus_y = scan[7], precision = scan[8];
  if (ns < 1 || ns > 4) return e.fail("a scan of no or more than 4 components");
  Huffman huff[4];
  ScanComp sc[4];
  for (int i = 0; i < ns; ++i) {
    const int32_t* c = comps + 8 * i;
    sc[i] = ScanComp{c[0], c[1], c[2], c[3], c[4], c[5], 0, nullptr, 0};
    if (!huff[i].build(tables + 272 * c[5], tables + 272 * c[5] + 16))
      return e.fail("a Huffman table whose counts overflow its code space");
  }
  const int64_t per_row = ns == 1 ? sc[0].bw : mcus_x;
  const int64_t rows = ns == 1 ? sc[0].bh : mcus_y;
  if (interval && interval % per_row) return e.fail("a restart interval that is not a whole number of MCU rows");
  Bits br{data, n, start};
  int rst = 0;
  auto diff = [&](int i) -> int64_t {  // H.1.2.2: a difference, category 16 being 32768
    const int t = br.decode(huff[i]);
    if (t < 0 || t > 16) return INT64_MIN;
    if (t == 16) return 32768;
    return extend(br.get(t), t);
  };
  for (int64_t m = 0; m < rows * per_row; ++m) {
    if (interval && m && m % interval == 0) {
      br.fill();
      if (!br.at_marker || br.bits - br.phantom >= 8) return e.fail("data past the end of a restart interval");
      int64_t p = br.marker;
      while (p < n && data[p] == 0xFF) ++p;
      if (p >= n) return e.fail("the data ends inside a scan (truncated)");
      if (data[p] != 0xD0 + (rst & 7)) return e.fail("a missing or misnumbered restart marker");
      ++rst;
      br.restart(p + 1);
    }
    const int64_t my = m / per_row, mx = m % per_row;
    for (int i = 0; i < ns; ++i) {
      const int h = ns == 1 ? 1 : sc[i].h, v = ns == 1 ? 1 : sc[i].v;
      for (int y = 0; y < v; ++y)
        for (int x = 0; x < h; ++x) {
          const int64_t d = diff(i);
          if (d == INT64_MIN) return e.fail("a bad Huffman code in a sample difference");
          planes[i][(my * v + y) * sc[i].stride + mx * h + x] = int32_t(d);
        }
    }
    if (br.overrun()) return e.fail(br.marker >= n ? "the data ends inside a scan (truncated)"
                                                   : "a scan's data ends before its last sample");
  }
  br.fill();
  if (!br.at_marker || br.bits - br.phantom >= 8) return e.fail("data past the end of a scan");
  *end = br.marker;
  // undo the prediction, row by row (jdlossls.c's undifferencing)
  const int initial = 1 << (precision - Pt - 1);
  const int64_t reset = interval ? interval / per_row : rows;  // MCU rows a restart interval
  for (int i = 0; i < ns; ++i) {
    const int v = ns == 1 ? 1 : sc[i].v;
    const int64_t width = ns == 1 ? sc[i].bw : int64_t(mcus_x) * sc[i].h;
    int32_t* pl = planes[i];
    for (int64_t r = 0; r < rows * v; ++r) {
      int32_t* row = pl + r * sc[i].stride;
      const int32_t* up = row - sc[i].stride;
      if (r % (reset * v) == 0) {
        int ra = (row[0] + initial) & 0xFFFF;
        row[0] = ra;
        for (int64_t c = 1; c < width; ++c) row[c] = ra = (row[c] + ra) & 0xFFFF;
        continue;
      }
      int rb = up[0];
      int ra = row[0] = (row[0] + rb) & 0xFFFF;
      for (int64_t c = 1; c < width; ++c) {
        const int rc = rb;
        rb = up[c];
        int pred;
        switch (predictor) {
          case 1: pred = ra; break;
          case 2: pred = rb; break;
          case 3: pred = rc; break;
          case 4: pred = ra + rb - rc; break;
          case 5: pred = ra + ((rb - rc) >> 1); break;
          case 6: pred = rb + ((ra - rc) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
        row[c] = ra = (row[c] + pred) & 0xFFFF;
      }
    }
  }
  return 0;
}

// Dequantize and inverse-DCT `nblocks` blocks of int16 coefficients
// (natural order, [rows, cols, 64]) with the quantization table `qt`
// (natural order) into the uint8 plane [rows * 8, cols * 8]. method 0:
// jidctfst.c (IFAST), 1: jidctint.c (ISLOW), each with its range limit.
void jpeg_idct(const int16_t* coef, int rows, int cols, const uint16_t* qt, int method, uint8_t* out) {
  auto limit = [](int x) -> uint8_t {  // libjpeg's IDCT range-limit table: 10 bits, then clamp
    x = ((x & 1023) ^ 512) - 512 + 128;
    return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x));
  };
  const int64_t stride = int64_t(cols) * 8;
  if (method == 0) {
    int32_t mult[64];
    for (int i = 0; i < 64; ++i) mult[i] = (int32_t(qt[i]) * kAanScales[i] + (1 << 11)) >> 12;
    auto MUL = [](int32_t v, int32_t c) { return int32_t((int64_t(v) * c) >> 8); };
    // dequantize: an int product, wrapped as libjpeg's (only a 16-bit
    // quantization table can leave int range)
    auto DQ = [](int16_t c, int32_t m) { return int32_t(int64_t(c) * m); };
    for (int64_t bi = 0; bi < int64_t(rows) * cols; ++bi) {
      const int16_t* in = coef + bi * 64;
      int32_t ws[64];
      for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const int32_t* q = mult + c;
        int32_t* w = ws + c;
        if (!(ip[8] | ip[16] | ip[24] | ip[32] | ip[40] | ip[48] | ip[56])) {
          const int32_t dc = DQ(ip[0], q[0]);
          for (int r = 0; r < 8; ++r) w[8 * r] = dc;
          continue;
        }
        int32_t t0 = DQ(ip[0], q[0]), t1 = DQ(ip[16], q[16]), t2 = DQ(ip[32], q[32]), t3 = DQ(ip[48], q[48]);
        int32_t t10 = t0 + t2, t11 = t0 - t2, t13 = t1 + t3, t12 = MUL(t1 - t3, 362) - t13;
        t0 = t10 + t13;
        t3 = t10 - t13;
        t1 = t11 + t12;
        t2 = t11 - t12;
        int32_t t4 = DQ(ip[8], q[8]), t5 = DQ(ip[24], q[24]), t6 = DQ(ip[40], q[40]), t7 = DQ(ip[56], q[56]);
        const int32_t z13 = t6 + t5, z10 = t6 - t5, z11 = t4 + t7, z12 = t4 - t7;
        t7 = z11 + z13;
        t11 = MUL(z11 - z13, 362);
        const int32_t z5 = MUL(z10 + z12, 473);
        t10 = MUL(z12, 277) - z5;
        t12 = MUL(z10, -669) + z5;
        t6 = t12 - t7;
        t5 = t11 - t6;
        t4 = t10 + t5;
        w[0] = t0 + t7;
        w[56] = t0 - t7;
        w[8] = t1 + t6;
        w[48] = t1 - t6;
        w[16] = t2 + t5;
        w[40] = t2 - t5;
        w[32] = t3 + t4;
        w[24] = t3 - t4;
      }
      uint8_t* o = out + (bi / cols) * 8 * stride + (bi % cols) * 8;
      for (int r = 0; r < 8; ++r, o += stride) {
        const int32_t* w = ws + 8 * r;
        int32_t t10 = w[0] + w[4], t11 = w[0] - w[4], t13 = w[2] + w[6], t12 = MUL(w[2] - w[6], 362) - t13;
        const int32_t t0 = t10 + t13, t3 = t10 - t13, t1 = t11 + t12, t2 = t11 - t12;
        const int32_t z13 = w[5] + w[3], z10 = w[5] - w[3], z11 = w[1] + w[7], z12 = w[1] - w[7];
        const int32_t t7 = z11 + z13;
        t11 = MUL(z11 - z13, 362);
        const int32_t z5 = MUL(z10 + z12, 473);
        t10 = MUL(z12, 277) - z5;
        t12 = MUL(z10, -669) + z5;
        const int32_t t6 = t12 - t7, t5 = t11 - t6, t4 = t10 + t5;
        o[0] = limit((t0 + t7) >> 5);
        o[7] = limit((t0 - t7) >> 5);
        o[1] = limit((t1 + t6) >> 5);
        o[6] = limit((t1 - t6) >> 5);
        o[2] = limit((t2 + t5) >> 5);
        o[5] = limit((t2 - t5) >> 5);
        o[4] = limit((t3 + t4) >> 5);
        o[3] = limit((t3 - t4) >> 5);
      }
    }
    return;
  }
  // jidctint.c: 13 constant bits, 2 pass-1 bits, rounding descales
  auto ODD = [](int64_t t0, int64_t t1, int64_t t2, int64_t t3, int64_t out[4]) {
    const int64_t z1 = t0 + t3, z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
    const int64_t z5 = (z3 + z4) * 9633;
    t0 *= 2446;
    t1 *= 16819;
    t2 *= 25172;
    t3 *= 12299;
    const int64_t y1 = z1 * -7373, y2 = z2 * -20995, y3 = z3 * -16069 + z5, y4 = z4 * -3196 + z5;
    out[0] = t0 + y1 + y3;
    out[1] = t1 + y2 + y4;
    out[2] = t2 + y2 + y3;
    out[3] = t3 + y1 + y4;
  };
  for (int64_t bi = 0; bi < int64_t(rows) * cols; ++bi) {
    const int16_t* in = coef + bi * 64;
    int32_t ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* q = qt + c;
      int32_t* w = ws + c;
      if (!(ip[8] | ip[16] | ip[24] | ip[32] | ip[40] | ip[48] | ip[56])) {
        const int32_t dc = int32_t(int64_t(ip[0]) * q[0] * 4);
        for (int r = 0; r < 8; ++r) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * q[16], z3 = int64_t(ip[48]) * q[48];
      const int64_t z1 = (z2 + z3) * 4433;
      const int64_t e2 = z1 + z3 * -15137, e3 = z1 + z2 * 6270;
      z2 = int64_t(ip[0]) * q[0];
      z3 = int64_t(ip[32]) * q[32];
      const int64_t e0 = (z2 + z3) * 8192, e1 = (z2 - z3) * 8192;
      const int64_t t10 = e0 + e3, t13 = e0 - e3, t11 = e1 + e2, t12 = e1 - e2;
      int64_t o[4];
      ODD(int64_t(ip[56]) * q[56], int64_t(ip[40]) * q[40], int64_t(ip[24]) * q[24], int64_t(ip[8]) * q[8], o);
      auto D = [](int64_t x) { return int32_t((x + (1 << 10)) >> 11); };
      w[0] = D(t10 + o[3]);
      w[56] = D(t10 - o[3]);
      w[8] = D(t11 + o[2]);
      w[48] = D(t11 - o[2]);
      w[16] = D(t12 + o[1]);
      w[40] = D(t12 - o[1]);
      w[24] = D(t13 + o[0]);
      w[32] = D(t13 - o[0]);
    }
    uint8_t* op = out + (bi / cols) * 8 * stride + (bi % cols) * 8;
    for (int r = 0; r < 8; ++r, op += stride) {
      const int32_t* w = ws + 8 * r;
      const int64_t z2 = w[2], z3 = w[6];
      const int64_t z1 = (z2 + z3) * 4433;
      const int64_t e2 = z1 + z3 * -15137, e3 = z1 + z2 * 6270;
      const int64_t e0 = (int64_t(w[0]) + w[4]) * 8192, e1 = (int64_t(w[0]) - w[4]) * 8192;
      const int64_t t10 = e0 + e3, t13 = e0 - e3, t11 = e1 + e2, t12 = e1 - e2;
      int64_t o[4];
      ODD(w[7], w[5], w[3], w[1], o);
      auto D = [&](int64_t x) { return limit(int32_t((x + (int64_t(1) << 17)) >> 18)); };
      op[0] = D(t10 + o[3]);
      op[7] = D(t10 - o[3]);
      op[1] = D(t11 + o[2]);
      op[6] = D(t11 - o[2]);
      op[2] = D(t12 + o[1]);
      op[5] = D(t12 - o[1]);
      op[3] = D(t13 + o[0]);
      op[4] = D(t13 - o[0]);
    }
  }
}

// Upsample one component plane (`stride` bytes a row; its real samples
// cw x ch) by hf x vf (each 1 or 2) into out [out_h, out_w], as
// libjpeg-turbo's jdsample.c does with fancy upsampling: the triangle
// filter across (h2v1, h2v2, only where cw > 2, else the sample repeated)
// and down (h1v2, h2v2), the edge row or column standing for its missing
// neighbour; any other integral ratio (h4v1, h3v1, h1v4, ...) repeats each
// sample hf x vf times.
void jpeg_upsample(const uint8_t* in, int64_t stride, int cw, int ch, int hf, int vf, uint8_t* out, int out_w,
                   int out_h) {
  // fancy only for h2v1 and h2v2 (where cw > 2) and h1v2; any other
  // integral ratio repeats each sample (int_upsample)
  const bool fancy_h = hf == 2 && vf <= 2 && cw > 2;
  const bool fancy_v = vf == 2 && (hf == 1 || (hf == 2 && cw > 2));
  for (int r = 0; r < out_h; ++r) {
    uint8_t* o = out + int64_t(r) * out_w;
    const int i = r / vf;
    const uint8_t* row = in + int64_t(i < ch ? i : ch - 1) * stride;
    if (!fancy_v) {
      if (!fancy_h) {
        for (int c = 0; c < out_w; ++c) o[c] = row[c / hf];
        continue;
      }
      for (int c = 0; c < out_w; ++c) {
        const int k = c >> 1;
        if (c & 1)
          o[c] = k == cw - 1 ? row[k] : uint8_t((3 * row[k] + row[k + 1] + 2) >> 2);
        else
          o[c] = k == 0 ? row[0] : uint8_t((3 * row[k] + row[k - 1] + 1) >> 2);
      }
      continue;
    }
    const bool below = r & 1;
    int j = below ? i + 1 : i - 1;
    j = j < 0 ? 0 : (j > ch - 1 ? ch - 1 : j);
    const uint8_t* nb = in + int64_t(j) * stride;
    if (hf == 1) {
      const int bias = below ? 2 : 1;
      for (int c = 0; c < out_w; ++c) o[c] = uint8_t((3 * row[c] + nb[c] + bias) >> 2);
      continue;
    }
    for (int c = 0; c < out_w; ++c) {
      const int k = c >> 1;
      const int here = 3 * row[k] + nb[k];
      if (c & 1) {
        o[c] = k == cw - 1 ? uint8_t((here * 4 + 7) >> 4) : uint8_t((here * 3 + 3 * row[k + 1] + nb[k + 1] + 7) >> 4);
      } else {
        o[c] = k == 0 ? uint8_t((here * 4 + 8) >> 4) : uint8_t((here * 3 + 3 * row[k - 1] + nb[k - 1] + 8) >> 4);
      }
    }
  }
}

// jdcolor.c's YCbCr -> RGB: 16-bit fixed-point tables, each channel
// clamped to 0..255; n pixels, out interleaved RGB
void jpeg_ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n, uint8_t* out) {
  struct Tables {
    int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    Tables() {
      for (int i = 0; i < 256; ++i) {
        const int32_t x = i - 128;
        cr_r[i] = (91881 * x + 32768) >> 16;
        cb_b[i] = (116130 * x + 32768) >> 16;
        cr_g[i] = -46802 * x;
        cb_g[i] = -22554 * x + 32768;
      }
    }
  };
  static const Tables t;  // built once, thread-safely
  auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (int64_t i = 0; i < n; ++i) {
    const int yy = y[i];
    out[3 * i] = clamp(yy + t.cr_r[cr[i]]);
    out[3 * i + 1] = clamp(yy + ((t.cb_g[cb[i]] + t.cr_g[cr[i]]) >> 16));
    out[3 * i + 2] = clamp(yy + t.cb_b[cb[i]]);
  }
}

}  // extern "C"
