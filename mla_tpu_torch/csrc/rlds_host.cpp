// Host loops of the RLDS data pipeline and the VLM stage's image loader,
// loaded through ctypes by mla_tpu_torch/native/rlds_host.py. Each is
// sequential (a CRC's running state, a PNG row's dependence on its left
// pixel and the row above, an LZW code's dependence on the table its
// predecessors built, a PackBits run's on the header before it, a fax
// row's on the row above, a float sum in a fixed tap order) and too slow
// in Python, or, for the
// Lanczos kernel's sines, must be the C library's float sin. Built with
// -ffp-contract=off: the resampling sums must round after every multiply
// and every add, as TensorFlow's CPU kernel does.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), slice by 8
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

const Crc32cTables kCrc;

uint32_t crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xffffffffu;
  while (n >= 8) {
    const uint32_t lo = c ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24);
    c = kCrc.t[7][lo & 0xff] ^ kCrc.t[6][(lo >> 8) & 0xff] ^ kCrc.t[5][(lo >> 16) & 0xff] ^ kCrc.t[4][lo >> 24] ^
        kCrc.t[3][p[4]] ^ kCrc.t[2][p[5]] ^ kCrc.t[1][p[6]] ^ kCrc.t[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) c = kCrc.t[0][(c ^ *p++) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// TFRecord's masked CRC-32C of n bytes
uint32_t rlds_masked_crc32c(const uint8_t* data, size_t n) {
  const uint32_t c = crc32c(data, n);
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

// PNG un-filtering: `raw` holds `height` rows of a filter-type byte and
// `stride` bytes; `out` gets height x stride bytes. bpp is the bytes per
// complete pixel (at least 1). Returns 0, or the 1-based row of an unknown
// filter type.
int rlds_png_unfilter(const uint8_t* raw, int height, int stride, int bpp, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw + size_t(y) * (stride + 1);
    const int ftype = src[0];
    ++src;
    uint8_t* row = out + size_t(y) * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    switch (ftype) {
      case 0:
        for (int i = 0; i < stride; ++i) row[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < stride; ++i) row[i] = uint8_t(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) row[i] = uint8_t(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0, above = up ? up[i] : 0;
          row[i] = uint8_t(src[i] + ((left + above) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0, above = up ? up[i] : 0;
          const int corner = (up && i >= bpp) ? up[i - bpp] : 0;
          row[i] = uint8_t(src[i] + paeth(left, above, corner));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// GIF's LZW: `n` bytes of code stream (the data sub-blocks joined), codes
// of min_code + 1 bits growing to 12, the clear code 1 << min_code and the
// end code after it, as giflib decodes them. Writes `npix` indices into
// out and stops there. Returns 0, 1 where the data ends (or an end code
// comes) before npix pixels, 2 for a code past the table.
int rlds_gif_lzw(const uint8_t* data, int64_t n, int min_code, uint8_t* out, int64_t npix) {
  const int clear = 1 << min_code, eoi = clear + 1;
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint8_t stack[4097];
  for (int i = 0; i < clear; ++i) prefix[i] = 0xffff, suffix[i] = first[i] = uint8_t(i);
  int size = min_code + 1, next = clear + 2, prev = -1;
  uint32_t acc = 0;
  int bits = 0;
  int64_t pos = 0, o = 0;
  while (o < npix) {
    while (bits < size) {
      if (pos >= n) return 1;
      acc |= uint32_t(data[pos++]) << bits;
      bits += 8;
    }
    const int code = int(acc & ((1u << size) - 1));
    acc >>= size;
    bits -= size;
    if (code == clear) {
      size = min_code + 1, next = clear + 2, prev = -1;
      continue;
    }
    if (code == eoi) return 1;
    if (prev < 0) {
      if (code >= clear) return 2;
      out[o++] = uint8_t(code);
      prev = code;
      continue;
    }
    int c = code, sp = 0;
    uint8_t head;
    if (code < next) {
      head = first[code];
    } else if (code == next && next < 4096) {
      head = first[prev];
      stack[sp++] = head;  // KwKwK: the previous string and its own first byte
      c = prev;
    } else {
      return 2;
    }
    while (c >= clear) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    stack[sp++] = uint8_t(c);
    while (sp && o < npix) out[o++] = stack[--sp];
    if (next < 4096) {
      prefix[next] = uint16_t(prev), suffix[next] = head, first[next] = first[prev];
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    prev = code;
  }
  return 0;
}

// sin of n floats in float, as the C library computes it: TensorFlow's
// Lanczos kernel calls std::sin(float), and its weights follow these values
void rlds_sinf(const float* x, size_t n, float* out) {
  for (size_t i = 0; i < n; ++i) out[i] = std::sin(x[i]);
}

// One vertical pass of TensorFlow's ScaleAndTranslate (GatherRows): output
// row y is the sum over its span of weight x input row starts[y] + j, in
// tap order, from 0.0f; `row_len` floats a row; weights [out_h, span].
void rlds_resample_rows(const float* in, int in_h, int row_len, const int32_t* starts, const float* weights,
                        int span, int out_h, float* out) {
  for (int y = 0; y < out_h; ++y) {
    float* o = out + size_t(y) * row_len;
    for (int i = 0; i < row_len; ++i) o[i] = 0.0f;
    const int taps = (starts[y] + span < in_h ? starts[y] + span : in_h) - starts[y];
    const float* w = weights + size_t(y) * span;
    const float* r = in + size_t(starts[y]) * row_len;
    for (int j = 0; j < taps; ++j, r += row_len) {
      const float wj = w[j];
      for (int i = 0; i < row_len; ++i) o[i] += wj * r[i];
    }
  }
}

// One horizontal pass (GatherColumns): output pixel x of each of `h` rows
// is the sum over its span of weight x input pixel starts[x] + j, in tap
// order, from 0.0f; `ch` channels a pixel; weights [out_w, span].
void rlds_resample_cols(const float* in, int h, int in_w, int ch, const int32_t* starts, const float* weights,
                        int span, int out_w, float* out) {
  for (int y = 0; y < h; ++y) {
    const float* row = in + size_t(y) * in_w * ch;
    float* o = out + size_t(y) * out_w * ch;
    for (int x = 0; x < out_w; ++x, o += ch) {
      const int taps = (starts[x] + span < in_w ? starts[x] + span : in_w) - starts[x];
      const float* w = weights + size_t(x) * span;
      const float* p = row + size_t(starts[x]) * ch;
      for (int c = 0; c < ch; ++c) o[c] = 0.0f;
      for (int j = 0; j < taps; ++j, p += ch)
        for (int c = 0; c < ch; ++c) o[c] += w[j] * p[c];
    }
  }
}

// TIFF's LZW (compression 5), as libtiff decodes it: codes MSB first, 9
// bits growing to 12 one code early (when the next free entry is 511, 1023
// or 2047), the clear code 256 and the end code 257; the table may grow
// past 4096 entries that no 12-bit code reaches, as libtiff's does. Writes
// `n_out` bytes and stops there. Returns 0, 1 where the data ends (or an
// end code comes) before n_out bytes, 2 for a code past the table.
int rlds_tiff_lzw(const uint8_t* data, int64_t n, uint8_t* out, int64_t n_out) {
  constexpr int kClear = 256, kEnd = 257, kSize = 5119;
  static thread_local uint16_t prefix[kSize];
  static thread_local uint8_t suffix[kSize], first[kSize];
  static thread_local uint16_t length[kSize];
  static thread_local uint8_t stack[kSize + 1];
  for (int i = 0; i < 256; ++i) prefix[i] = 0xffff, suffix[i] = first[i] = uint8_t(i), length[i] = 1;
  int bits = 9, next = 258, prev = -1;
  uint64_t acc = 0;
  int held = 0;
  int64_t pos = 0, o = 0;
  while (o < n_out) {
    while (held < bits) {
      if (pos >= n) return 1;
      acc = (acc << 8) | data[pos++];
      held += 8;
    }
    const int code = int((acc >> (held - bits)) & ((1u << bits) - 1));
    held -= bits;
    if (code == kClear) {
      bits = 9, next = 258, prev = -1;
      continue;
    }
    if (code == kEnd) return 1;
    if (prev < 0) {
      if (code > kClear) return 2;
      out[o++] = uint8_t(code);
      prev = code;
      continue;
    }
    if (code > next || next >= kSize) return 2;
    // the new entry: the previous string and the first byte of this one (of itself where code == next)
    prefix[next] = uint16_t(prev), length[next] = uint16_t(length[prev] + 1), first[next] = first[prev];
    suffix[next] = code < next ? first[code] : first[prev];
    ++next;
    if (next == (1 << bits) - 1 && bits < 12) ++bits;
    int c = code, sp = 0;
    while (c >= 256) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    stack[sp++] = uint8_t(c);
    while (sp && o < n_out) out[o++] = stack[--sp];
    prev = code;
  }
  return 0;
}

// PackBits (TIFF compression 32773), as libtiff decodes it: a header n of
// 0..127 copies n + 1 bytes, -127..-1 repeats the next byte 1 - n times,
// -128 does nothing; a run past n_out is cut there. Returns 0, or 1 where
// the data ends before n_out bytes.
int rlds_packbits(const uint8_t* data, int64_t n, uint8_t* out, int64_t n_out) {
  int64_t pos = 0, o = 0;
  while (pos < n && o < n_out) {
    int h = int8_t(data[pos++]);
    if (h == -128) continue;
    if (h < 0) {
      int64_t k = 1 - h;
      if (k > n_out - o) k = n_out - o;
      if (pos >= n) break;
      const uint8_t b = data[pos++];
      while (k--) out[o++] = b;
    } else {
      int64_t k = h + 1;
      if (k > n_out - o) k = n_out - o;
      if (pos + k > n) break;
      for (int64_t i = 0; i < k; ++i) out[o++] = data[pos++];
    }
  }
  return o < n_out ? 1 : 0;
}

}  // extern "C"

namespace {

// The fax codes' bit reader: MSB first, zeros past the end (libtiff pads a
// code whose last bits are missing with zeros; only a code that starts past
// the data is an end).
struct FaxBits {
  const uint8_t* data;
  int64_t nbits, pos = 0;
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      const int64_t p = pos + i;
      v = (v << 1) | (p < nbits ? (data[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  bool empty() const { return pos >= nbits; }
};

// One code through a 13-bit lookup table of (length, value); returns false
// at the end of the data or on a bad code (err set to 1 or 2).
inline bool fax_code(FaxBits& b, const int32_t* table, int32_t& value, int& err) {
  if (b.empty()) {
    err = 1;
    return false;
  }
  const uint32_t w = b.peek(13);
  const int len = table[2 * w];
  if (len == 0) {
    err = 2;
    return false;
  }
  value = table[2 * w + 1];
  b.pos += len;
  return true;
}

// A run of one colour: makeup codes (64 and up) then a terminating code
// (0..63). Returns -1 and sets err on failure (an EOL inside a row too).
inline int fax_run(FaxBits& b, const int32_t* table, int& err) {
  int run = 0;
  for (;;) {
    int32_t v;
    if (!fax_code(b, table, v, err)) return -1;
    if (v < 0) {
      err = 2;
      return -1;
    }
    run += v;
    if (v < 64) return run;
  }
}

}  // namespace

extern "C" {

// CCITT fax decoding into rows of bits, 1 for black, as libtiff's fax
// codec writes them: kind 0 is Modified Huffman (TIFF compression 2, each
// row byte-aligned), 1 T.4 1-D and 2 T.4 2-D (compression 3; every row
// after an EOL, which may follow fill bits, and in 2-D a tag bit saying
// which coding follows), 3 T.6 (compression 4, 2-D against the row above,
// an all-white row above the first). `white`, `black` and `modes` are
// 8192 x (length, value) lookup tables of the next 13 bits: a run length
// (makeup codes 64 and up), -1 for an EOL; for modes 0..6 the vertical
// offsets -3..3, 7 pass, 8 horizontal, 9 the extension code, -1 EOL.
// `out` gets rows x ceil(width / 8) bytes. Returns 0; 1 where the data ends
// before the last row; 2 for a bad code, an EOL inside a row or a row whose
// runs do not add up to its width; 3 for uncompressed mode (the extension
// code), which is not decoded.
int rlds_ccitt(const uint8_t* data, int64_t n, int kind, int width, int rows, const int32_t* white,
               const int32_t* black, const int32_t* modes, uint8_t* out) {
  FaxBits b{data, n * 8};
  const int64_t rowbytes = (int64_t(width) + 7) / 8;
  std::vector<int> ref, cur;  // changing elements, ref padded with two at the width
  ref.reserve(width + 4), cur.reserve(width + 4);
  ref.assign({width, width});
  int err = 0;
  for (int y = 0; y < rows; ++y) {
    bool two_d = kind == 3;
    if (kind == 1 || kind == 2) {  // the EOL: eleven zeros, any more zeros (fill), a one
      for (;;) {
        if (b.pos + 11 > b.nbits) return 1;
        if (b.peek(11) == 0) break;
        ++b.pos;
      }
      b.pos += 11;
      for (;;) {
        if (b.empty()) return 1;
        const uint32_t bit = b.peek(1);
        ++b.pos;
        if (bit) break;
      }
      if (kind == 2) {
        if (b.empty()) return 1;
        two_d = b.peek(1) == 0;
        ++b.pos;
      }
    }
    cur.clear();
    int a0 = 0, colour = 0;  // 0 white, 1 black
    bool start = true;
    if (!two_d) {
      while (a0 < width) {
        const int run = fax_run(b, colour ? black : white, err);
        if (run < 0) return err;
        a0 += run;
        if (a0 > width) return 2;
        cur.push_back(a0);
        colour ^= 1;
      }
    } else {
      size_t i = 0;  // the search for b1 starts here in ref
      while (a0 < width) {
        // b1: the first change of ref right of a0 (at a0 too at the row's start) to the colour opposite a0's
        while (i < ref.size() && (start ? ref[i] < a0 : ref[i] <= a0)) ++i;
        if ((i & 1) != size_t(colour)) ++i;
        const int b1 = i < ref.size() ? ref[i] : width, b2 = i + 1 < ref.size() ? ref[i + 1] : width;
        int32_t mode;
        if (!fax_code(b, modes, mode, err)) return err;
        if (mode < 0) return 2;
        if (mode == 9) return 3;
        if (mode == 7) {  // pass
          a0 = b2;
          start = false;
        } else if (mode == 8) {  // horizontal: a run of a0's colour, then one of the other
          const int r1 = fax_run(b, colour ? black : white, err);
          if (r1 < 0) return err;
          const int r2 = fax_run(b, colour ? white : black, err);
          if (r2 < 0) return err;
          const int a1 = a0 + r1, a2 = a1 + r2;
          if (a2 > width) return 2;
          cur.push_back(a1), cur.push_back(a2);
          a0 = a2;
          start = false;
        } else {  // vertical: a1 = b1 + (mode - 3)
          const int a1 = b1 + mode - 3;
          if (a1 < a0 || a1 > width) return 2;
          cur.push_back(a1);
          a0 = a1;
          colour ^= 1;
          start = false;
          if (i > 0) --i;  // a later b1 may lie left of this one's successor
        }
      }
    }
    uint8_t* row = out + y * rowbytes;
    std::memset(row, 0, rowbytes);
    for (size_t k = 0; k + 1 <= cur.size(); k += 2) {  // black from cur[k] to cur[k + 1]
      const int x0 = cur[k], x1 = k + 1 < cur.size() ? cur[k + 1] : width;
      for (int x = x0; x < x1 && x < width; ++x) row[x >> 3] |= uint8_t(0x80 >> (x & 7));
    }
    ref.assign(cur.begin(), cur.end());
    ref.push_back(width), ref.push_back(width);
    if (kind == 0) b.pos = (b.pos + 7) & ~int64_t(7);
  }
  return 0;
}

}  // extern "C"
