// Host loops of the port's WebP decoder, loaded through ctypes by
// mla_tpu_torch/native/webp_host.py: the VP8L (lossless) and VP8 (lossy)
// bitstreams decoded as libwebp decodes them, which TensorFlow's and
// Pillow's WebP decodes share. The RIFF container is read in Python
// (vla/rlds/webp.py); the tables of RFC 6386 are passed in from the
// wrapper. Each function here has a plain version beside its wrapper, and
// the two give the same bytes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Error {
  char* msg;
  int len;
  int fail(const char* text) {
    if (len > 0) snprintf(msg, len, "%s", text);
    return 1;
  }
};

// --------------------------------------------------------------------------
// VP8L
// --------------------------------------------------------------------------

struct LBits {
  const uint8_t* d;
  int64_t n, pos = 0;  // pos in bits
  bool over = false;   // a read past the data
  uint32_t peek(int k) const {
    uint64_t v = 0;
    const int64_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < n; ++i) v |= uint64_t(d[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((uint64_t(1) << k) - 1));
  }
  uint32_t read(int k) {
    if (pos + k > n * 8) {
      over = true;
      pos = n * 8;
      return 0;
    }
    const uint32_t v = peek(k);
    pos += k;
    return v;
  }
};

// A canonical code as a lookup of the next `bits` bits (least significant
// first, so each code reversed): (symbol, length); one symbol is a code of
// no bits.
struct Huffman {
  int bits = 0;
  std::vector<uint32_t> table;  // (symbol << 8) | length
  bool build(const std::vector<int>& lengths) {
    int nused = 0, last = 0, maxlen = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) ++nused, last = int(s), maxlen = lengths[s] > maxlen ? lengths[s] : maxlen;
    if (!nused) return false;
    if (nused == 1) {
      bits = 0;
      table.assign(1, uint32_t(last) << 8);
      return true;
    }
    bits = maxlen;
    table.assign(size_t(1) << bits, 0xffffffffu);
    int code = 0;
    for (int len = 1; len <= bits; ++len) {
      for (size_t s = 0; s < lengths.size(); ++s) {
        if (lengths[s] != len) continue;
        int rev = 0;
        for (int i = 0; i < len; ++i) rev |= ((code >> i) & 1) << (len - 1 - i);
        for (int hi = 0; hi < (1 << (bits - len)); ++hi) table[rev | (hi << len)] = (uint32_t(s) << 8) | uint32_t(len);
        ++code;
      }
      code <<= 1;
    }
    if (code != (1 << (bits + 1))) return false;
    for (uint32_t t : table)
      if (t == 0xffffffffu) return false;
    return true;
  }
  int read(LBits& br) const {
    if (!bits) return int(table[0] >> 8);
    const uint32_t t = table[br.peek(bits)];
    br.read(int(t & 0xff));
    return int(t >> 8);
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabets[5] = {256 + 24, 256, 256, 256, 40};

struct VP8L {
  LBits br;
  const uint8_t* code_to_plane;
  Error* err;

  bool read_code(int alphabet, Huffman* h) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {
      const int n = int(br.read(1)) + 1;
      const int first = int(br.read(br.read(1) ? 8 : 1));
      if (first >= alphabet) return !err->fail("corrupt WebP data (VP8L): a simple code's symbol past its alphabet");
      lengths[first] = 1;
      if (n == 2) {
        const int second = int(br.read(8));
        if (second >= alphabet) return !err->fail("corrupt WebP data (VP8L): a simple code's symbol past its alphabet");
        lengths[second] = 1;
      }
    } else {
      const int ncl = int(br.read(4)) + 4;
      std::vector<int> cl(19, 0);
      for (int i = 0; i < ncl; ++i) cl[kCodeLengthOrder[i]] = int(br.read(3));
      Huffman lc;
      if (!lc.build(cl)) return !err->fail("corrupt WebP data (VP8L): an incomplete or over-full Huffman code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int nbits = 2 + 2 * int(br.read(3));
        max_symbol = 2 + int(br.read(nbits));
        if (max_symbol > alphabet) return !err->fail("corrupt WebP data (VP8L): a code-length count past the alphabet");
      }
      int sym = 0, prev = 8;
      while (sym < alphabet) {
        if (max_symbol-- == 0) break;
        if (br.over) break;
        const int c = lc.read(br);
        if (c < 16) {
          lengths[sym++] = c;
          if (c) prev = c;
          continue;
        }
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int rep = int(br.read(kExtra[c - 16])) + kOffset[c - 16];
        if (sym + rep > alphabet) return !err->fail("corrupt WebP data (VP8L): a code-length run past the alphabet");
        for (int i = 0; i < rep; ++i) lengths[sym++] = c == 16 ? prev : 0;
      }
    }
    if (br.over) return !err->fail("corrupt WebP data (VP8L): the data ends inside the image (truncated)");
    if (!h->build(lengths)) {
      for (int l : lengths)
        if (l) return !err->fail("corrupt WebP data (VP8L): an incomplete or over-full Huffman code");
      return !err->fail("corrupt WebP data (VP8L): a Huffman code without symbols");
    }
    return true;
  }

  int copy_distance(int sym) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    return ((2 + (sym & 1)) << extra) + int(br.read(extra)) + 1;
  }

  int plane_distance(int xsize, int code) const {
    if (code > 120) return code - 120;
    const int d = code_to_plane[code - 1];
    const int dist = (d >> 4) * xsize + 8 - (d & 15);
    return dist >= 1 ? dist : 1;
  }

  static int sub(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

  bool stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = int(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) return !err->fail("corrupt WebP data (VP8L): a bad colour cache size");
    }
    int meta_bits = 0, ngroups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
      meta_bits = int(br.read(3)) + 2;
      if (!stream(sub(xsize, meta_bits), sub(ysize, meta_bits), false, &meta)) return false;
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        if (int(m) + 1 > ngroups) ngroups = int(m) + 1;
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Huffman> groups(size_t(ngroups) * 5);
    for (int g = 0; g < ngroups; ++g)
      for (int i = 0; i < 5; ++i)
        if (!read_code(kAlphabets[i] + (i == 0 ? cache_size : 0), &groups[size_t(g) * 5 + i])) return false;
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const int shift = 32 - cache_bits;
    out->assign(size_t(xsize) * ysize, 0);
    uint32_t* px = out->data();
    const int64_t n = int64_t(xsize) * ysize;
    int64_t pos = 0, cached = 0;
    const int mw = meta_bits ? sub(xsize, meta_bits) : 0;
    const Huffman* g = groups.data();
    auto group_at = [&](int64_t p) {
      const int y = int(p / xsize), x = int(p % xsize);
      return groups.data() + size_t(meta[size_t((y >> meta_bits) * mw + (x >> meta_bits))]) * 5;
    };
    auto insert = [&]() {
      while (cached < pos) {
        const uint32_t v = px[cached++];
        cache[(v * 0x1e35a7bdu) >> shift] = v;
      }
    };
    while (pos < n) {
      if (meta_bits && ((pos % xsize) & ((1 << meta_bits) - 1)) == 0) g = group_at(pos);
      const int code = g[0].read(br);
      if (code < 256) {
        const uint32_t r = uint32_t(g[1].read(br)), b = uint32_t(g[2].read(br)), a = uint32_t(g[3].read(br));
        px[pos++] = (a << 24) | (r << 16) | (uint32_t(code) << 8) | b;
      } else if (code < 256 + 24) {
        const int length = copy_distance(code - 256);
        const int dist = plane_distance(xsize, copy_distance(g[4].read(br)));
        if (dist > pos || pos + length > n) return !err->fail("corrupt WebP data (VP8L): a backward reference outside the image");
        for (int i = 0; i < length; ++i) px[pos + i] = px[pos + i - dist];
        pos += length;
        if (meta_bits && pos < n) g = group_at(pos);
      } else {
        const int key = code - 280;
        if (key >= cache_size) return !err->fail("corrupt WebP data (VP8L): a colour cache code past the cache");
        insert();
        px[pos++] = cache[key];
      }
      if (cache_size) insert();
      if (br.over) return !err->fail("corrupt WebP data (VP8L): the data ends inside the image (truncated)");
    }
    return true;
  }
};

inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int ch(uint32_t p, int s) { return int((p >> s) & 0xff); }

uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  int diff = 0;
  for (int s = 0; s < 32; s += 8) diff += std::abs(ch(l, s) - ch(tl, s)) - std::abs(ch(t, s) - ch(tl, s));
  return diff <= 0 ? t : l;
}

uint32_t predict(int mode, uint32_t left, uint32_t top, uint32_t tr, uint32_t tl) {
  switch (mode) {
    case 1: return left;
    case 2: return top;
    case 3: return tr;
    case 4: return tl;
    case 5: return avg2(avg2(left, tr), top);
    case 6: return avg2(left, tl);
    case 7: return avg2(left, top);
    case 8: return avg2(tl, top);
    case 9: return avg2(top, tr);
    case 10: return avg2(avg2(left, tl), avg2(top, tr));
    case 11: return select(top, left, tl);
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8) out |= uint32_t(clip255(ch(left, s) + ch(top, s) - ch(tl, s))) << s;
      return out;
    }
    case 13: {
      const uint32_t avg = avg2(left, top);
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8) out |= uint32_t(clip255(ch(avg, s) + (ch(avg, s) - ch(tl, s)) / 2)) << s;
      return out;
    }
    default: return 0xff000000u;
  }
}

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) | (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline int delta(int t, int c) { return (int(int8_t(t)) * int(int8_t(c))) >> 5; }

struct Transform {
  int kind, bits, xsize;
  std::vector<uint32_t> sub;
};

void inverse(const Transform& t, int ysize, std::vector<uint32_t>* px) {
  const int xsize = t.xsize;
  std::vector<uint32_t>& p = *px;
  if (t.kind == 2) {
    for (uint32_t& v : p) {
      const uint32_t g = (v >> 8) & 0xff;
      v = (v & 0xff00ff00u) | ((((v >> 16) + g) & 0xff) << 16) | ((v + g) & 0xff);
    }
    return;
  }
  const int sw = VP8L::sub(xsize, t.bits);
  if (t.kind == 0) {
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < xsize; ++x) {
        const size_t i = size_t(y) * xsize + x;
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xff000000u : p[i - 1];
        } else if (x == 0) {
          pred = p[i - xsize];
        } else {
          const int mode = int((t.sub[size_t((y >> t.bits) * sw + (x >> t.bits))] >> 8) & 15);
          pred = predict(mode, p[i - 1], p[i - xsize], p[i - xsize + 1], p[i - xsize - 1]);
        }
        p[i] = add_px(p[i], pred);
      }
    return;
  }
  if (t.kind == 1) {
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < xsize; ++x) {
        uint32_t& v = p[size_t(y) * xsize + x];
        const uint32_t m = t.sub[size_t((y >> t.bits) * sw + (x >> t.bits))];
        const int g = int((v >> 8) & 0xff);
        const int r = (int((v >> 16) & 0xff) + delta(int(m & 0xff), g)) & 0xff;
        const int b = (int(v & 0xff) + delta(int((m >> 8) & 0xff), g) + delta(int((m >> 16) & 0xff), r)) & 0xff;
        v = (v & 0xff00ff00u) | (uint32_t(r) << 16) | uint32_t(b);
      }
    return;
  }
  std::vector<uint32_t> pal(256, 0);
  for (size_t i = 0; i < t.sub.size() && i < 256; ++i) pal[i] = t.sub[i];
  std::vector<uint32_t> out(size_t(xsize) * ysize);
  if (t.bits == 0) {
    for (size_t i = 0; i < out.size(); ++i) out[i] = pal[(p[i] >> 8) & 0xff];
  } else {
    const int per = 1 << t.bits, width_bits = 8 >> t.bits, pw = VP8L::sub(xsize, t.bits);
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < xsize; ++x) {
        const uint32_t packed = (p[size_t(y) * pw + (x >> t.bits)] >> 8) & 0xff;
        out[size_t(y) * xsize + x] = pal[(packed >> (width_bits * (x & (per - 1)))) & ((1u << width_bits) - 1)];
      }
  }
  p.swap(out);
}

// --------------------------------------------------------------------------
// VP8
// --------------------------------------------------------------------------

struct Tables {
  const uint8_t* dc;       // [128]
  const int32_t* ac;       // [128]
  const uint8_t* update;   // [4][8][3][11]
  const uint8_t* proba0;   // [4][8][3][11]
  const uint8_t* bmodes;   // [10][10][9]
};

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0}, kCat5[] = {180, 157, 141, 134, 130, 0},
              kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };

// libwebp's boolean decoder, one byte loaded at a time
struct BoolReader {
  const uint8_t* d = nullptr;
  int64_t n = 0, pos = 0;
  uint64_t value = 0;
  int rng = 254, bits = -8;
  bool eof = false;
  void init(const uint8_t* data, int64_t size) { d = data, n = size, pos = 0, value = 0, rng = 254, bits = -8, eof = false; }
  void load() {
    if (pos < n) {
      value = (value << 8) | d[pos++];
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
    int range = rng;
    if (bits < 0) load();
    const int split = (range * prob) >> 8;
    int b;
    if (int(value >> bits) > split) {
      range -= split;
      value -= uint64_t(split + 1) << bits;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    int shift = 7;
    for (int r = range; r > 1; r >>= 1) --shift;
    rng = (range << shift) - 1;
    bits -= shift;
    return b;
  }
  int signed_(int v) {
    if (bits < 0) load();
    const int split = rng >> 1;
    const bool neg = int(value >> bits) > split;
    const int pos_ = bits;
    bits -= 1;
    if (neg) {
      rng = (rng - 1) | 1;
      value -= uint64_t(split + 1) << pos_;
      return -v;
    }
    rng |= 1;
    return v;
  }
  int value_bits(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    const int v = value_bits(nbits);
    return bit(0x80) ? -v : v;
  }
};

inline int clipi(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

struct Frame {
  int width, height, mb_w, mb_h;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0}, segment_probs[3] = {255, 255, 255};
  int simple, level, sharpness, use_lf_delta, ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type;
  int dqm[4][3][2];
  uint8_t proba[4][8][3][11];
  int use_skip, skip_p;
  BoolReader br;
  std::vector<BoolReader> parts;
};

int parse_header(const uint8_t* data, int64_t size, const Tables& tb, Frame* f, Error* err) {
  if (size < 10) return err->fail("corrupt WebP data (VP8): a short frame header (truncated)");
  const uint32_t bits = uint32_t(data[0]) | (uint32_t(data[1]) << 8) | (uint32_t(data[2]) << 16);
  if (bits & 1) return err->fail("corrupt WebP data (VP8): not a key frame");
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return err->fail("corrupt WebP data (VP8): bad key frame parameters");
  const int64_t part0 = bits >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return err->fail("corrupt WebP data (VP8): a bad start code");
  f->width = (data[6] | (data[7] << 8)) & 0x3fff;
  f->height = (data[8] | (data[9] << 8)) & 0x3fff;
  if (!f->width || !f->height) return err->fail("corrupt WebP data (VP8): a frame of no pixels");
  f->mb_w = (f->width + 15) >> 4, f->mb_h = (f->height + 15) >> 4;
  const uint8_t* rest = data + 10;
  const int64_t nrest = size - 10;
  if (part0 > nrest) return err->fail("corrupt WebP data (VP8): a bad partition length (truncated)");
  BoolReader& br = f->br;
  br.init(rest, part0);
  br.bit(0x80);
  br.bit(0x80);
  f->use_segment = br.bit(0x80);
  if (f->use_segment) {
    f->update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      f->absolute_delta = br.bit(0x80);
      for (int& q : f->quantizer) q = br.bit(0x80) ? br.signed_value(7) : 0;
      for (int& s : f->filter_strength) s = br.bit(0x80) ? br.signed_value(6) : 0;
    }
    if (f->update_map)
      for (int& p : f->segment_probs) p = br.bit(0x80) ? br.value_bits(8) : 255;
  }
  f->simple = br.bit(0x80);
  f->level = br.value_bits(6);
  f->sharpness = br.value_bits(3);
  f->use_lf_delta = br.bit(0x80);
  if (f->use_lf_delta && br.bit(0x80)) {
    for (int& d : f->ref_lf_delta)
      if (br.bit(0x80)) d = br.signed_value(6);
    for (int& d : f->mode_lf_delta)
      if (br.bit(0x80)) d = br.signed_value(6);
  }
  f->filter_type = f->level == 0 ? 0 : f->simple ? 1 : 2;
  if (br.eof) return err->fail("corrupt WebP data (VP8): cannot parse the filter header");
  const int nparts = 1 << br.value_bits(2);
  const int64_t sizes_at = part0;
  int64_t start = part0 + 3 * (nparts - 1);
  if (start > nrest) return err->fail("corrupt WebP data (VP8): cannot parse the partitions (truncated)");
  f->parts.resize(nparts);
  for (int p = 0; p < nparts; ++p) {
    int64_t psize;
    if (p < nparts - 1) {
      const uint8_t* s = rest + sizes_at + 3 * p;
      psize = int64_t(s[0]) | (int64_t(s[1]) << 8) | (int64_t(s[2]) << 16);
      if (psize > nrest - start) psize = nrest - start;
    } else {
      psize = nrest - start;
    }
    f->parts[p].init(rest + start, psize);
    start += psize;
  }
  if (f->parts[nparts - 1].n == 0) return err->fail("corrupt WebP data (VP8): the last partition is empty (truncated)");
  const int base_q = br.value_bits(7);
  int dq[5];
  for (int& d : dq) d = br.bit(0x80) ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (f->use_segment) {
      q = f->quantizer[i] + (f->absolute_delta ? 0 : base_q);
    } else if (i > 0) {
      memcpy(f->dqm[i], f->dqm[0], sizeof(f->dqm[0]));
      continue;
    } else {
      q = base_q;
    }
    f->dqm[i][0][0] = tb.dc[clipi(q + dq[0], 127)];
    f->dqm[i][0][1] = tb.ac[clipi(q, 127)];
    f->dqm[i][1][0] = tb.dc[clipi(q + dq[1], 127)] * 2;
    const int y2ac = (tb.ac[clipi(q + dq[2], 127)] * 101581) >> 16;
    f->dqm[i][1][1] = y2ac < 8 ? 8 : y2ac;
    f->dqm[i][2][0] = tb.dc[clipi(q + dq[3], 117)];
    f->dqm[i][2][1] = tb.ac[clipi(q + dq[4], 127)];
  }
  br.bit(0x80);
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          f->proba[t][b][c][p] = br.bit(tb.update[i]) ? uint8_t(br.value_bits(8)) : tb.proba0[i];
        }
  f->use_skip = br.bit(0x80);
  f->skip_p = f->use_skip ? br.value_bits(8) : 0;
  return 0;
}

int large_value(BoolReader& br, const uint8_t* p) {
  if (!br.bit(p[3])) return !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int cat = 2 * bit1 + br.bit(p[9 + bit1]);
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      if (++n == 16) return 16;
      p = bands[kBands[n]][0];
    }
    const uint8_t(*nxt)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = nxt[1];
    } else {
      v = large_value(br, p);
      p = nxt[2];
    }
    out[kZigzag[n]] = int16_t(br.signed_(v) * dq[n > 0]);
  }
  return 16;
}

struct MBInfo {
  int seg, skip, is4, uvmode;
  int modes[16];
};

void wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1, tmp[8 + i] = a0 - a1, tmp[4 + i] = a3 + a2, tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[(4 * i + 0) * 16] = int16_t((a0 + a1) >> 3);
    out[(4 * i + 1) * 16] = int16_t((a3 + a2) >> 3);
    out[(4 * i + 2) * 16] = int16_t((a0 - a1) >> 3);
    out[(4 * i + 3) * 16] = int16_t((a3 - a2) >> 3);
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i] = a + d, tmp[4 * i + 1] = b + c, tmp[4 * i + 2] = b - c, tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * stride;
    const int v[4] = {a + d, b + c, b - c, a - d};
    for (int x = 0; x < 4; ++x) row[x] = uint8_t(clipi(row[x] + (v[x] >> 3), 255));
  }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2i(int a, int b) { return (a + b + 1) >> 1; }

// A 4 x 4 block's prediction into dst (stride): top[0..7] the samples above
// with the top-right, left[0..3], x the corner.
void pred4(int mode, const int* top, const int* left, int X, uint8_t* dst, int stride) {
  int o[4][4];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = left[0], J = left[1], K = left[2], L = left[3];
#define PUT(v, x, y) o[y][x] = (v)
  switch (mode) {
    case DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + left[i];
      for (auto& r : o)
        for (int& v : r) v = dc >> 3;
      break;
    }
    case TM_PRED:
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = clipi(top[x] + left[y] - X, 255);
      break;
    case V_PRED: {
      const int r[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = r[x];
      break;
    }
    case H_PRED: {
      const int c[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = c[y];
      break;
    }
    case 4:  // RD
      PUT(avg3(J, K, L), 0, 3);
      PUT(avg3(I, J, K), 1, 3), PUT(avg3(I, J, K), 0, 2);
      PUT(avg3(X, I, J), 2, 3), PUT(avg3(X, I, J), 1, 2), PUT(avg3(X, I, J), 0, 1);
      PUT(avg3(A, X, I), 3, 3), PUT(avg3(A, X, I), 2, 2), PUT(avg3(A, X, I), 1, 1), PUT(avg3(A, X, I), 0, 0);
      PUT(avg3(B, A, X), 3, 2), PUT(avg3(B, A, X), 2, 1), PUT(avg3(B, A, X), 1, 0);
      PUT(avg3(C, B, A), 3, 1), PUT(avg3(C, B, A), 2, 0);
      PUT(avg3(D, C, B), 3, 0);
      break;
    case 5:  // VR
      PUT(avg2i(X, A), 0, 0), PUT(avg2i(X, A), 1, 2);
      PUT(avg2i(A, B), 1, 0), PUT(avg2i(A, B), 2, 2);
      PUT(avg2i(B, C), 2, 0), PUT(avg2i(B, C), 3, 2);
      PUT(avg2i(C, D), 3, 0);
      PUT(avg3(K, J, I), 0, 3);
      PUT(avg3(J, I, X), 0, 2);
      PUT(avg3(I, X, A), 0, 1), PUT(avg3(I, X, A), 1, 3);
      PUT(avg3(X, A, B), 1, 1), PUT(avg3(X, A, B), 2, 3);
      PUT(avg3(A, B, C), 2, 1), PUT(avg3(A, B, C), 3, 3);
      PUT(avg3(B, C, D), 3, 1);
      break;
    case 6:  // LD
      PUT(avg3(A, B, C), 0, 0);
      PUT(avg3(B, C, D), 1, 0), PUT(avg3(B, C, D), 0, 1);
      PUT(avg3(C, D, E), 2, 0), PUT(avg3(C, D, E), 1, 1), PUT(avg3(C, D, E), 0, 2);
      PUT(avg3(D, E, F), 3, 0), PUT(avg3(D, E, F), 2, 1), PUT(avg3(D, E, F), 1, 2), PUT(avg3(D, E, F), 0, 3);
      PUT(avg3(E, F, G), 3, 1), PUT(avg3(E, F, G), 2, 2), PUT(avg3(E, F, G), 1, 3);
      PUT(avg3(F, G, H), 3, 2), PUT(avg3(F, G, H), 2, 3);
      PUT(avg3(G, H, H), 3, 3);
      break;
    case 7:  // VL
      PUT(avg2i(A, B), 0, 0);
      PUT(avg2i(B, C), 1, 0), PUT(avg2i(B, C), 0, 2);
      PUT(avg2i(C, D), 2, 0), PUT(avg2i(C, D), 1, 2);
      PUT(avg2i(D, E), 3, 0), PUT(avg2i(D, E), 2, 2);
      PUT(avg3(A, B, C), 0, 1);
      PUT(avg3(B, C, D), 1, 1), PUT(avg3(B, C, D), 0, 3);
      PUT(avg3(C, D, E), 2, 1), PUT(avg3(C, D, E), 1, 3);
      PUT(avg3(D, E, F), 3, 1), PUT(avg3(D, E, F), 2, 3);
      PUT(avg3(E, F, G), 3, 2);
      PUT(avg3(F, G, H), 3, 3);
      break;
    case 8:  // HD
      PUT(avg2i(I, X), 0, 0), PUT(avg2i(I, X), 2, 1);
      PUT(avg2i(J, I), 0, 1), PUT(avg2i(J, I), 2, 2);
      PUT(avg2i(K, J), 0, 2), PUT(avg2i(K, J), 2, 3);
      PUT(avg2i(L, K), 0, 3);
      PUT(avg3(A, B, C), 3, 0);
      PUT(avg3(X, A, B), 2, 0);
      PUT(avg3(I, X, A), 1, 0), PUT(avg3(I, X, A), 3, 1);
      PUT(avg3(J, I, X), 1, 1), PUT(avg3(J, I, X), 3, 2);
      PUT(avg3(K, J, I), 1, 2), PUT(avg3(K, J, I), 3, 3);
      PUT(avg3(L, K, J), 1, 3);
      break;
    default:  // HU
      PUT(avg2i(I, J), 0, 0);
      PUT(avg2i(J, K), 2, 0), PUT(avg2i(J, K), 0, 1);
      PUT(avg2i(K, L), 2, 1), PUT(avg2i(K, L), 0, 2);
      PUT(avg3(I, J, K), 1, 0);
      PUT(avg3(J, K, L), 3, 0), PUT(avg3(J, K, L), 1, 1);
      PUT(avg3(K, L, L), 3, 1), PUT(avg3(K, L, L), 1, 2);
      PUT(L, 3, 2), PUT(L, 2, 2), PUT(L, 0, 3), PUT(L, 1, 3), PUT(L, 2, 3), PUT(L, 3, 3);
      break;
  }
#undef PUT
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[y * stride + x] = uint8_t(o[y][x]);
}

// The 16 x 16 or 8 x 8 prediction of a macroblock at dst in a plane padded
// by one row above and one column to the left (the borders).
void pred_block(int mode, uint8_t* dst, int stride, int size, int mbx, int mby) {
  const uint8_t* top = dst - stride;
  const int corner = top[-1];
  const int shift = size == 16 ? 4 : 3;
  for (int y = 0; y < size; ++y) {
    uint8_t* row = dst + y * stride;
    const int left = row[-1];
    for (int x = 0; x < size; ++x) {
      if (mode == TM_PRED) row[x] = uint8_t(clipi(top[x] + left - corner, 255));
      else if (mode == V_PRED) row[x] = top[x];
      else if (mode == H_PRED) row[x] = uint8_t(left);
    }
  }
  if (mode != DC_PRED) return;
  int st = 0, sl = 0, v;
  for (int i = 0; i < size; ++i) st += top[i], sl += dst[i * stride - 1];
  if (mbx && mby) v = (st + sl + size) >> (shift + 1);
  else if (mbx) v = (sl + (size >> 1)) >> shift;
  else if (mby) v = (st + (size >> 1)) >> shift;
  else v = 0x80;
  for (int y = 0; y < size; ++y) memset(dst + y * stride, v, size);
}

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// One line across an edge at p (q0), `step` apart; kind 0 simple, 4 inside
// a macroblock, 6 on its edge.
inline void filter_line(uint8_t* p, int step, int thresh2, int ithresh, int hev_t, int kind) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > thresh2) return;
  bool hev = false;
  if (kind) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], q2 = p[2 * step], q3 = p[3 * step];
    if (std::abs(p3 - p2) > ithresh || std::abs(p2 - p1) > ithresh || std::abs(p1 - p0) > ithresh ||
        std::abs(q3 - q2) > ithresh || std::abs(q2 - q1) > ithresh || std::abs(q1 - q0) > ithresh)
      return;
    hev = std::abs(p1 - p0) > hev_t || std::abs(q1 - q0) > hev_t;
  }
  if (!kind || hev) {
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = uint8_t(clipi(p0 + a2, 255));
    p[0] = uint8_t(clipi(q0 - a1, 255));
  } else if (kind == 4) {
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = uint8_t(clipi(p1 + a3, 255));
    p[-step] = uint8_t(clipi(p0 + a2, 255));
    p[0] = uint8_t(clipi(q0 - a1, 255));
    p[step] = uint8_t(clipi(q1 - a3, 255));
  } else {
    const int p2 = p[-3 * step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = uint8_t(clipi(p2 + a3, 255));
    p[-2 * step] = uint8_t(clipi(p1 + a2, 255));
    p[-step] = uint8_t(clipi(p0 + a1, 255));
    p[0] = uint8_t(clipi(q0 - a1, 255));
    p[step] = uint8_t(clipi(q1 - a2, 255));
    p[2 * step] = uint8_t(clipi(q2 - a3, 255));
  }
}

void filter_edge(uint8_t* p, int along, int across, int size, int thresh, int ithresh, int hev_t, int kind) {
  for (int i = 0; i < size; ++i) filter_line(p + i * along, across, 2 * thresh + 1, ithresh, hev_t, kind);
}

inline int clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = (y * 19077) >> 8;
  rgb[0] = uint8_t(clip8(yy + ((v * 26149) >> 8) - 14234));
  rgb[1] = uint8_t(clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708));
  rgb[2] = uint8_t(clip8(yy + ((u * 33050) >> 8) - 17685));
}

// libwebp's UpsampleRgbLinePair, one channel pair at a time
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu, const uint8_t* tv, const uint8_t* cu,
                   const uint8_t* cv, int width, uint8_t* out_top, uint8_t* out_bot) {
  int tlu = tu[0], tlv = tv[0], lu = cu[0], lv = cv[0];
  yuv_to_rgb(top_y[0], (3 * tlu + lu + 2) >> 2, (3 * tlv + lv + 2) >> 2, out_top);
  if (bot_y) yuv_to_rgb(bot_y[0], (3 * lu + tlu + 2) >> 2, (3 * lv + tlv + 2) >> 2, out_bot);
  for (int x = 1; x <= (width - 1) >> 1; ++x) {
    const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
    const int au = tlu + t_u + lu + c_u + 8, av = tlv + t_v + lv + c_v + 8;
    const int d12u = (au + 2 * (t_u + lu)) >> 3, d03u = (au + 2 * (tlu + c_u)) >> 3;
    const int d12v = (av + 2 * (t_v + lv)) >> 3, d03v = (av + 2 * (tlv + c_v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12u + tlu) >> 1, (d12v + tlv) >> 1, out_top + 3 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (d03u + t_u) >> 1, (d03v + t_v) >> 1, out_top + 3 * (2 * x));
    if (bot_y) {
      yuv_to_rgb(bot_y[2 * x - 1], (d03u + lu) >> 1, (d03v + lv) >> 1, out_bot + 3 * (2 * x - 1));
      yuv_to_rgb(bot_y[2 * x], (d12u + c_u) >> 1, (d12v + c_v) >> 1, out_bot + 3 * (2 * x));
    }
    tlu = t_u, tlv = t_v, lu = c_u, lv = c_v;
  }
  if (!(width & 1)) {
    yuv_to_rgb(top_y[width - 1], (3 * tlu + lu + 2) >> 2, (3 * tlv + lv + 2) >> 2, out_top + 3 * (width - 1));
    if (bot_y) yuv_to_rgb(bot_y[width - 1], (3 * lu + tlu + 2) >> 2, (3 * lv + tlv + 2) >> 2, out_bot + 3 * (width - 1));
  }
}

int decode_vp8(const uint8_t* data, int64_t size, const Tables& tb, uint8_t* out, Error* err) {
  Frame f;
  if (parse_header(data, size, tb, &f, err)) return 1;
  const int W16 = f.mb_w * 16, H16 = f.mb_h * 16, ys = W16 + 1, cs = W16 / 2 + 1;
  // padded planes: row 0 and column 0 are the borders (127 above, 129 to the left, the corner 127)
  std::vector<uint8_t> Y(size_t(H16 + 1) * ys), U(size_t(H16 / 2 + 1) * cs), V;
  memset(Y.data(), 127, ys);
  for (int r = 1; r <= H16; ++r) Y[size_t(r) * ys] = 129;
  memset(U.data(), 127, cs);
  for (int r = 1; r <= H16 / 2; ++r) U[size_t(r) * cs] = 129;
  V = U;
  int fs[4][2][3] = {};
  if (f.filter_type) {
    for (int s = 0; s < 4; ++s) {
      int base = f.level;
      if (f.use_segment) base = f.filter_strength[s] + (f.absolute_delta ? 0 : f.level);
      for (int i4 = 0; i4 <= 1; ++i4) {
        int level = base;
        if (f.use_lf_delta) level += f.ref_lf_delta[0] + (i4 ? f.mode_lf_delta[0] : 0);
        level = clipi(level, 63);
        if (level > 0) {
          int il = level;
          if (f.sharpness > 0) {
            il >>= f.sharpness > 4 ? 2 : 1;
            if (il > 9 - f.sharpness) il = 9 - f.sharpness;
          }
          if (il < 1) il = 1;
          fs[s][i4][0] = 2 * level + il, fs[s][i4][1] = il, fs[s][i4][2] = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        }
      }
    }
  }
  std::vector<int> finfo(size_t(f.mb_w) * f.mb_h * 4, 0);
  std::vector<int> top_modes(size_t(4) * f.mb_w, DC_PRED);
  // nonzero contexts: per column 4 luma, 2 + 2 chroma, 1 dc; the left ones of the row
  std::vector<uint8_t> tnz(size_t(9) * f.mb_w, 0);
  std::vector<MBInfo> row(f.mb_w);
  int16_t coeffs[384];
  for (int mby = 0; mby < f.mb_h; ++mby) {
    int left_modes[4] = {DC_PRED, DC_PRED, DC_PRED, DC_PRED};
    BoolReader& br = f.br;
    for (int mbx = 0; mbx < f.mb_w; ++mbx) {
      MBInfo& m = row[mbx];
      m.seg = 0;
      if (f.update_map)
        m.seg = !br.bit(f.segment_probs[0]) ? br.bit(f.segment_probs[1]) : br.bit(f.segment_probs[2]) + 2;
      m.skip = f.use_skip ? br.bit(f.skip_p) : 0;
      int* t = &top_modes[size_t(4) * mbx];
      m.is4 = !br.bit(145);
      if (!m.is4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
        m.modes[0] = ymode;
        for (int i = 0; i < 4; ++i) t[i] = left_modes[i] = ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = left_modes[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = tb.bmodes + (t[x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            t[x] = ymode;
          }
          for (int x = 0; x < 4; ++x) m.modes[4 * y + x] = t[x];
          left_modes[y] = ymode;
        }
      }
      m.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
    }
    if (br.eof) return err->fail("corrupt WebP data (VP8): the first partition ends before its last macroblock (truncated)");
    BoolReader& tok = f.parts[size_t(mby) & (f.parts.size() - 1)];
    uint8_t lnz[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int mbx = 0; mbx < f.mb_w; ++mbx) {
      const MBInfo& m = row[mbx];
      uint8_t* tz = &tnz[size_t(9) * mbx];
      memset(coeffs, 0, sizeof(coeffs));
      bool any_nz = false;
      if (!m.skip) {
        const int(*dqm)[2] = f.dqm[m.seg];
        int first;
        const uint8_t(*ac)[3][11];
        if (!m.is4) {
          int16_t dc[16] = {0};
          const int nz = get_coeffs(tok, f.proba[1], tz[8] + lnz[8], dqm[1], 0, dc);
          tz[8] = lnz[8] = nz > 0;
          wht(dc, coeffs);
          first = 1, ac = f.proba[0];
        } else {
          first = 0, ac = f.proba[3];
        }
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            int16_t* blk = coeffs + (4 * y + x) * 16;
            const int nz = get_coeffs(tok, ac, lnz[y] + tz[x], dqm[0], first, blk);
            lnz[y] = tz[x] = nz > first;
            any_nz = any_nz || nz > first || blk[0] != 0;
          }
        for (int c = 0; c < 2; ++c)
          for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
              const int nz = get_coeffs(tok, f.proba[2], lnz[4 + 2 * c + y] + tz[4 + 2 * c + x], dqm[2], 0,
                                        coeffs + (16 + 4 * c + 2 * y + x) * 16);
              lnz[4 + 2 * c + y] = tz[4 + 2 * c + x] = nz > 0;
              any_nz = any_nz || nz > 0;
            }
      } else {
        for (int i = 0; i < 8; ++i) tz[i] = lnz[i] = 0;
        if (!m.is4) tz[8] = lnz[8] = 0;
      }
      if (tok.eof) return err->fail("corrupt WebP data (VP8): a token partition ends before its last macroblock (truncated)");
      int* fi = &finfo[(size_t(mby) * f.mb_w + mbx) * 4];
      if (f.filter_type) {
        fi[0] = fs[m.seg][m.is4][0], fi[1] = fs[m.seg][m.is4][1], fi[2] = fs[m.seg][m.is4][2];
        fi[3] = m.is4 || any_nz;
      }
      uint8_t* yd = &Y[size_t(1 + 16 * mby) * ys + 1 + 16 * mbx];
      if (m.is4) {
        int tr[4];
        for (int i = 0; i < 4; ++i)
          tr[i] = mby == 0 ? 127 : mbx == f.mb_w - 1 ? yd[-ys + 15] : yd[-ys + 16 + i];
        for (int n = 0; n < 16; ++n) {
          uint8_t* b = yd + 4 * (n >> 2) * ys + 4 * (n & 3);
          int top[8], left[4];
          for (int i = 0; i < 4; ++i) top[i] = b[-ys + i], left[i] = b[i * ys - 1];
          for (int i = 0; i < 4; ++i) top[4 + i] = (n & 3) == 3 ? tr[i] : b[-ys + 4 + i];
          pred4(m.modes[n], top, left, b[-ys - 1], b, ys);
          idct_add(coeffs + 16 * n, b, ys);
        }
      } else {
        pred_block(m.modes[0], yd, ys, 16, mbx, mby);
        for (int n = 0; n < 16; ++n) idct_add(coeffs + 16 * n, yd + 4 * (n >> 2) * ys + 4 * (n & 3), ys);
      }
      for (int c = 0; c < 2; ++c) {
        uint8_t* cd = (c ? V : U).data() + size_t(1 + 8 * mby) * cs + 1 + 8 * mbx;
        pred_block(m.uvmode, cd, cs, 8, mbx, mby);
        for (int n = 0; n < 4; ++n) idct_add(coeffs + (16 + 4 * c + n) * 16, cd + 4 * (n >> 1) * cs + 4 * (n & 1), cs);
      }
    }
  }
  if (f.filter_type) {
    for (int mby = 0; mby < f.mb_h; ++mby)
      for (int mbx = 0; mbx < f.mb_w; ++mbx) {
        const int* fi = &finfo[(size_t(mby) * f.mb_w + mbx) * 4];
        const int limit = fi[0], il = fi[1], hev = fi[2], inner = fi[3];
        if (!limit) continue;
        uint8_t* yd = &Y[size_t(1 + 16 * mby) * ys + 1 + 16 * mbx];
        uint8_t* ud = &U[size_t(1 + 8 * mby) * cs + 1 + 8 * mbx];
        uint8_t* vd = &V[size_t(1 + 8 * mby) * cs + 1 + 8 * mbx];
        if (f.filter_type == 1) {
          if (mbx > 0) filter_edge(yd, ys, 1, 16, limit + 4, 0, 0, 0);
          if (inner)
            for (int k = 4; k < 16; k += 4) filter_edge(yd + k, ys, 1, 16, limit, 0, 0, 0);
          if (mby > 0) filter_edge(yd, 1, ys, 16, limit + 4, 0, 0, 0);
          if (inner)
            for (int k = 4; k < 16; k += 4) filter_edge(yd + k * ys, 1, ys, 16, limit, 0, 0, 0);
          continue;
        }
        if (mbx > 0) {
          filter_edge(yd, ys, 1, 16, limit + 4, il, hev, 6);
          filter_edge(ud, cs, 1, 8, limit + 4, il, hev, 6);
          filter_edge(vd, cs, 1, 8, limit + 4, il, hev, 6);
        }
        if (inner) {
          for (int k = 4; k < 16; k += 4) filter_edge(yd + k, ys, 1, 16, limit, il, hev, 4);
          filter_edge(ud + 4, cs, 1, 8, limit, il, hev, 4);
          filter_edge(vd + 4, cs, 1, 8, limit, il, hev, 4);
        }
        if (mby > 0) {
          filter_edge(yd, 1, ys, 16, limit + 4, il, hev, 6);
          filter_edge(ud, 1, cs, 8, limit + 4, il, hev, 6);
          filter_edge(vd, 1, cs, 8, limit + 4, il, hev, 6);
        }
        if (inner) {
          for (int k = 4; k < 16; k += 4) filter_edge(yd + k * ys, 1, ys, 16, limit, il, hev, 4);
          filter_edge(ud + 4 * cs, 1, cs, 8, limit, il, hev, 4);
          filter_edge(vd + 4 * cs, 1, cs, 8, limit, il, hev, 4);
        }
      }
  }
  const int w = f.width, h = f.height;
  auto yrow = [&](int r) { return &Y[size_t(1 + r) * ys + 1]; };
  auto urow = [&](int r) { return &U[size_t(1 + r) * cs + 1]; };
  auto vrow = [&](int r) { return &V[size_t(1 + r) * cs + 1]; };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), w, out, nullptr);
  for (int k = 1; 2 * k - 1 < h; ++k) {
    const int top = 2 * k - 1, bot = 2 * k;
    if (bot < h)
      upsample_pair(yrow(top), yrow(bot), urow(k - 1), vrow(k - 1), urow(k), vrow(k), w, out + size_t(3) * w * top,
                    out + size_t(3) * w * bot);
    else
      upsample_pair(yrow(top), nullptr, urow(k - 1), vrow(k - 1), urow(k - 1), vrow(k - 1), w, out + size_t(3) * w * top,
                    nullptr);
  }
  return 0;
}

}  // namespace

extern "C" {

// A VP8L bitstream (its 5-byte header included) -> width x height ARGB
// words as bytes A, R, G, B. Returns 0, or 1 with a message in err.
int webp_vp8l_decode(const uint8_t* data, int64_t n, const uint8_t* code_to_plane, int width, int height, uint8_t* out,
                     char* errmsg, int errlen) {
  Error err{errmsg, errlen};
  VP8L d{LBits{data, n}, code_to_plane, &err};
  d.br.read(32);
  d.br.read(8);
  int xsize = width;
  std::vector<Transform> transforms;
  int seen = 0;
  while (d.br.read(1)) {
    const int kind = int(d.br.read(2));
    if (seen & (1 << kind)) return err.fail("corrupt WebP data (VP8L): a transform given twice");
    seen |= 1 << kind;
    Transform t{kind, 0, xsize, {}};
    if (kind == 0 || kind == 1) {
      t.bits = int(d.br.read(3)) + 2;
      if (!d.stream(VP8L::sub(xsize, t.bits), VP8L::sub(height, t.bits), false, &t.sub)) return 1;
    } else if (kind == 3) {
      const int ncolours = int(d.br.read(8)) + 1;
      t.bits = ncolours > 16 ? 0 : ncolours > 4 ? 1 : ncolours > 2 ? 2 : 3;
      if (!d.stream(ncolours, 1, false, &t.sub)) return 1;
      for (size_t i = 1; i < t.sub.size(); ++i) t.sub[i] = add_px(t.sub[i], t.sub[i - 1]);
      xsize = VP8L::sub(xsize, t.bits);
    }
    if (d.br.over) return err.fail("corrupt WebP data (VP8L): the data ends inside the image (truncated)");
    transforms.push_back(std::move(t));
  }
  std::vector<uint32_t> px;
  if (!d.stream(xsize, height, true, &px)) return 1;
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) inverse(*it, height, &px);
  for (size_t i = 0; i < size_t(width) * height; ++i) {
    out[4 * i] = uint8_t(px[i] >> 24), out[4 * i + 1] = uint8_t(px[i] >> 16);
    out[4 * i + 2] = uint8_t(px[i] >> 8), out[4 * i + 3] = uint8_t(px[i]);
  }
  return 0;
}

// A VP8 key frame -> RGB [height, width, 3] as libwebp decodes it with its
// default fancy upsampling. Returns 0, or 1 with a message in err.
int webp_vp8_decode(const uint8_t* data, int64_t n, const uint8_t* dc, const int32_t* ac, const uint8_t* update,
                    const uint8_t* proba0, const uint8_t* bmodes, uint8_t* out, char* errmsg, int errlen) {
  Error err{errmsg, errlen};
  const Tables tb{dc, ac, update, proba0, bmodes};
  return decode_vp8(data, n, tb, out, &err);
}

}  // extern "C"
