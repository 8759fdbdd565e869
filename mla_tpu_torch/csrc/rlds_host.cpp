// Host loops of the RLDS data pipeline, loaded through ctypes by
// mla_tpu_torch/native/rlds_host.py. Each is sequential (a CRC's running
// state, a PNG row's dependence on its left pixel and the row above, a
// float sum in a fixed tap order) and too slow in Python, or, for the
// Lanczos kernel's sines, must be the C library's float sin. Built with
// -ffp-contract=off: the resampling sums must round after every multiply
// and every add, as TensorFlow's CPU kernel does.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>

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

}  // extern "C"
