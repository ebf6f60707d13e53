// Native TIFF chunk decompressors: LZW (TIFF variant) and PackBits.
//
// The reference reads GeoTIFFs through GDAL's C++ decoders (reference
// LBDRNdataset.py:93); this framework's io/tiff.py carries pure-Python
// mirrors for portability, but a Python byte-loop tops out around a few
// MB/s — far too slow for multi-hundred-MB Gaofen products.  These
// functions are the production path; the Python implementations remain
// the byte-exact oracles (tests/test_torch_tiff.py).
//
// Both return the number of bytes written (<= cap) and stop once the
// caller's expected size is reached (TIFF strips/tiles have a known
// decoded size; writers may pad the coded stream past it), or -1 on a
// malformed stream.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kMaxCodes = 4096;

}  // namespace

extern "C" {

// TIFF-variant LZW: MSB-first code packing, early-change code widening
// (the width bumps one code before the table fills).  Matches
// io/tiff.py::_lzw_decode byte for byte over the first `cap` bytes.
int64_t lbdrn_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap) {
  static_assert(sizeof(int) >= 4, "int width");
  int prefix[kMaxCodes];
  uint8_t suffix[kMaxCodes];
  uint8_t stack[kMaxCodes + 1];
  int table_size = 258;
  int code_len = 9;
  int prev = -1;
  bool cleared = false;  // the stream must open with ClearCode (oracle
                         // io/tiff.py:_lzw_decode raises otherwise)
  int64_t out = 0, pos = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;

  while (out < cap) {
    while (bitcnt < code_len && pos < n) {
      bitbuf = (bitbuf << 8) | src[pos++];
      bitcnt += 8;
    }
    if (bitcnt < code_len) break;  // stream exhausted
    int code = (int)((bitbuf >> (bitcnt - code_len)) & ((1u << code_len) - 1));
    bitcnt -= code_len;

    if (code == kClear) {
      table_size = 258;
      code_len = 9;
      prev = -1;
      cleared = true;
      continue;
    }
    if (code == kEoi) break;
    if (!cleared) return -1;  // data before the initial ClearCode
    if (prev == -1 && code >= 256) return -1;  // must open with a literal

    // Resolve the entry's bytes by walking the prefix chain (reversed).
    int sp = 0;
    bool kwk = false;
    int cur;
    if (code < table_size) {
      cur = code;
    } else if (code == table_size && prev != -1) {
      cur = prev;  // KwKwK: entry = prev-string + first(prev-string)
      kwk = true;
    } else {
      return -1;
    }
    while (cur >= 258) {
      if (sp >= kMaxCodes) return -1;
      stack[sp++] = suffix[cur];
      cur = prefix[cur];
    }
    if (cur >= 256) return -1;
    stack[sp++] = (uint8_t)cur;
    uint8_t first = (uint8_t)cur;

    for (int i = sp - 1; i >= 0 && out < cap; --i) dst[out++] = stack[i];
    if (kwk && out < cap) dst[out++] = first;

    if (prev != -1 && table_size < kMaxCodes) {
      prefix[table_size] = prev;
      suffix[table_size] = first;
      ++table_size;
    }
    prev = code;
    // early change: widen one code before the table fills
    if (table_size + 1 >= (1 << code_len) && code_len < 12) ++code_len;
  }
  return out;
}

// PackBits (TIFF compression 32773).  Matches
// io/tiff.py::_packbits_decode over the first `cap` bytes.
int64_t lbdrn_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
  int64_t pos = 0, out = 0;
  while (pos < n && out < cap) {
    uint8_t b = src[pos++];
    if (b < 128) {
      int64_t cnt = (int64_t)b + 1;
      if (pos + cnt > n) cnt = n - pos;  // mirror Python's tolerant slice
      if (out + cnt > cap) cnt = cap - out;
      std::memcpy(dst + out, src + pos, (size_t)cnt);
      out += cnt;
      pos += (int64_t)b + 1;
    } else if (b > 128) {
      if (pos >= n) break;
      int64_t cnt = 257 - (int64_t)b;
      if (out + cnt > cap) cnt = cap - out;
      std::memset(dst + out, src[pos++], (size_t)cnt);
      out += cnt;
    }
    // b == 128: no-op per spec (Python skips it too)
  }
  return out;
}

}  // extern "C"
