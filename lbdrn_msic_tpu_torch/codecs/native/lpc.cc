// LPC — lossless predictive coder for multiband uint8/uint16 planes.
//
// The framework-native alternative to JPEG 2000 for the MSB base layer
// (the reference shells out to gdal_translate/OpenJPEG for this role,
// reference encode.py:137 / decode.py:69).  JPEG-LS-style design, built for
// 10/12-bit satellite bands:
//
//   - MED / LOCO-I edge-detecting predictor (a=left, b=top, c=topleft),
//   - per-context adaptive bias correction (running error mean, LOCO-I
//     style with periodic halving),
//   - causal gradient context (quantized |b-c|, |c-a| -> 49 contexts),
//   - residual zigzag coded as [bit-length via per-context adaptive
//     bit-tree] + [2 adaptively-coded high bits] + [low bits raw] over the
//     shared range coder,
//   - bands coded independently and in parallel (std::thread).
//
// Wire v1: b"LLPC" | u8 version=1 | u8 itemsize(1|2) | u8 C |
//          u32le H | u32le W | u32le band_len x C | payloads.
//
// Wire v2 (row-chunked, decode-pipeline format): each band is split into
// ceil(H / chunk_rows) INDEPENDENT streams (fresh model + range coder per
// chunk — the context restart costs <0.2 % on Gaofen-like content at
// 512-row chunks) so (a) decode parallelism is C x n_chunks tasks over a
// worker pool instead of C threads, and (b) a chunk is decodable in
// isolation (lpc_decompress_chunk), which lets the Python decoder overlap
// host base decoding with device residual compute and the d2h link
// (decode/reconstruct.py) instead of serializing them.  u16le max_val
// records the plane maximum so the decoder knows the feature scale
// (1/max, reference LBDRNdataset.py:119) before any chunk is decoded.
//
// Wire v2: b"LLPC" | u8 version=2 | u8 itemsize(1|2) | u8 C |
//          u32le H | u32le W | u32le chunk_rows | u16le max_val |
//          u32le chunk_len x (C * n_chunks, channel-major) | payloads.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "rangecoder.h"

namespace {

constexpr uint8_t kMagic[4] = {'L', 'L', 'P', 'C'};
constexpr uint8_t kVersion = 1;
constexpr uint8_t kVersion2 = 2;
constexpr uint64_t kHdr2 = 21;  // magic..max_val, before the size table
constexpr int kNbitsTree = 6;  // bit-length symbol in 0..63 (6-bit tree)
constexpr int kNumCtx = 49;

inline int GradQ(int d) {
  int a = d < 0 ? -d : d;
  if (a == 0) return 0;
  if (a <= 1) return 1;
  if (a <= 2) return 2;
  if (a <= 4) return 3;
  if (a <= 8) return 4;
  if (a <= 16) return 5;
  return 6;
}

inline int Med(int a, int b, int c) {
  int mx = a > b ? a : b;
  int mn = a < b ? a : b;
  if (c >= mx) return mn;
  if (c <= mn) return mx;
  return a + b - c;
}

inline int BitLength(uint32_t v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// Per-context bias tracker (LOCO-I style running error mean with halving).
struct Bias {
  int32_t sum = 0;
  int32_t cnt = 1;
  int Correction() const {
    // round-to-nearest of sum/cnt, stable for negative sums
    return sum >= 0 ? (sum + cnt / 2) / cnt : -((-sum + cnt / 2) / cnt);
  }
  void Update(int e) {
    sum += e;
    if (++cnt >= 64) {
      cnt >>= 1;
      sum >>= 1;  // arithmetic shift keeps sign
    }
  }
};

struct Models {
  std::vector<uint16_t> nbits_probs;
  std::vector<uint16_t> hi_probs;  // 2 post-MSB bits, per (ctx, nbits) tree
  Bias bias[kNumCtx];
  Models()
      : nbits_probs(kNumCtx * (1 << kNbitsTree), lbdrn::kProbInit),
        hi_probs(kNumCtx * 18 * 4, lbdrn::kProbInit) {}
};

std::vector<uint8_t> EncodeBand(const uint16_t* band, int h, int w) {
  lbdrn::RangeEncoder enc;
  Models m;
  for (int i = 0; i < h; ++i) {
    const uint16_t* row = band + static_cast<size_t>(i) * w;
    const uint16_t* up = i > 0 ? row - w : nullptr;
    for (int j = 0; j < w; ++j) {
      int a = j > 0 ? row[j - 1] : (up ? up[j] : 0);
      int b = up ? up[j] : a;
      int c = (up && j > 0) ? up[j - 1] : b;
      int ctx = GradQ(b - c) * 7 + GradQ(c - a);
      int pred = Med(a, b, c) + m.bias[ctx].Correction();
      pred = pred < 0 ? 0 : (pred > 65535 ? 65535 : pred);
      int e = static_cast<int>(row[j]) - pred;
      m.bias[ctx].Update(e);
      uint32_t v = e >= 0 ? (static_cast<uint32_t>(e) << 1)
                          : ((static_cast<uint32_t>(-e) << 1) - 1);
      int nbits = BitLength(v);
      enc.EncodeTree(&m.nbits_probs[ctx << kNbitsTree], kNbitsTree,
                     static_cast<uint32_t>(nbits));
      int s = nbits - 2;
      if (s >= 1) {  // two bits below the implied MSB, coded adaptively
        uint32_t hi = (v >> (s - 1)) & 3;
        enc.EncodeTree(&m.hi_probs[(ctx * 18 + nbits) * 4], 2, hi);
        s -= 2;
      } else if (s == 0) {
        enc.EncodeBit(&m.hi_probs[(ctx * 18 + nbits) * 4 + 1], (v >> s) & 1);
        s -= 1;
      }
      for (; s >= 0; --s) enc.EncodeBitRaw((v >> s) & 1);
    }
  }
  return enc.Finish();
}

void DecodeBand(const uint8_t* data, size_t len, uint16_t* band, int h, int w) {
  lbdrn::RangeDecoder dec(data, len);
  Models m;
  for (int i = 0; i < h; ++i) {
    uint16_t* row = band + static_cast<size_t>(i) * w;
    const uint16_t* up = i > 0 ? row - w : nullptr;
    for (int j = 0; j < w; ++j) {
      int a = j > 0 ? row[j - 1] : (up ? up[j] : 0);
      int b = up ? up[j] : a;
      int c = (up && j > 0) ? up[j - 1] : b;
      int ctx = GradQ(b - c) * 7 + GradQ(c - a);
      int pred = Med(a, b, c) + m.bias[ctx].Correction();
      pred = pred < 0 ? 0 : (pred > 65535 ? 65535 : pred);
      int nbits = static_cast<int>(
          dec.DecodeTree(&m.nbits_probs[ctx << kNbitsTree], kNbitsTree));
      uint32_t v = 0;
      if (nbits > 0) {
        v = 1;
        int s = nbits - 2;
        if (s >= 1) {
          uint32_t hi = dec.DecodeTree(&m.hi_probs[(ctx * 18 + nbits) * 4], 2);
          v = (v << 2) | hi;
          s -= 2;
        } else if (s == 0) {
          v = (v << 1) |
              dec.DecodeBit(&m.hi_probs[(ctx * 18 + nbits) * 4 + 1]);
          s -= 1;
        }
        for (; s >= 0; --s) v = (v << 1) | dec.DecodeBitRaw();
      }
      int e = (v & 1) ? -static_cast<int>((v + 1) >> 1)
                      : static_cast<int>(v >> 1);
      int x = pred + e;
      m.bias[ctx].Update(e);
      row[j] = static_cast<uint16_t>(x);
    }
  }
}

template <typename F>
void RunPool(int n_tasks, F fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = static_cast<int>(hw ? hw : 2);
  if (nthreads > n_tasks) nthreads = n_tasks;
  std::atomic<int> next{0};
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n_tasks; i = next.fetch_add(1))
        fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

struct V2Layout {
  int c, h, w, itemsize, chunk_rows, n_chunks;
  uint16_t max_val;
  std::vector<uint64_t> starts;  // payload offset per (ci * n_chunks + k)
  std::vector<uint32_t> sizes;
};

int ParseV2(const uint8_t* data, uint64_t len, V2Layout* out) {
  if (len < kHdr2 || std::memcmp(data, kMagic, 4) != 0 ||
      data[4] != kVersion2)
    return 1;
  out->itemsize = data[5];
  out->c = data[6];
  uint32_t h32, w32, cr32;
  std::memcpy(&h32, data + 7, 4);
  std::memcpy(&w32, data + 11, 4);
  std::memcpy(&cr32, data + 15, 4);
  std::memcpy(&out->max_val, data + 19, 2);
  out->h = static_cast<int>(h32);
  out->w = static_cast<int>(w32);
  out->chunk_rows = static_cast<int>(cr32);
  // mirror lpc_compress2's input validation: a c=0 or bad-itemsize stream
  // must fail the parse, not "succeed" with an uninitialized output
  if (out->h < 1 || out->w < 1 || out->chunk_rows < 1 || out->c < 1 ||
      (out->itemsize != 1 && out->itemsize != 2))
    return 1;
  out->n_chunks = (out->h + out->chunk_rows - 1) / out->chunk_rows;
  int nt = out->c * out->n_chunks;
  if (len < kHdr2 + 4ull * nt) return 1;
  out->sizes.resize(nt);
  out->starts.resize(nt);
  uint64_t off = kHdr2;
  for (int i = 0; i < nt; ++i) {
    std::memcpy(&out->sizes[i], data + off, 4);
    off += 4;
  }
  for (int i = 0; i < nt; ++i) {
    out->starts[i] = off;
    off += out->sizes[i];
  }
  return off > len ? 1 : 0;
}

}  // namespace

extern "C" {

// input: CHW uint16 samples (uint8 sources widened by the caller).
// itemsize records the original sample width for the decoder.
// *out malloc'd; free with lbdrn_free. Returns 0 on success.
int lpc_compress(const uint16_t* data, int c, int h, int w, int itemsize,
                 uint8_t** out, uint64_t* out_len) {
  if (c < 1 || h < 1 || w < 1 || (itemsize != 1 && itemsize != 2)) return 1;
  std::vector<std::vector<uint8_t>> bands(c);
  std::vector<std::thread> threads;
  threads.reserve(c);
  for (int ci = 0; ci < c; ++ci) {
    threads.emplace_back([&, ci] {
      bands[ci] = EncodeBand(data + static_cast<size_t>(ci) * h * w, h, w);
    });
  }
  for (auto& t : threads) t.join();

  uint64_t total = 7 + 8 + 4ull * c;
  for (auto& b : bands) total += b.size();
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(total));
  if (!buf) return 2;
  std::memcpy(buf, kMagic, 4);
  buf[4] = kVersion;
  buf[5] = static_cast<uint8_t>(itemsize);
  buf[6] = static_cast<uint8_t>(c);
  uint32_t h32 = h, w32 = w;
  std::memcpy(buf + 7, &h32, 4);
  std::memcpy(buf + 11, &w32, 4);
  uint64_t off = 15;
  for (auto& b : bands) {
    uint32_t n = static_cast<uint32_t>(b.size());
    std::memcpy(buf + off, &n, 4);
    off += 4;
  }
  for (auto& b : bands) {
    std::memcpy(buf + off, b.data(), b.size());
    off += b.size();
  }
  *out = buf;
  *out_len = off;
  return 0;
}

int lpc_peek(const uint8_t* data, uint64_t len, int* c, int* h, int* w,
             int* itemsize) {
  if (len < 15 || std::memcmp(data, kMagic, 4) != 0) return 1;
  if (data[4] == kVersion2) {
    V2Layout l;
    if (ParseV2(data, len, &l) != 0) return 1;
    *c = l.c;
    *h = l.h;
    *w = l.w;
    *itemsize = l.itemsize;
    return 0;
  }
  if (data[4] != kVersion) return 1;
  *itemsize = data[5];
  *c = data[6];
  uint32_t h32, w32;
  std::memcpy(&h32, data + 7, 4);
  std::memcpy(&w32, data + 11, 4);
  *h = static_cast<int>(h32);
  *w = static_cast<int>(w32);
  if (*h < 1 || *w < 1 || *c < 1 || (*itemsize != 1 && *itemsize != 2))
    return 1;
  return 0;
}

// v2 chunk metadata: chunk_rows/n_chunks/max_val (0/1/0 + rc=1 for v1).
int lpc_peek2(const uint8_t* data, uint64_t len, int* chunk_rows,
              int* n_chunks, int* max_val) {
  V2Layout l;
  if (ParseV2(data, len, &l) != 0) return 1;
  *chunk_rows = l.chunk_rows;
  *n_chunks = l.n_chunks;
  *max_val = l.max_val;
  return 0;
}

// Row-chunked compress (wire v2).  chunk_rows <= 0 picks v1 behavior is
// NOT supported here — callers choose the version explicitly.
int lpc_compress2(const uint16_t* data, int c, int h, int w, int itemsize,
                  int chunk_rows, uint8_t** out, uint64_t* out_len) {
  if (c < 1 || h < 1 || w < 1 || chunk_rows < 1 ||
      (itemsize != 1 && itemsize != 2))
    return 1;
  int nk = (h + chunk_rows - 1) / chunk_rows;
  int nt = c * nk;
  std::vector<std::vector<uint8_t>> chunks(nt);
  uint16_t max_val = 0;
  for (uint64_t i = 0; i < static_cast<uint64_t>(c) * h * w; ++i)
    if (data[i] > max_val) max_val = data[i];
  RunPool(nt, [&](int t) {
    int ci = t / nk, k = t % nk;
    int r0 = k * chunk_rows;
    int rows = h - r0 < chunk_rows ? h - r0 : chunk_rows;
    chunks[t] = EncodeBand(
        data + static_cast<size_t>(ci) * h * w +
            static_cast<size_t>(r0) * w,
        rows, w);
  });

  uint64_t total = kHdr2 + 4ull * nt;
  for (auto& b : chunks) total += b.size();
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(total));
  if (!buf) return 2;
  std::memcpy(buf, kMagic, 4);
  buf[4] = kVersion2;
  buf[5] = static_cast<uint8_t>(itemsize);
  buf[6] = static_cast<uint8_t>(c);
  uint32_t h32 = h, w32 = w, cr32 = chunk_rows;
  std::memcpy(buf + 7, &h32, 4);
  std::memcpy(buf + 11, &w32, 4);
  std::memcpy(buf + 15, &cr32, 4);
  std::memcpy(buf + 19, &max_val, 2);
  uint64_t off = kHdr2;
  for (auto& b : chunks) {
    uint32_t n = static_cast<uint32_t>(b.size());
    std::memcpy(buf + off, &n, 4);
    off += 4;
  }
  for (auto& b : chunks) {
    std::memcpy(buf + off, b.data(), b.size());
    off += b.size();
  }
  *out = buf;
  *out_len = off;
  return 0;
}

// Decode ONE (channel, chunk) into out (chunk's rows * w uint16) — the
// incremental unit the Python decode pipeline schedules.
int lpc_decompress_chunk(const uint8_t* data, uint64_t len, int ci, int k,
                         uint16_t* out, uint64_t out_cap) {
  V2Layout l;
  if (ParseV2(data, len, &l) != 0) return 1;
  if (ci < 0 || ci >= l.c || k < 0 || k >= l.n_chunks) return 1;
  int r0 = k * l.chunk_rows;
  int rows = l.h - r0 < l.chunk_rows ? l.h - r0 : l.chunk_rows;
  if (out_cap < static_cast<uint64_t>(rows) * l.w) return 2;
  int t = ci * l.n_chunks + k;
  DecodeBand(data + l.starts[t], l.sizes[t], out, rows, l.w);
  return 0;
}

// out must hold c*h*w uint16.
int lpc_decompress(const uint8_t* data, uint64_t len, uint16_t* out,
                   uint64_t out_cap) {
  int c, h, w, itemsize;
  if (lpc_peek(data, len, &c, &h, &w, &itemsize) != 0) return 1;
  uint64_t n = static_cast<uint64_t>(c) * h * w;
  if (out_cap < n) return 2;
  if (data[4] == kVersion2) {
    V2Layout l;
    if (ParseV2(data, len, &l) != 0) return 1;
    RunPool(l.c * l.n_chunks, [&](int t) {
      int ci = t / l.n_chunks, k = t % l.n_chunks;
      int r0 = k * l.chunk_rows;
      int rows = l.h - r0 < l.chunk_rows ? l.h - r0 : l.chunk_rows;
      DecodeBand(data + l.starts[t], l.sizes[t],
                 out + static_cast<size_t>(ci) * l.h * l.w +
                     static_cast<size_t>(r0) * l.w,
                 rows, l.w);
    });
    return 0;
  }
  if (len < 15 + 4ull * c) return 3;  // size table must be in-bounds
  std::vector<uint32_t> sizes(c);
  uint64_t off = 15;
  for (int ci = 0; ci < c; ++ci) {
    std::memcpy(&sizes[ci], data + off, 4);
    off += 4;
  }
  std::vector<uint64_t> starts(c);
  for (int ci = 0; ci < c; ++ci) {
    starts[ci] = off;
    off += sizes[ci];
  }
  if (off > len) return 3;
  std::vector<std::thread> threads;
  threads.reserve(c);
  for (int ci = 0; ci < c; ++ci) {
    threads.emplace_back([&, ci] {
      DecodeBand(data + starts[ci], sizes[ci],
                 out + static_cast<size_t>(ci) * h * w, h, w);
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
