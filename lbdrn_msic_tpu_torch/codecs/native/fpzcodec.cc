// LFPZ weight codec — native implementation.
//
// Precision-limited float32 compression for network weights (the role
// fpzip plays in the reference: encode.py:129 / decode.py:113).
// Byte-exact mirror of lbdrn_msic_tpu/codecs/weights.py; see that module
// for the format description.
//
// Wire: b"LFPZ" | u8 version=1 | u8 precision | u32le count | payload.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "rangecoder.h"

namespace {

constexpr uint8_t kMagic[4] = {'L', 'F', 'P', 'Z'};
constexpr uint8_t kVersion = 1;

inline uint32_t ToCode(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

inline float FromCode(uint32_t code) {
  uint32_t bits =
      (code & 0x80000000u) ? (code & 0x7FFFFFFFu) : ~code;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

struct ChunkPlan {
  int n_chunks;
  int first_bits;
  int shifts[4];  // MSB-first shift for each chunk
};

ChunkPlan PlanChunks(int precision) {
  ChunkPlan p;
  p.n_chunks = (precision + 7) / 8;
  p.first_bits = precision - 8 * (p.n_chunks - 1);
  int acc = 0;
  for (int i = p.n_chunks - 1; i >= 0; --i) {
    p.shifts[i] = acc;
    acc += (i == 0) ? p.first_bits : 8;
  }
  return p;
}

}  // namespace

extern "C" {

void lbdrn_free(void* p) { std::free(p); }

// Returns 0 on success. *out is malloc'd; caller frees with lbdrn_free.
int lfpz_compress(const float* values, uint64_t count, int precision,
                  uint8_t** out, uint64_t* out_len) {
  if (precision < 4 || precision > 32) return 1;
  ChunkPlan plan = PlanChunks(precision);
  const uint32_t first_mask = (plan.first_bits == 32)
                                  ? 0xFFFFFFFFu
                                  : ((1u << plan.first_bits) - 1);

  lbdrn::RangeEncoder enc;
  const size_t tree = 1u << plan.first_bits;
  std::vector<uint16_t> top_probs(tree * tree, lbdrn::kProbInit);
  std::vector<uint16_t> low_probs((plan.n_chunks - 1) * 256, lbdrn::kProbInit);
  uint32_t prev_top = 0;
  for (uint64_t i = 0; i < count; ++i) {
    uint32_t q = ToCode(values[i]);
    if (precision < 32) q >>= (32 - precision);
    uint32_t top = (q >> plan.shifts[0]) & first_mask;
    enc.EncodeTree(&top_probs[prev_top * tree], plan.first_bits, top);
    prev_top = top;
    for (int ci = 1; ci < plan.n_chunks; ++ci) {
      uint32_t byte = (q >> plan.shifts[ci]) & 0xFF;
      enc.EncodeTree(&low_probs[(ci - 1) * 256], 8, byte);
    }
  }
  std::vector<uint8_t> payload = enc.Finish();

  uint64_t total = 10 + payload.size();
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(total));
  if (!buf) return 2;
  std::memcpy(buf, kMagic, 4);
  buf[4] = kVersion;
  buf[5] = static_cast<uint8_t>(precision);
  uint32_t n32 = static_cast<uint32_t>(count);
  std::memcpy(buf + 6, &n32, 4);  // little-endian (x86/arm)
  std::memcpy(buf + 10, payload.data(), payload.size());
  *out = buf;
  *out_len = total;
  return 0;
}

// Reads header only: fills count and precision. Returns 0 on success.
int lfpz_peek(const uint8_t* data, uint64_t len, uint64_t* count,
              int* precision) {
  if (len < 10 || std::memcmp(data, kMagic, 4) != 0 || data[4] != kVersion)
    return 1;
  *precision = data[5];
  uint32_t n32;
  std::memcpy(&n32, data + 6, 4);
  *count = n32;
  return 0;
}

// out must have room for `count` floats (from lfpz_peek).
int lfpz_decompress(const uint8_t* data, uint64_t len, float* out,
                    uint64_t out_cap) {
  uint64_t count;
  int precision;
  if (lfpz_peek(data, len, &count, &precision) != 0) return 1;
  if (out_cap < count) return 2;
  ChunkPlan plan = PlanChunks(precision);

  lbdrn::RangeDecoder dec(data + 10, len - 10);
  const size_t tree = 1u << plan.first_bits;
  std::vector<uint16_t> top_probs(tree * tree, lbdrn::kProbInit);
  std::vector<uint16_t> low_probs((plan.n_chunks - 1) * 256, lbdrn::kProbInit);
  uint32_t prev_top = 0;
  for (uint64_t i = 0; i < count; ++i) {
    uint32_t top = dec.DecodeTree(&top_probs[prev_top * tree], plan.first_bits);
    prev_top = top;
    uint32_t q = top << plan.shifts[0];
    for (int ci = 1; ci < plan.n_chunks; ++ci) {
      q |= dec.DecodeTree(&low_probs[(ci - 1) * 256], 8) << plan.shifts[ci];
    }
    if (precision < 32) q <<= (32 - precision);
    out[i] = FromCode(q);
  }
  return 0;
}

}  // extern "C"
