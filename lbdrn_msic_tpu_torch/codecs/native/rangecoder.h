// Adaptive binary range coder (carry-propagating, LZMA-style renorm).
//
// Byte-exact mirror of the Python reference implementation in
// lbdrn_msic_tpu/codecs/rangecoder.py — the two must stay in lockstep;
// tests/test_native.py verifies stream identity.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace lbdrn {

constexpr int kProbBits = 11;
constexpr uint16_t kProbInit = 1 << (kProbBits - 1);
constexpr uint16_t kProbMax = 1 << kProbBits;
constexpr int kAdaptShift = 5;
constexpr uint32_t kTop = 1u << 24;

class RangeEncoder {
 public:
  RangeEncoder() : low_(0), range_(0xFFFFFFFFu), cache_(0), cache_size_(1) {}

  void EncodeBit(uint16_t* prob, int bit) {
    uint32_t bound = (range_ >> kProbBits) * (*prob);
    if (bit == 0) {
      range_ = bound;
      *prob += (kProbMax - *prob) >> kAdaptShift;
    } else {
      low_ += bound;
      range_ -= bound;
      *prob -= *prob >> kAdaptShift;
    }
    while (range_ < kTop) {
      ShiftLow();
      range_ <<= 8;
    }
  }

  void EncodeBitRaw(int bit) {
    range_ >>= 1;
    if (bit) low_ += range_;
    while (range_ < kTop) {
      ShiftLow();
      range_ <<= 8;
    }
  }

  // Bit-tree encode `value` (nbits wide, MSB first); probs has 2^nbits slots.
  void EncodeTree(uint16_t* probs, int nbits, uint32_t value) {
    uint32_t ctx = 1;
    for (int shift = nbits - 1; shift >= 0; --shift) {
      int bit = (value >> shift) & 1;
      EncodeBit(&probs[ctx], bit);
      ctx = (ctx << 1) | bit;
    }
  }

  std::vector<uint8_t> Finish() {
    for (int i = 0; i < 5; ++i) ShiftLow();
    return std::move(out_);
  }

 private:
  void ShiftLow() {
    if (low_ < 0xFF000000ull || low_ > 0xFFFFFFFFull) {
      uint8_t carry = static_cast<uint8_t>(low_ >> 32);
      out_.push_back(static_cast<uint8_t>(cache_ + carry));
      while (cache_size_ > 1) {
        out_.push_back(static_cast<uint8_t>(0xFF + carry));
        --cache_size_;
      }
      cache_ = static_cast<uint8_t>(low_ >> 24);
      cache_size_ = 0;
    }
    ++cache_size_;
    low_ = (low_ << 8) & 0xFFFFFFFFull;
  }

  uint64_t low_;
  uint32_t range_;
  uint8_t cache_;
  int64_t cache_size_;
  std::vector<uint8_t> out_;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t* data, size_t n)
      : data_(data), n_(n), pos_(1), range_(0xFFFFFFFFu), code_(0) {
    for (int i = 0; i < 4; ++i) code_ = (code_ << 8) | Next();
  }

  int DecodeBit(uint16_t* prob) {
    uint32_t bound = (range_ >> kProbBits) * (*prob);
    int bit;
    if (code_ < bound) {
      bit = 0;
      range_ = bound;
      *prob += (kProbMax - *prob) >> kAdaptShift;
    } else {
      bit = 1;
      code_ -= bound;
      range_ -= bound;
      *prob -= *prob >> kAdaptShift;
    }
    while (range_ < kTop) {
      range_ <<= 8;
      code_ = (code_ << 8) | Next();
    }
    return bit;
  }

  int DecodeBitRaw() {
    range_ >>= 1;
    int bit = code_ >= range_ ? 1 : 0;
    if (bit) code_ -= range_;
    while (range_ < kTop) {
      range_ <<= 8;
      code_ = (code_ << 8) | Next();
    }
    return bit;
  }

  uint32_t DecodeTree(uint16_t* probs, int nbits) {
    uint32_t ctx = 1;
    for (int i = 0; i < nbits; ++i) ctx = (ctx << 1) | DecodeBit(&probs[ctx]);
    return ctx - (1u << nbits);
  }

 private:
  uint8_t Next() { return pos_ < n_ ? data_[pos_++] : (++pos_, 0); }

  const uint8_t* data_;
  size_t n_;
  size_t pos_;
  uint32_t range_;
  uint32_t code_;
};

inline std::vector<uint16_t> NewProbs(size_t n) {
  return std::vector<uint16_t>(n, kProbInit);
}

}  // namespace lbdrn
