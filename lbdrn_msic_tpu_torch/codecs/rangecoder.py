"""Adaptive binary range coder (carry-propagating, LZMA-style renormalization).

Pure-Python reference implementation of the entropy-coding layer shared by
the weight codec (codecs/weights.py) and the lossless base-layer codec
(codecs/lpc.py).  The native C++ implementation (codecs/native/) mirrors this
arithmetic exactly — streams are byte-identical across the two.

Model: 11-bit probabilities (scale 2048), init 1024, adaptation shift 5.
"""

from __future__ import annotations

PROB_BITS = 11
PROB_INIT = 1 << (PROB_BITS - 1)
PROB_MAX = 1 << PROB_BITS
ADAPT_SHIFT = 5
TOP = 1 << 24
MASK32 = 0xFFFFFFFF


class RangeEncoder:
    def __init__(self):
        self.low = 0
        self.range = MASK32
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > MASK32:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            while self.cache_size > 1:
                self.out.append((0xFF + carry) & 0xFF)
                self.cache_size -= 1
            self.cache = (self.low >> 24) & 0xFF
            self.cache_size = 0
        self.cache_size += 1
        self.low = (self.low << 8) & MASK32

    def encode_bit(self, probs, ctx, bit):
        p = probs[ctx]
        bound = (self.range >> PROB_BITS) * p
        if bit == 0:
            self.range = bound
            probs[ctx] = p + ((PROB_MAX - p) >> ADAPT_SHIFT)
        else:
            self.low += bound
            self.range -= bound
            probs[ctx] = p - (p >> ADAPT_SHIFT)
        while self.range < TOP:
            self._shift_low()
            self.range = (self.range << 8) & MASK32

    def encode_bit_raw(self, bit):
        self.range >>= 1
        if bit:
            self.low += self.range
        while self.range < TOP:
            self._shift_low()
            self.range = (self.range << 8) & MASK32

    def encode_tree(self, probs, nbits, value):
        """Bit-tree encode `value` (nbits wide, MSB first); probs has 2^nbits slots."""
        ctx = 1
        for shift in range(nbits - 1, -1, -1):
            bit = (value >> shift) & 1
            self.encode_bit(probs, ctx, bit)
            ctx = (ctx << 1) | bit

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 1  # first byte emitted by the encoder is always 0
        self.range = MASK32
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._next()) & MASK32

    def _next(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode_bit(self, probs, ctx) -> int:
        p = probs[ctx]
        bound = (self.range >> PROB_BITS) * p
        if self.code < bound:
            bit = 0
            self.range = bound
            probs[ctx] = p + ((PROB_MAX - p) >> ADAPT_SHIFT)
        else:
            bit = 1
            self.code -= bound
            self.range -= bound
            probs[ctx] = p - (p >> ADAPT_SHIFT)
        while self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self.code = ((self.code << 8) | self._next()) & MASK32
        return bit

    def decode_bit_raw(self) -> int:
        self.range >>= 1
        bit = 1 if self.code >= self.range else 0
        if bit:
            self.code -= self.range
        while self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self.code = ((self.code << 8) | self._next()) & MASK32
        return bit

    def decode_tree(self, probs, nbits) -> int:
        ctx = 1
        for _ in range(nbits):
            ctx = (ctx << 1) | self.decode_bit(probs, ctx)
        return ctx - (1 << nbits)


def new_probs(n: int):
    return [PROB_INIT] * n
