// Residual bitplane assembly — the decode hot loop on the host side.
//
// The decoder ships K residual bitplanes per row band over the slow d2h
// link (decode/reconstruct.py::_pack_bitplanes — exactly K bits per
// subpixel on the wire) and the host reconstructs
//   out[i] = (base[i] << K) + sum_j bit_j(i) << j .
// numpy does this as K unpackbits passes + K shift/or passes, writing
// ~K x n bytes of intermediates; this routine is ONE pass with no
// intermediates (the bitplane bit order matches np.unpackbits 'big':
// bit t of byte b is sample b*8 + t, weight 1 << (7 - t)).
//
// Single-threaded by design: the Python caller already overlaps bands in
// a thread pool, and ctypes releases the GIL around the call.

#include <cstdint>

extern "C" {

// planes: K pointers, each holding ceil(n/8) bytes of bitplane j.
// base is uint8 (base_is8 != 0) or uint16; out: n uint16.
// Returns 0 on success.
int lbdrn_assemble_residual(const uint8_t* const* planes, int K,
                            const void* base, int base_is8,
                            uint16_t* out, uint64_t n) {
  if (K < 0 || K > 16 || !out) return 1;
  const uint8_t* b8 = static_cast<const uint8_t*>(base);
  const uint16_t* b16 = static_cast<const uint16_t*>(base);
  uint64_t nb = n / 8;
  uint64_t i = 0;
  for (uint64_t b = 0; b < nb; ++b) {
    uint16_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int j = 0; j < K; ++j) {
      uint8_t byte = planes[j][b];
      for (int t = 0; t < 8; ++t)
        v[t] |= static_cast<uint16_t>((byte >> (7 - t)) & 1) << j;
    }
    if (base_is8) {
      for (int t = 0; t < 8; ++t, ++i)
        out[i] = static_cast<uint16_t>((b8[i] << K) + v[t]);
    } else {
      for (int t = 0; t < 8; ++t, ++i)
        out[i] = static_cast<uint16_t>((b16[i] << K) + v[t]);
    }
  }
  for (int t = 0; i < n; ++t, ++i) {  // tail samples of a partial byte
    uint16_t v = 0;
    for (int j = 0; j < K; ++j)
      v |= static_cast<uint16_t>((planes[j][nb] >> (7 - t)) & 1) << j;
    uint16_t bb = base_is8 ? b8[i] : b16[i];
    out[i] = static_cast<uint16_t>((bb << K) + v);
  }
  return 0;
}

}  // extern "C"
