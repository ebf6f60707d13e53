"""Bitstream header codec.

Two wire formats:

- **v0** — byte-for-byte the reference's layout (reference encode.py:37-64,
  decode.py:25-53): ``[1B header_len][1B split_ratio][2B width][2B height]
  [1B K<<4|D][1B log2(bc)<<4|nl][3B nn_bytes x sr^2][4B base_bytes x sr^2]``,
  all big-endian unsigned.  Kept for parity testing; inherits the reference's
  limits (w/h <= 65535, K,D <= 15, bc a power of two, header <= 255 bytes).

- **v1** (default) — self-describing: adds feature-set switches (fixing the
  reference's silent coupling to constants.py, see SURVEY §5 config row),
  codec identifiers, and 4-byte dimensions.  Starts with magic byte 0xFF,
  which no valid v0 header can produce (v0 header length is
  ``8 + 7*sr^2`` which never equals 255).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

from lbdrn_msic_tpu_torch.core.config import (
    BASE_CODEC_IDS,
    BASE_CODEC_NAMES,
    WEIGHT_CODEC_IDS,
    WEIGHT_CODEC_NAMES,
    CodecConfig,
    FeatureSpec,
    ModelSpec,
)

V1_MAGIC = 0xFF


@dataclasses.dataclass(frozen=True)
class StreamHeader:
    split_ratio: int
    width: int
    height: int
    K: int
    D: int
    base_channel: int
    num_layers: int
    nn_bytes: List[int]
    base_bytes: List[int]
    # v1-only fields (defaults match reference constants.py:1-14)
    use_coords: bool = False
    embedding: bool = False
    use_colors: bool = True
    relative: bool = True
    base_codec: str = "jp2"
    weight_codec: str = "fpz"
    precision: int = 16
    version: int = 1

    @property
    def n_tiles(self) -> int:
        return self.split_ratio**2

    def feature_spec(self) -> FeatureSpec:
        return FeatureSpec(
            use_coords=self.use_coords,
            embedding=self.embedding,
            use_colors=self.use_colors,
            relative=self.relative,
            D=self.D,
        )

    def model_spec(self) -> ModelSpec:
        return ModelSpec(base_channel=self.base_channel, num_layers=self.num_layers)


def header_from_config(
    cfg: CodecConfig,
    width: int,
    height: int,
    nn_bytes: List[int],
    base_bytes: List[int],
    version: int = 1,
) -> StreamHeader:
    f = cfg.features
    return StreamHeader(
        split_ratio=cfg.split_ratio,
        width=width,
        height=height,
        K=cfg.K,
        D=f.D,
        base_channel=cfg.model.base_channel,
        num_layers=cfg.model.num_layers,
        nn_bytes=list(nn_bytes),
        base_bytes=list(base_bytes),
        use_coords=f.use_coords,
        embedding=f.embedding,
        use_colors=f.use_colors,
        relative=f.relative,
        base_codec=cfg.base_codec,
        weight_codec=cfg.weight_codec,
        precision=cfg.precision,
        version=version,
    )


def _check_common(h: StreamHeader) -> None:
    if len(h.nn_bytes) != h.n_tiles or len(h.base_bytes) != h.n_tiles:
        raise ValueError(
            f"expected {h.n_tiles} per-tile sizes, got "
            f"{len(h.nn_bytes)} nn / {len(h.base_bytes)} base"
        )
    if not (1 <= h.K <= 15) or not (0 <= h.D <= 15):
        raise ValueError(f"K={h.K}, D={h.D} must fit 4-bit fields")
    if h.base_channel & (h.base_channel - 1):
        raise ValueError("base_channel must be a power of two")
    for n in h.nn_bytes:
        if n >= 1 << 24:
            raise ValueError(f"nn stream too large for 3-byte field: {n}")
    for n in h.base_bytes:
        if n >= 1 << 32:
            raise ValueError(f"base stream too large for 4-byte field: {n}")


def encode_header(h: StreamHeader) -> bytes:
    _check_common(h)
    if h.version == 0:
        return _encode_v0(h)
    return _encode_v1(h)


def decode_header(data: bytes) -> StreamHeader:
    if data[0] == V1_MAGIC:
        return _decode_v1(data)
    return _decode_v0(data)


def header_size(data: bytes) -> int:
    if data[0] == V1_MAGIC:
        return struct.unpack_from(">H", data, 2)[0]
    return data[0]


# ---------------------------------------------------------------- v0 wire


def _encode_v0(h: StreamHeader) -> bytes:
    if h.width > 0xFFFF or h.height > 0xFFFF:
        raise ValueError("v0 header caps width/height at 65535")
    n = 8 + 3 * h.n_tiles + 4 * h.n_tiles
    if n > 0xFF:
        raise ValueError(f"v0 header length {n} exceeds one byte; use v1")
    out = bytearray()
    out.append(n)
    out.append(h.split_ratio)
    out += struct.pack(">HH", h.width, h.height)
    out.append((h.K << 4) | h.D)
    log2bc = h.base_channel.bit_length() - 1
    out.append((log2bc << 4) | h.num_layers)
    for v in h.nn_bytes:
        out += v.to_bytes(3, "big")
    for v in h.base_bytes:
        out += v.to_bytes(4, "big")
    assert len(out) == n
    return bytes(out)


def _decode_v0(data: bytes) -> StreamHeader:
    n = data[0]
    sr = data[1]
    width, height = struct.unpack_from(">HH", data, 2)
    K, D = data[6] >> 4, data[6] & 0xF
    bc, nl = 1 << (data[7] >> 4), data[7] & 0xF
    ptr = 8
    nn_bytes, base_bytes = [], []
    for _ in range(sr * sr):
        nn_bytes.append(int.from_bytes(data[ptr : ptr + 3], "big"))
        ptr += 3
    for _ in range(sr * sr):
        base_bytes.append(int.from_bytes(data[ptr : ptr + 4], "big"))
        ptr += 4
    if ptr != n:
        raise ValueError(f"v0 header length mismatch: field says {n}, parsed {ptr}")
    return StreamHeader(
        split_ratio=sr, width=width, height=height, K=K, D=D,
        base_channel=bc, num_layers=nl,
        nn_bytes=nn_bytes, base_bytes=base_bytes, version=0,
    )


# ---------------------------------------------------------------- v1 wire


def _flags_byte(h: StreamHeader) -> int:
    return (
        int(h.use_coords)
        | (int(h.embedding) << 1)
        | (int(h.use_colors) << 2)
        | (int(h.relative) << 3)
        | (WEIGHT_CODEC_IDS[h.weight_codec] << 4)
        | (BASE_CODEC_IDS[h.base_codec] << 6)
    )


def _encode_v1(h: StreamHeader) -> bytes:
    out = bytearray()
    out.append(V1_MAGIC)
    out.append(1)  # version
    out += b"\x00\x00"  # header length placeholder (u16)
    out.append(h.split_ratio)
    out += struct.pack(">II", h.width, h.height)
    out.append((h.K << 4) | h.D)
    log2bc = h.base_channel.bit_length() - 1
    out.append((log2bc << 4) | h.num_layers)
    out.append(_flags_byte(h))
    out.append(h.precision)
    for v in h.nn_bytes:
        out += v.to_bytes(3, "big")
    for v in h.base_bytes:
        out += v.to_bytes(4, "big")
    if len(out) > 0xFFFF:
        raise ValueError(
            f"v1 header {len(out)} bytes exceeds the u16 length field "
            f"(split_ratio {h.split_ratio} too large)"
        )
    struct.pack_into(">H", out, 2, len(out))
    return bytes(out)


def _decode_v1(data: bytes) -> StreamHeader:
    if data[0] != V1_MAGIC or data[1] != 1:
        raise ValueError("not a v1 header")
    (n,) = struct.unpack_from(">H", data, 2)
    sr = data[4]
    width, height = struct.unpack_from(">II", data, 5)
    K, D = data[13] >> 4, data[13] & 0xF
    bc, nl = 1 << (data[14] >> 4), data[14] & 0xF
    flags = data[15]
    precision = data[16]
    ptr = 17
    nn_bytes, base_bytes = [], []
    for _ in range(sr * sr):
        nn_bytes.append(int.from_bytes(data[ptr : ptr + 3], "big"))
        ptr += 3
    for _ in range(sr * sr):
        base_bytes.append(int.from_bytes(data[ptr : ptr + 4], "big"))
        ptr += 4
    if ptr != n:
        raise ValueError(f"v1 header length mismatch: field says {n}, parsed {ptr}")
    return StreamHeader(
        split_ratio=sr, width=width, height=height, K=K, D=D,
        base_channel=bc, num_layers=nl,
        nn_bytes=nn_bytes, base_bytes=base_bytes,
        use_coords=bool(flags & 1),
        embedding=bool(flags & 2),
        use_colors=bool(flags & 4),
        relative=bool(flags & 8),
        weight_codec=WEIGHT_CODEC_NAMES[(flags >> 4) & 0x3],
        base_codec=BASE_CODEC_NAMES[(flags >> 6) & 0x3],
        precision=precision,
        version=1,
    )
