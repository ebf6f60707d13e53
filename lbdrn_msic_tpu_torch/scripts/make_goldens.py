"""Write the seven wire-format fixtures with the port's encoders, the
counterpart of scripts/make_goldens.py.

One fixture per wire format docs/FORMAT.md specifies: LLPC v1, LLPC v2
(row-chunked, with remainder rows), LJ2C (lossless JP2 container), LJ2L
(lossy JP2 container), LFPZ (the weight stream of a fixed float vector), a
v0-header codec stream and an sr=2 tiled stream, from the same seeded
sources as the JAX script, with the hashes it prints.  The committed
fixtures in tests/data/ are the JAX suite's and are never written here:
`--out` has no default there.  The deterministic coders (LLPC, LFPZ) and
the sources come out byte for byte the JAX script's; the codec streams
are the port's training on the chosen device.

    python -m lbdrn_msic_tpu_torch.scripts.make_goldens
        [--out out/goldens] [--device cuda|cpu]

The LJ2C / LJ2L fixtures and the two codec streams (jp2 base) need
OpenCV.  `--device` defaults to cuda; the run stops without CUDA unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

JAX_FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "data")


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def make(out: str, device) -> dict:
    """Write every fixture and source into `out`, printing each one's size
    and sha256 and the decode content hashes as the JAX script does.
    Returns {file name: bytes} of the fixtures."""
    from lbdrn_msic_tpu_torch.codec import decode_stream, encode_image
    from lbdrn_msic_tpu_torch.codecs import lpc
    from lbdrn_msic_tpu_torch.codecs.base_layer import decode_base, encode_base
    from lbdrn_msic_tpu_torch.codecs.weights import compress_weights
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.anchors import _jp2_lossy_decode, _jp2_lossy_groups
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    os.makedirs(out, exist_ok=True)
    written = {}

    def write(name: str, data: bytes) -> None:
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        written[name] = data
        print(f"{name}: {len(data)} bytes  sha256 {sha(data)}")

    # one shared source plane for the base-layer codecs; H=70 is not a
    # multiple of the v2 chunk_rows=32, so the remainder chunk is covered
    img = synth_scene(70, 48, channels=3, effective_bits=12, seed=417)
    msb = (img >> 5).astype(np.uint8)
    np.save(os.path.join(out, "golden_formats_msb.npy"), msb)
    print("golden_formats_msb.npy sha256(content)", sha(msb.tobytes()))

    write("golden_llpc_v1.bin", lpc.encode(msb))
    write("golden_llpc_v2.bin", lpc.encode(msb, chunk_rows=32))
    write("golden_lj2c.bin", encode_base(msb.astype(np.uint16), "jp2"))
    write("golden_lj2l.bin", _jp2_lossy_groups(img, quality_percent=80.0))

    # LFPZ: a fixed float vector with signs, an exponent spread, zeros and
    # exact-duplicate neighbours
    rng = np.random.default_rng(417)
    vec = np.concatenate([
        rng.normal(0, 1, 300),
        rng.normal(0, 1e-3, 200),
        np.zeros(8),
        np.repeat(rng.normal(0, 10, 4), 3),
    ]).astype(np.float32)
    np.save(os.path.join(out, "golden_lfpz_src.npy"), vec)
    write("golden_lfpz.bin", compress_weights(vec, precision=16))

    # codec container streams: a v0 reference-layout header with the
    # default jp2 body, and an sr=2 tiled v1 stream whose last tiles take
    # the odd-dimension remainders (91x77; every tile stays at or above
    # OpenJPEG's 32 px minimum)
    src = synth_scene(91, 77, channels=2, effective_bits=12, seed=418)
    np.save(os.path.join(out, "golden_container_src.npy"), src)
    tr = TrainSpec(epochs=2, batch_size=1024)
    v0, _ = encode_image(src, CodecConfig(K=5, train=tr), header_version=0, device=device)
    write("golden_v0_k5.bin", v0)
    sr2, _ = encode_image(src, CodecConfig(K=5, split_ratio=2, train=tr), device=device)
    write("golden_sr2_k5.bin", sr2)

    print("-- decode content hashes --")
    print("llpc_v1 ->", sha(decode_base(lpc.encode(msb), "lpc").tobytes()))
    print("lj2l ->", sha(_jp2_lossy_decode(_jp2_lossy_groups(img, 80.0)).tobytes()))
    print("v0 ->", sha(decode_stream(v0, device=device)[0].tobytes()))
    print("sr2 ->", sha(decode_stream(sr2, device=device)[0].tobytes()))
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, default="out/goldens",
                   help="directory for the fixtures (never tests/data/, the JAX "
                        "suite's committed ones)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args

    device = device_from_args(args)
    if os.path.realpath(args.out) == os.path.realpath(JAX_FIXTURES):
        raise SystemExit(f"error: {args.out} holds the JAX suite's fixtures; "
                         "write the port's elsewhere")
    make(args.out, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
