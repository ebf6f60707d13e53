"""The port's host codecs and decoder against the committed wire-format
fixtures of tests/data/ (the counterpart of tests/test_golden.py).

The fixtures are the JAX suite's and are only read here.  The
deterministic coders (LLPC v1/v2, LFPZ) must re-encode them byte for byte;
every container stream (LJ2C, LJ2L, the v0-header stream, the sr=2 tiled
stream, golden_k5.bin) must decode bit for bit to its source, with the
content hashes tests/test_golden.py holds.  Then the port's make_goldens
writes the sources and the host-coded fixtures byte for byte.
"""

import contextlib
import hashlib
import io
import os

import numpy as np
import pytest

from lbdrn_msic_tpu_torch.codec import decode_stream
from lbdrn_msic_tpu_torch.io.header import decode_header

DATA = os.path.join(os.path.dirname(__file__), "data")
# tests/test_golden.py's content hashes
K5_SHA = "c6333939318b57c0b6c11c7817358c902c34185d5c01c878ea44c66bbe77b81e"
LJ2L_SHA = "e944f90dc536e2e037beccecf7b0eae83782245b666f8819e1f56b0a92388a21"
LFPZ_SHA = "1044c0466f476e8b2ff3f5ea88b3c0a0a73051af587fa53b785c80592f81a0c0"
V0_SHA = "cb579dffceaaffc9100d4d184db365a58a45618aecb6ca553da4fdb87624e525"
SR2_SHA = "93e899c88642349232a02bdff510e33881969d85e7eed17f4fb66cd7c37b8fa7"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Toy-sized tensors gain nothing from intra-op threads; one thread
    keeps these runs from crowding the other test workers' cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def _msb():
    return np.load(os.path.join(DATA, "golden_formats_msb.npy"))


@pytest.mark.parametrize("name,chunk_rows", [("golden_llpc_v1.bin", 0),
                                             ("golden_llpc_v2.bin", 32)], ids=["v1", "v2"])
def test_llpc_encoder_locked(name, chunk_rows):
    from lbdrn_msic_tpu_torch.codecs import lpc

    msb, stream = _msb(), _read(name)
    assert lpc.encode(msb, chunk_rows=chunk_rows) == stream
    np.testing.assert_array_equal(lpc.decode(stream), msb)
    if chunk_rows:
        assert lpc.chunk_info(stream)[:6] == (3, 70, 48, 1, 32, 3)
        np.testing.assert_array_equal(lpc.decode_chunk(stream, 1, 2, 6, 48), msb[1, 64:70])
    else:
        assert lpc.chunk_info(stream) is None


def test_lfpz_encoder_locked():
    from lbdrn_msic_tpu_torch.codecs.weights import compress_weights, decompress_weights

    stream = _read("golden_lfpz.bin")
    vec = decompress_weights(stream)
    assert vec.dtype == np.float32 and vec.shape == (520,) and _sha(vec.tobytes()) == LFPZ_SHA
    src = np.load(os.path.join(DATA, "golden_lfpz_src.npy"))
    assert compress_weights(src, precision=16) == stream


def test_jp2_containers_decode():
    pytest.importorskip("cv2")
    from lbdrn_msic_tpu_torch.codecs.base_layer import decode_base
    from lbdrn_msic_tpu_torch.eval.anchors import _jp2_lossy_decode

    out = decode_base(_read("golden_lj2c.bin"), "jp2")
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, _msb().astype(np.uint16))
    lossy = _jp2_lossy_decode(_read("golden_lj2l.bin"))
    assert lossy.shape == (3, 70, 48) and _sha(lossy.tobytes()) == LJ2L_SHA


@pytest.mark.parametrize("name,sha,src,want", [
    ("golden_k5.bin", K5_SHA, "golden_k5_src.npy", dict(K=5, D=2, base_channel=64,
                                                        num_layers=2)),
    ("golden_v0_k5.bin", V0_SHA, "golden_container_src.npy", dict(version=0, K=5,
                                                                  split_ratio=1)),
    ("golden_sr2_k5.bin", SR2_SHA, "golden_container_src.npy", dict(split_ratio=2,
                                                                    n_tiles=4)),
], ids=["k5", "v0", "sr2"])
def test_codec_streams_decode(name, sha, src, want):
    pytest.importorskip("cv2")  # jp2 base layers
    stream = _read(name)
    h = decode_header(stream)
    assert {k: getattr(h, k) for k in want} == want
    rec, _ = decode_stream(stream, device="cpu")
    source = np.load(os.path.join(DATA, src))
    assert rec.shape == source.shape and rec.dtype == np.uint16
    assert _sha(rec.tobytes()) == sha
    np.testing.assert_array_equal(rec >> 5, source >> 5)


def test_make_goldens_writes_the_fixtures(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    from lbdrn_msic_tpu_torch.scripts import make_goldens

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert make_goldens.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    log = out.getvalue()
    for name in ("golden_formats_msb.npy", "golden_lfpz_src.npy", "golden_container_src.npy",
                 "golden_llpc_v1.bin", "golden_llpc_v2.bin", "golden_lfpz.bin",
                 "golden_lj2c.bin", "golden_lj2l.bin"):
        with open(tmp_path / name, "rb") as f:
            assert f.read() == _read(name), name
    for name in ("golden_v0_k5.bin", "golden_sr2_k5.bin"):  # the port's training
        with open(tmp_path / name, "rb") as f:
            got = f.read()
        assert f"{name}: {len(got)} bytes  sha256 {_sha(got)}" in log
        rec, _ = decode_stream(got, device="cpu")
        src = np.load(os.path.join(DATA, "golden_container_src.npy"))
        np.testing.assert_array_equal(rec >> 5, src >> 5)
    assert f"lj2l -> {LJ2L_SHA}" in log
    # the JAX suite's fixtures are never the output (and nothing is written
    # there should the refusal break)
    monkeypatch.setattr(make_goldens, "make", lambda *a: pytest.fail("wrote tests/data"))
    with pytest.raises(SystemExit, match="JAX suite's fixtures"):
        make_goldens.main(["--out", DATA, "--device", "cpu"])
