"""The port's external-anchor harnesses (BitMore / ABCD divisions, the DLPR
hybrid) and figure helpers against the JAX package's, with mock external
codecs.

Tolerances: none.  Division PNGs, containers, CSVs, PSNRs and composite
arrays must be equal exactly (the same numpy / OpenCV code on the same
seeded inputs).
"""

import os

import numpy as np
import pytest

from lbdrn_msic_tpu.eval import bdr_anchors as jbdr
from lbdrn_msic_tpu.eval import dlpr_anchor as jdlpr
from lbdrn_msic_tpu_torch.eval import bdr_anchors, dlpr_anchor
from lbdrn_msic_tpu_torch.utils.synth import synth_scene


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _mock_model(cv2, div_dir, in_bits):
    """An external BDR model stand-in: each div's output keeps its top
    `in_bits` bits and fills the rest with their midpoint."""
    low = 16 - in_bits
    for name in sorted(os.listdir(div_dir)):
        if name.endswith(".png") and not name.endswith("_output.png"):
            tile = cv2.imread(os.path.join(div_dir, name), cv2.IMREAD_UNCHANGED)
            out = ((tile >> low) << low) | ((1 << low) >> 1)
            cv2.imwrite(os.path.join(div_dir, name[:-4] + "_output.png"), out.astype(np.uint16))


@pytest.mark.parametrize("with_zeros", [True, False])
def test_bdr_divisions_equal_jax(tmp_path, with_zeros):
    """generate_divs writes the same PNGs; assemble_and_psnr and the whole
    evaluate_bdr_anchor loop give JAX's PSNRs and grid CSV."""
    cv2 = pytest.importorskip("cv2")
    img = synth_scene(50, 45, channels=7, effective_bits=12, seed=41)
    port_paths = bdr_anchors.generate_divs(img, str(tmp_path / "p"), "s", 3, 2, with_zeros)
    jax_paths = jbdr.generate_divs(img, str(tmp_path / "j"), "s", 3, 2, with_zeros)
    assert [os.path.basename(p) for p in port_paths] == [os.path.basename(p) for p in jax_paths]
    assert len(port_paths) == 3 * 2 * 2  # 7 bands: two triples, the seventh masked
    for p, j in zip(port_paths, jax_paths):
        assert _read(p) == _read(j)
    _mock_model(cv2, str(tmp_path / "p"), 12)
    got = bdr_anchors.assemble_and_psnr(img, str(tmp_path / "p"), "s", 12, 3, 2, with_zeros)
    assert got == jbdr.assemble_and_psnr(img, str(tmp_path / "p"), "s", 12, 3, 2, with_zeros)
    assert np.isfinite(got).all()

    images = {"a": img, "b": synth_scene(40, 40, channels=3, effective_bits=12, seed=42)}
    out = {}
    for name, mod in (("port", bdr_anchors), ("jax", jbdr)):
        out[name] = mod.evaluate_bdr_anchor(
            images, [10, 12], str(tmp_path / f"{name}.csv"),
            lambda d, b: _mock_model(cv2, d, b), str(tmp_path / f"work_{name}"),
            with_zeros=with_zeros)
    assert _read(out["port"]) == _read(out["jax"])
    assert _read(out["port"]).decode().splitlines()[0] == "in_bits,a,b"


def test_bdr_commands_and_gates(tmp_path, monkeypatch):
    rows = {"a": {8: 50.0, 10: 60.0}, "b": {8: 51.0}}
    got = bdr_anchors.psnr_grid_to_csv(rows, str(tmp_path / "p.csv"), [8, 10])
    ref = jbdr.psnr_grid_to_csv(rows, str(tmp_path / "j.csv"), [8, 10])
    assert _read(got) == _read(ref)
    for args in (("set5", 8), ("set5", 10, 16, "py")):
        assert bdr_anchors.bitmore_command(*args) == jbdr.bitmore_command(*args)
    for model in ("edsr", "swin"):
        assert bdr_anchors.abcd_command("d", "s", 8, model=model, python="py") == \
            jbdr.abcd_command("d", "s", 8, model=model, python="py")
    for mod in (bdr_anchors, jbdr):
        with pytest.raises(ValueError, match="unknown ABCD model"):
            mod.abcd_command("d", "s", 8, model="vit")
        with pytest.raises(RuntimeError, match="external anchor repo"):
            mod.run_external_model(str(tmp_path / "nope"), ["true"])
    monkeypatch.setenv("BITMORE_REPO", str(tmp_path))
    assert bdr_anchors.external_repo_dir("BITMORE_REPO") is None
    (tmp_path / "test.py").write_text("")
    assert bdr_anchors.external_repo_dir("BITMORE_REPO") == jbdr.external_repo_dir(
        "BITMORE_REPO") == str(tmp_path)


def _quantizer(tau):
    """A mock learned codec over (3, h, w) blocks: a step-(2 tau + 1)
    quantizer, lossless at tau = 0."""
    q = 2 * tau + 1

    def enc(block):
        return np.asarray(block.shape, np.uint16).tobytes() + (block // q).astype(np.uint16).tobytes()

    def dec(data):
        shape = tuple(np.frombuffer(data[:6], np.uint16))
        arr = np.frombuffer(data[6:], np.uint16).reshape(shape)
        return np.minimum(arr.astype(np.uint32) * q + tau, 65535).astype(np.uint16)

    return enc, dec


def _extra_enc(bands):
    return np.asarray(bands.shape, np.uint16).tobytes() + bands.tobytes()


def _extra_dec(data):
    shape = tuple(np.frombuffer(data[:6], np.uint16))
    return np.frombuffer(data[6:], np.uint16).reshape(shape)


def test_dlpr_hybrid_equal_jax(tmp_path, monkeypatch):
    """The hybrid container (blocks past BLOCK included), its decode, the
    RD sweep CSV and results_to_csv equal JAX's; the external codec is
    gated the same way."""
    img = synth_scene(70, 90, channels=5, effective_bits=12, seed=42)
    for mod in (dlpr_anchor, jdlpr):
        monkeypatch.setattr(mod, "BLOCK", 32)  # several blocks on a small scene
    for tau in (0, 2):
        enc, dec = _quantizer(tau)
        stream = dlpr_anchor.encode_hybrid(img, enc, _extra_enc)
        assert stream == jdlpr.encode_hybrid(img, enc, _extra_enc)
        rec = dlpr_anchor.decode_hybrid(stream, dec, _extra_dec)
        assert np.array_equal(rec, jdlpr.decode_hybrid(stream, dec, _extra_dec))
        if tau == 0:
            assert np.array_equal(rec, img)
    images = {"s": img, "t": synth_scene(40, 36, channels=4, effective_bits=10, seed=43)}
    got = dlpr_anchor.sweep_rd(images, [0, 2], _quantizer, _extra_enc, _extra_dec,
                               str(tmp_path / "p.csv"))
    ref = jdlpr.sweep_rd(images, [0, 2], _quantizer, _extra_enc, _extra_dec,
                         str(tmp_path / "j.csv"))
    assert _read(got) == _read(ref)
    args = (["a", "b"], np.asarray([[50.0, 45.0], [48.0, 44.0]]),
            np.asarray([[0.5, 0.3], [0.6, 0.35]]), [1000, 2000])
    assert _read(dlpr_anchor.results_to_csv(*args, str(tmp_path / "rp.csv"))) == \
        _read(jdlpr.results_to_csv(*args, str(tmp_path / "rj.csv")))
    monkeypatch.setenv("DLPR_REPO", str(tmp_path / "absent"))
    assert dlpr_anchor.dlpr_repo_dir() == jdlpr.dlpr_repo_dir()
    assert not dlpr_anchor.external_dlpr_available() and not jdlpr.external_dlpr_available()
    with pytest.raises(RuntimeError, match="external DLPR repo not found"):
        dlpr_anchor.external_dl_codec(1)


def test_visualize_equal_jax(tmp_path):
    """composite arrays equal JAX's; each figure helper writes its PNG."""
    pytest.importorskip("matplotlib")
    from lbdrn_msic_tpu.utils import visualize as jvis
    from lbdrn_msic_tpu_torch.utils import visualize

    img = synth_scene(64, 48, channels=4, effective_bits=12, seed=44)
    for bands in ((2, 1, 0), (3, 2, 1), (0, 0, 0)):
        assert np.array_equal(visualize.composite(img, bands), jvis.composite(img, bands))
    rec = ((img >> 3) << 3).astype(np.uint16)
    made = [visualize.save_composite(img, str(tmp_path / "rgb.png")),
            visualize.msb_lsb_figure(img, 5, str(tmp_path / "msblsb.png"), band=1),
            visualize.error_map_grid(img, {"baseline": rec, "perfect": img},
                                     str(tmp_path / "err.png")),
            visualize.error_map_grid(img, {"baseline": rec}, str(tmp_path / "err1.png"),
                                     band=2, vmax=8.0)]
    for p in made:
        assert os.path.getsize(p) > 500
