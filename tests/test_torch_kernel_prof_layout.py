"""K5's layout mirrors (lbdrn_msic_tpu_torch/profiling/kernel_prof.py): the
shared-memory carve-up of each variant's first pass, the wgmma operand
layout, the TF32 split behind the 3xTF32 planes, the rows a CTA and the
shapes a launch takes.  Pure Python and fast: csrc/kernel_prof.cu builds and
runs only on the card, where chip_smoke.py holds every variant against its
plain version; these tests hold the host's copies of its layout rules.
"""

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu_torch.ops import fused_step as fs
from lbdrn_msic_tpu_torch.profiling import kernel_prof as kp

DIMS = [kp.F, kp.BC, kp.BC, kp.C]
SMEM_OPTIN_H100 = 232448  # the dynamic shared memory a block may opt into on an H100


@pytest.mark.parametrize("variant", list(kp.VARIANTS))
def test_variant_fits_and_is_taken_at_its_rows(variant):
    """Every variant's first pass fits an H100's opt-in shared memory at its
    rows a CTA, and the launch checks take the bench shape."""
    rows = kp.cta_rows(variant)
    assert kp.smem_bytes(DIMS, rows, variant) <= SMEM_OPTIN_H100
    if variant in kp.KERNEL_VARIANTS:
        kp.check_launch_shape(variant, DIMS, kp.B, rows)


def test_cta_rows():
    """K1's 64 rows a CTA for every variant but tile2048, a quarter of them
    (its JAX tile is a quarter of the batch); 64 is the wgmma M tile."""
    rows = {v: kp.cta_rows(v) for v in kp.VARIANTS}
    assert rows == {**dict.fromkeys(kp.VARIANTS, fs.ROWS), "tile2048": fs.ROWS // 4}
    assert rows["prec_default"] == rows["prec_high"] == kp.TC_ROWS == 64


def test_ffma_carve_up_is_k1s():
    """The FFMA variants carve shared memory up as K1: full_t and fast_full
    to the byte; full_dg without W^T and with layer 1..'s W at row_stride
    rows; fwd_notrans without W^T and without the cos caches."""
    for rows in (64, 16):
        k1 = fs.smem_bytes(DIMS, rows)
        wt = 4 * sum(DIMS[l + 1] * fs.row_stride(DIMS[l]) for l in (1, 2))
        pad = 4 * sum(DIMS[l] * fs.row_stride(DIMS[l + 1]) - fs._r4(DIMS[l] * DIMS[l + 1])
                      for l in (1, 2))
        cos = 4 * rows * fs.row_stride(DIMS[1]) * 2
        assert kp.smem_bytes(DIMS, rows, "full_t") == k1
        assert kp.smem_bytes(DIMS, rows, "fast_full") == k1
        assert kp.smem_bytes(DIMS, rows, "full_dg") == k1 - wt + pad
        assert kp.smem_bytes(DIMS, rows, "fwd_notrans") == k1 - wt - cos
    assert kp.smem_bytes(DIMS, 64, "prod_f32") == fs.smem_bytes(DIMS, 64)


@pytest.mark.parametrize("planes", [1, 2])
def test_tc_layout(planes):
    """The wgmma pass 1's regions follow each other, each 128-byte aligned;
    x and the cos / raw gradient buffers lie at K1's row strides; region
    "a" holds W0^T's planes and, later, h2's planes, cos1 and the head's g
    as (out, row) and (row, out); the totals are those of the source's
    header (224,256 B at 3xTF32, 161,792 B at TF32)."""
    lay = kp.tc_layout(planes)
    off = 0
    for name, (o, n) in lay.items():
        assert o == off and o % 32 == 0 and n % 32 == 0, name
        off += n
    R, (F, H, _, C) = kp.TC_ROWS, kp.TC_WIDTHS
    assert lay["x"][1] == R * fs.row_stride(F)
    assert lay["cos0"][1] == lay["g_raw_a"][1] == lay["g_raw_b"][1] == R * fs.row_stride(H)
    assert lay["y"][1] == R * C and lay["mask"][1] == R and lay["red"][1] == fs.THREADS
    assert lay["a"][1] == max(planes * H * F, planes * H * R + R * fs.row_stride(H)
                              + 2 * planes * 8 * R)
    assert lay["w1t"][1] == planes * H * H and lay["w2t"][1] == planes * 8 * H
    assert lay["h1"][1] == planes * H * R
    variant = "prec_high" if planes == 2 else "prec_default"
    assert kp.smem_bytes(DIMS, R, variant) == 4 * off == {1: 161792, 2: 224256}[planes]


@pytest.mark.parametrize("n_rows, depth", [(64, 128), (64, 64), (8, 64), (64, 8)])
def test_core_offset_is_wgmmas_k_major_layout(n_rows, depth):
    """`core_offset` places an N x K operand bijectively; each 8 x 4 core
    matrix fills 32 consecutive floats (8 rows of 16 bytes); core matrices
    adjacent in k lie 128 bytes apart (the leading byte offset) and 8-row
    groups 32 K bytes apart (the stride byte offset); one k step of 8 is 64
    floats on."""
    off = np.array([[kp.core_offset(n, k, depth) for k in range(depth)] for n in range(n_rows)])
    assert sorted(off.ravel().tolist()) == list(range(n_rows * depth))
    for n0 in range(0, n_rows, 8):
        for k0 in range(0, depth, 4):
            block = off[n0:n0 + 8, k0:k0 + 4]
            assert block.min() + 31 == block.max()
            np.testing.assert_array_equal(block - block.min(),
                                          np.arange(32).reshape(8, 4))
    assert kp.core_offset(0, 4, depth) - kp.core_offset(0, 0, depth) == 128 // 4
    if n_rows > 8:
        assert kp.core_offset(8, 0, depth) - kp.core_offset(0, 0, depth) == 32 * depth // 4
    if depth > 8:
        assert kp.core_offset(3, 9, depth) - kp.core_offset(3, 1, depth) == 64


def test_tf32_split():
    """3xTF32's parts: big is tf32_round(a), both parts carry 10 mantissa
    bits (low 13 bits zero), and big + small gives a back within 2^-21
    relative."""
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000),
                        [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.0, 1e-30]]).astype(np.float32)
    t = torch.from_numpy(a)
    big, small = kp.tf32_split(t)
    assert torch.equal(big, kp.tf32_round(t))
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((big.double() + small.double() - t.double()).abs() / t.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


def test_launch_shape_checks():
    """The wgmma variants take the bench widths at 64 rows only; every
    variant needs widths and rows that are multiples of 4 and whole CTA
    tiles; the routes are the products'."""
    for v in ("prec_default", "prec_high"):
        for dims, rows in (([kp.F, 128, 128, kp.C], 64), (DIMS, 32), ([kp.F, kp.BC, kp.C], 64)):
            with pytest.raises(ValueError, match="wgmma"):
                kp.check_launch_shape(v, dims, kp.B, rows)
    kp.check_launch_shape("full_t", [256, 128, 128, 8], 4096, 32)
    for dims, batch, rows in (([kp.F, 62, kp.BC, kp.C], kp.B, 64), (DIMS, kp.B, 6),
                              (DIMS, kp.B + 16, 64)):
        with pytest.raises(ValueError, match="multiples of 4"):
            kp.check_launch_shape("full_dg", dims, batch, rows)
    assert {v: kp.route(v) for v in kp.VARIANTS} == {
        **dict.fromkeys(kp.VARIANTS, "ffma"), "prec_default": "wgmma_tf32",
        "prec_high": "wgmma_3xtf32"}
