"""The port's headline benchmark (`lbdrn_msic_tpu_torch.scripts.bench`)
against bench.py: its JSON line's keys, its workload at a toy size on the
CPU, its parity check (which must fail for a broken step), the exact step
chain it holds K1 to against the JAX package's, and its refusal to run
without CUDA unless asked.

Tolerances: the parity check's own (bench.py's: losses rtol 1e-4, atol
1e-6; parameters within 3 * n_steps * lr); the port's exact chain against
the JAX exact chain at loss rtol 1e-5 and the parameter tier of
tests/test_torch_fused_step.py::test_chain_tracks_exact_oracle (2e-3 a
step).  The JAX package is imported inside the test that needs it, so the
`cuda` test also runs where only the port is installed.
"""

import ast
import os

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu_torch.ops import fused_step as fs
from lbdrn_msic_tpu_torch.scripts import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_bench_keys() -> set:
    """The keys of the dict bench.py's main() passes to json.dumps."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no json.dumps dict")


def _steps_per_fit(size: int, epochs: int) -> int:
    """epochs x batches an epoch of 8-pixel granules at bs 8192."""
    return epochs * -(-(-(-size * size // 8)) // (8192 // 8))


def test_run_cpu_toy_line():
    """bench.py's workload at 64^2, one epoch, one run of each: the line
    holds bench.py's keys and `device`, parity holds, the rates are
    positive, the device is the CPU with no power limit; the exact-step
    PSNR lies within 0.1 dB of the fused one (run asserts it too), and the
    record gives the exact-step encode's bpsp and seconds."""
    rec = bench.run("cpu", size=64, epochs=1, encode_repeats=1, repeats=1, base_codec="lpc")
    line = rec["line"]
    keys = _jax_bench_keys()
    assert len(keys) == 14
    assert set(line) == keys | {"device"}
    assert line["fused_parity"] is True
    assert line["metric"] == "encode_throughput_single_image"
    for k in ("value", "median_mpx_s", "sweep_mpx_s_per_point", "dataset_mpx_s_per_point",
              "decode_mpx_s", "decode_median_mpx_s"):
        assert line[k] > 0, k
    assert line["vs_baseline"] == round(line["value"] / bench.REF_BASELINE_MPX_S, 2)
    assert line["device"] == {"name": "cpu", "count": 1, "power_limit": None}
    assert line["psnr_db"] == round(rec["psnr_db"], 2) and np.isfinite(rec["psnr_db"])
    assert abs(rec["psnr_db"] - rec["psnr_exact_step_db"]) < 0.1
    assert rec["bpsp_exact_step"] > 0 and rec["exact_step_encode_s"] > 0
    assert line["bpsp"] > 0
    assert len(rec["encode_s"]) == len(rec["sweep_s_per_point"]) == 1


def test_run_msbs_exact(monkeypatch):
    """The bench decodes its stream with the MSBs exact: a decode whose
    MSBs are corrupted stops the run."""
    from lbdrn_msic_tpu_torch import codec

    real = codec.decode_stream
    calls = []

    def corrupt(data, device=None, mesh=None):
        rec, st = real(data, device=device, mesh=mesh)
        calls.append(1)
        if len(calls) > 1:  # the timed decodes, after the warm-up's
            rec = rec ^ np.uint16(1 << 6)
        return rec, st

    monkeypatch.setattr(codec, "decode_stream", corrupt)
    with pytest.raises(AssertionError, match="MSB path corrupted"):
        bench.run("cpu", size=32, epochs=1, encode_repeats=1, repeats=1, base_codec="lpc")


def _doubled(p, m, v, *a, **k):
    """The fused step with its Adam update applied twice."""
    before = [t.clone() for t in p.leaves()]
    out = fs.fused_train_step(p, m, v, *a, **k)
    for t, b in zip(p.leaves(), before):
        t.add_(t - b)
    return out


def _skipped(p, m, v, *a, **k):
    """The fused step's loss, the parameters and Adam state unchanged."""
    *_, loss = fs.fused_train_step(p.map(torch.clone), m.map(torch.clone), v.map(torch.clone),
                                   *a, **k)
    return p, m, v, loss


@pytest.mark.parametrize("broken", [None, _doubled, _skipped], ids=["fused", "doubled", "skipped"])
def test_fused_parity_check(monkeypatch, broken):
    """True for the step itself (its plain version on the CPU), false for a
    step whose Adam update is doubled or skipped: each chain steps its own
    clone of one state, so a broken chain cannot pass as the other."""
    if broken is not None:
        monkeypatch.setattr(bench, "fused_train_step", broken)
    assert bench.fused_parity_check("cpu") is (broken is None)


def test_reference_chain_matches_jax():
    """The parity check's exact chain (`reference_train_step`, five steps)
    against the JAX package's exact chain from the same numpy parameters
    and batch."""
    import jax
    import jax.numpy as jnp

    from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
    from lbdrn_msic_tpu.models.siren import SirenParams as JParams
    from lbdrn_msic_tpu.ops import fused_step as jfs

    n_steps, lr = 5, 1e-3
    params, x, y, mask = bench.parity_inputs("cpu")
    port, losses = bench.step_chain(fs.reference_train_step, params, x, y, mask, n_steps, lr)

    jp = JParams([jnp.asarray(w.numpy()) for w in params.weights],
                 [jnp.asarray(b.numpy()) for b in params.biases])
    jm = jax.tree.map(jnp.zeros_like, jp)
    state = (jp, jm, jm)
    jx, jy, jmask = (jnp.asarray(t.numpy()) for t in (x, y, mask))
    jlosses = []
    for t in range(1, n_steps + 1):
        *state, jl = jfs.reference_train_step(*state, jx, jy, jmask, np.float32(lr),
                                              np.int32(t), JModelSpec(), bench.PARITY_C)
        jlosses.append(float(jl))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    jleaves = list(state[0].weights) + list(state[0].biases)
    for a, b in zip(port.leaves(), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3 * n_steps)


def test_main_without_cuda_stops():
    """With no card, the bench stops with resolve_device's error unless
    given --device cpu (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("checks the run without CUDA; a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        bench.main([])


@pytest.mark.cuda
def test_run_on_card_counts_launches():
    """On the card at 64^2, one epoch: K1 launches 5 (parity) + one a step
    of the warm-up and timed encodes, K2 one a step of the warm-up and
    timed sweeps and of each dataset run (one chunk of E = 8); parity
    true."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    S = _steps_per_fit(64, 1)
    fs.fused_train_step.launches = fs.fused_expert_step.launches = 0
    rec = bench.run("cuda", size=64, epochs=1, encode_repeats=1, repeats=1, base_codec="lpc")
    assert fs.fused_train_step.launches == 5 + 2 * S
    assert fs.fused_expert_step.launches == 2 * S + S
    assert rec["line"]["fused_parity"] is True
    assert rec["line"]["device"]["count"] >= 1
