"""The port's dataset encode vs the JAX package's: cross-image experts
(`fit_rate_experts(img_of=)`), per-expert bucket masks (`hws=`) and
coordinate features in the expert loop; K2's function at the coordinate
width with per-expert masks; `encode_dataset` (grouping, fallbacks, job
order, chunking, the seed contract, bucketed mixed shapes) and its streams
across the packages.

Tolerances:
- a whole expert fit vs the JAX fit: epoch losses and best MSE rtol 1e-5,
  best epoch exact, per expert (tests/test_torch_experts.py::
  test_fit_rate_experts_matches_jax);
- one expert step vs the JAX kernel (interpret mode): K1's tiers per
  expert (tests/test_torch_experts.py::_assert_expert_step_close);
- within the port, expert e is `fit` bit for bit, and every dataset stream
  is `encode_image`'s byte for byte;
- cross-decoded streams: MSBs exact, residuals within +-1 on at most 0.1 %
  of the samples.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbdrn_msic_tpu import codec as jcodec
from lbdrn_msic_tpu.core.config import CodecConfig as JCodecConfig
from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.core.config import TrainSpec as JTrainSpec
from lbdrn_msic_tpu.features import engine as jeng
from lbdrn_msic_tpu.models.siren import SirenParams as JParams
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu.models.siren import pad_dim
from lbdrn_msic_tpu.ops import fused_step as jfs
from lbdrn_msic_tpu.train import loop as jloop
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy, unstack_params
from lbdrn_msic_tpu_torch.ops import fused_step as fs
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

C = 2
FAST = dict(epochs=2, batch_size=1024)


def _jax_draws(key, n_g, dim_in, epochs):
    """The JAX fit_rate_experts' own draws (train/loop.py:722-724, 996-997)."""
    key, ik = jax.random.split(key)
    jp = jinit(ik, dim_in, C, JModelSpec(), pad_input_to=pad_dim(dim_in))
    perms = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, n_g)))
    return params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases]), perms


# (kind, staging, use_fused): three images across four experts; two shapes
# padded to one 48x40 grid with per-expert masks; coordinates without and
# with the embedding (F_pad 128 and 256)
FIT_CASES = [("img_of", "full", False), ("img_of", "full", True), ("img_of", "banded", False),
             ("hws", "full", False), ("hws", "banded", True), ("hws", "banded", False),
             ("coords", "full", False), ("coords_emb", "full", False),
             ("coords_emb", "banded", True)]


@pytest.mark.parametrize("kind,staging,use_fused", FIT_CASES)
def test_fit_rate_experts_matches_jax_and_fit(kind, staging, use_fused):
    """48x40x2, bs 256, g=8, e=3: the port's expert fit vs the JAX one (its
    fused step in interpret mode, or the exact step), the JAX init and
    permutations injected; and, within the port, each expert bit for bit
    `fit` on its image at its K (with `hw=` its real shape)."""
    H, W, e = 48, 40, 3
    g = 8
    Ks = (3, 5, 4, 6)
    if kind == "hws":
        shapes = [(41, 35), (48, 40)]  # 35 % 8 != 0: granules straddle the real edge
        img_of = (0, 1, 0, 1)
    else:
        shapes = [(H, W)] * 3
        img_of = (0, 1, 2, 1) if kind == "img_of" else (0, 0, 1, 1)
    imgs = [codec._pad_to_bucket(synth_scene(h, w, channels=C, effective_bits=12, seed=30 + i),
                                 2, H, W) for i, (h, w) in enumerate(shapes)]
    jspec = JFeatureSpec(use_coords=kind.startswith("coords"), embedding=kind == "coords_emb")
    spec = FeatureSpec(use_coords=jspec.use_coords, embedding=jspec.embedding)
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=g)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=g)
    maxes = [int(im.max()) for im in imgs]
    dt = (lambda mx: jeng.row_taps_dtype(mx)) if staging == "banded" else (
        lambda mx: jeng.tap_matrix_dtype(mx, True))
    jdts = tuple(jnp.dtype(dt(maxes[i] >> K)).name for i, K in zip(img_of, Ks))
    hws = [shapes[i] for i in img_of] if kind == "hws" else None
    key = jax.random.PRNGKey(11)

    def run_jax():
        return jloop.fit_rate_experts(
            tuple(jnp.asarray(im) for im in imgs), Ks, key, jspec, JModelSpec(), jt, H, W, C,
            jdts, use_fused=use_fused, staging=staging, img_of=img_of,
            hws=None if hws is None else jnp.asarray(hws, jnp.int32))

    if use_fused:
        with pltpu.force_tpu_interpret_mode():
            ref = run_jax()
    else:
        ref = run_jax()
    geo = loop._batch_geometry(t, H, W, staging)
    init, perms = _jax_draws(key, geo.n_g, spec.feature_dim(C), e)
    got = loop.fit_rate_experts([torch.from_numpy(im.astype(np.int32)) for im in imgs], Ks, None,
                                spec, ModelSpec(), t, H, W, C, use_fused=use_fused,
                                staging=staging, img_of=img_of, hws=hws, init=init, perms=perms,
                                device="cpu")
    assert got.step_losses.shape == ref.step_losses.shape
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-5)
    assert got.best_epoch == [int(v) for v in np.asarray(ref.best_epoch)]
    np.testing.assert_allclose(got.best_mse, np.asarray(ref.best_mse), rtol=1e-5)

    for x, (i, K) in enumerate(zip(img_of, Ks)):
        msb, lsb = engine.split_msb_lsb(torch.from_numpy(imgs[i].astype(np.int32)), K)
        plane, scale = engine.pad_plane(msb, 2)
        hw = None if shapes[i] == (H, W) else shapes[i]
        one = loop.fit(plane, scale, lsb, float(np.float32(engine.lsb_scale(K))), None, spec,
                       ModelSpec(), t, H, W, C, staging=staging, use_fused=use_fused, init=init,
                       perms=perms, hw=hw, device="cpu")
        assert torch.equal(got.step_losses[x], one.step_losses), (x, K)
        assert got.best_mse[x] == one.best_mse and got.best_epoch[x] == one.best_epoch
        for a, b in zip(unstack_params(got.params, x).leaves(), one.params.leaves()):
            assert torch.equal(a, b), (x, K)


def _expert_inputs(E, B, dim_in, seed):
    """E differently initialised networks at `dim_in` (padded), one batch
    each, and (E, B) masks of densities 1.0, 0.7, 0.3, 0.0."""
    jps = [jinit(jax.random.PRNGKey(seed + e), dim_in, 4, JModelSpec(),
                 pad_input_to=pad_dim(dim_in)) for e in range(E)]
    ws = [np.stack([np.asarray(p.weights[l]) for p in jps]) for l in range(3)]
    bs = [np.stack([np.asarray(p.biases[l]) for p in jps]) for l in range(3)]
    rng = np.random.default_rng(seed + 1)
    x = np.zeros((E, B, pad_dim(dim_in)), np.float32)
    x[..., :dim_in] = rng.uniform(-1, 1, (E, B, dim_in))
    y = (1 / (1 + np.exp(-rng.standard_normal((E, B, 4))))).astype(np.float32)
    mask = np.stack([(rng.random(B) < d) for d in (1.0, 0.7, 0.3, 0.0)]).astype(np.float32)
    return ws, bs, x, y, mask


def _leaves(p):
    if isinstance(p, JParams):
        return [np.asarray(a) for a in list(p.weights) + list(p.biases)]
    return [a.cpu().numpy() for a in p.leaves()]


def test_expert_step_f256_per_expert_masks_matches_jax_kernel():
    """K2's function (`fused_expert_step` on CPU tensors) at the coordinate
    width (F = 150, F_pad 256) with (E, B) masks vs the JAX kernel in
    interpret mode: K1's one-step tiers per expert; the expert that saw
    no pixel keeps its params."""
    ws, bs, x, y, mask = _expert_inputs(4, 1000, 150, seed=5)
    jp = JParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jz = jax.tree.map(jnp.zeros_like, jp)
    with pltpu.force_tpu_interpret_mode():
        jout = jfs.fused_expert_step(jp, jz, jz, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(mask), jnp.float32(1e-3), jnp.int32(1),
                                     JModelSpec(), 4, tile=1000)
    p = params_from_numpy(ws, bs)
    pm, pv = p.map(torch.zeros_like), p.map(torch.zeros_like)
    *_, loss = fs.fused_expert_step(p, pm, pv, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(mask), 1e-3, 1, ModelSpec(), 4)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jout[3]), rtol=1e-5)
    for a, b in zip(_leaves(pm) + _leaves(pv), _leaves(jout[1]) + _leaves(jout[2])):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-10)
    for a, b, m in zip(_leaves(p), _leaves(jout[0]), _leaves(jout[1])):
        well = np.abs(m) / (1 - fs.ADAM_B1) >= 1e-6
        np.testing.assert_allclose(a[well], b[well], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    assert float(loss[3]) == 0.0
    for a, w in zip(_leaves(unstack_params(p, 3)), [w[3] for w in ws + bs]):
        np.testing.assert_array_equal(a, w)


@pytest.mark.cuda
def test_k2_f256_per_expert_masks_is_k1_on_card():
    """On the card, K2 at F_pad 256 with (E, B) masks is K1 on each
    expert's slices bit for bit (chip_smoke.py's kernels_experts phase runs
    the same check at the sweep's E and B)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    ws, bs, x, y, mask = _expert_inputs(4, 8192 - 37, 150, seed=6)
    k2 = params_from_numpy(ws, bs, dev)
    st2 = (k2, k2.map(torch.zeros_like), k2.map(torch.zeros_like))
    xt, yt, mt = (torch.from_numpy(a).to(dev) for a in (x, y, mask))
    *_, l2 = fs.fused_expert_step(*st2, xt, yt, mt, 1e-3, 1, ModelSpec(), 4)
    for e in range(4):
        k1 = params_from_numpy([w[e] for w in ws], [b[e] for b in bs], dev)
        st1 = (k1, k1.map(torch.zeros_like), k1.map(torch.zeros_like))
        *_, l1 = fs.fused_train_step(*st1, xt[e], yt[e], mt[e], 1e-3, 1, ModelSpec(), 4)
        torch.cuda.synchronize()
        assert torch.equal(l2[e], l1)
        for a_st, b_st in zip(st2, st1):
            for a, b in zip(unstack_params(a_st, e).leaves(), b_st.leaves()):
                assert torch.equal(a, b)


def _scenes(seeds, h=48, w=40):
    return [synth_scene(h, w, channels=C, effective_bits=12, seed=s) for s in seeds]


def _cfg(K, **kw):
    return CodecConfig(K=K, base_codec="lpc", train=TrainSpec(**FAST), **kw)


def _jcfg(K, **kw):
    return JCodecConfig(K=K, base_codec="lpc", train=JTrainSpec(**FAST), **kw)


def _record(monkeypatch, module, name, calls, fake=None):
    """Wrap module.name so each call's (args, kwargs) is recorded; `fake`
    replaces the call's result."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append((a, k))
        return fake(*a, **k) if fake is not None else real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def _job_ids(jobs, sub):
    """Indices in `jobs` of the (image, cfg) pairs of `sub`, by identity."""
    return [next(j for j, (im, c) in enumerate(jobs) if im is s_im and c.K == s_c.K
                 and c.model == s_c.model) for s_im, s_c in sub]


def test_dataset_groups_fallbacks_and_order(monkeypatch):
    """Mixed shapes and configs (tests/test_e2e.py:415): the port groups the
    jobs as the JAX package does (the same groups and partner-less jobs, in
    the same order), returns them in job order, and every stream is the
    port's `encode_image` stream byte for byte."""
    a, b = _scenes((70, 71))
    odd = synth_scene(32, 32, channels=C, effective_bits=12, seed=72)
    small = dict(model=ModelSpec(base_channel=32, num_layers=1))
    jobs = [(a, _cfg(4)), (odd, _cfg(4)), (b, _cfg(4)), (a, _cfg(5, **small)), (b, _cfg(3)),
            (a, _cfg(3))]
    jjobs = [(im, _jcfg(c.K, **({"model": JModelSpec(32, 1)} if c.model != ModelSpec() else {})))
             for im, c in jobs]

    jgroups, jsingles = [], []
    _record(monkeypatch, jcodec, "_encode_job_group", jgroups,
            lambda gj, *a, **k: [(b"", None)] * len(gj))
    _record(monkeypatch, jcodec, "encode_pipelined", jsingles,
            lambda sj, *a, **k: [(b"", None)] * len(sj))
    jcodec.encode_dataset(jjobs)
    groups, singles = [], []
    _record(monkeypatch, codec, "_encode_job_group", groups)
    _record(monkeypatch, codec, "encode_pipelined", singles)
    res = codec.encode_dataset(jobs, device="cpu")

    assert [_job_ids(jjobs, c[0][0]) for c in jgroups] == [_job_ids(jobs, c[0][0]) for c in groups]
    assert [_job_ids(jjobs, c[0][0]) for c in jsingles] == \
        [_job_ids(jobs, c[0][0]) for c in singles[-1:]]
    assert [_job_ids(jobs, c[0][0]) for c in groups] == [[0, 2, 4, 5]]
    for (im, cfg), (stream, stats) in zip(jobs, res):
        solo, solo_stats = codec.encode_image(im, cfg, device="cpu")
        assert stream == solo, cfg.K
        assert stats.n_subpixels == im.size
        assert stats.tiles[0].best_mse == solo_stats.tiles[0].best_mse


def test_dataset_chunking_matches_jax_plan(monkeypatch):
    """A budget that holds the group in one chunk, where neither of the
    JAX package's TPU fences fires: the chunk plan (each chunk's images and
    Ks) is the JAX package's.  A budget that cannot hold the group
    (tests/test_e2e.py:494): the port's own plan, written out here, keeps
    the budget whole (the JAX package halves it) and packs each image's two
    experts in a chunk within it; the streams are the unchunked ones byte
    for byte."""
    imgs = _scenes((80, 81))
    jobs = [(im, _cfg(K)) for im in imgs for K in (3, 4)]
    ijobs = [(i, c) for i in range(2) for c in (_cfg(3), _cfg(4))]
    whole = codec.encode_dataset(jobs, device="cpu")
    one_expert_full = 48 * 40 * C * 25 * 2  # int16 taps
    fixed = 4 * 48 * 40 * C  # one image's uint16 image + label store
    one_chunk = 4 * one_expert_full + 2 * fixed
    for mod in (codec, jcodec):
        monkeypatch.setattr(mod, "STAGE_BUDGET_BYTES", one_chunk)

    jchunks = []

    def fake_fit(img, Ks, key, fspec, mspec, tspec, H, W, C_, *a, img_of=None, **k):
        jchunks.append((tuple(Ks), tuple(img_of), len(img)))
        p = jinit(jax.random.PRNGKey(0), fspec.feature_dim(C_), C_, mspec, pad_input_to=128)
        E = len(Ks)
        return types.SimpleNamespace(
            params=jax.tree.map(lambda x: jnp.broadcast_to(x, (E, *x.shape)), p),
            best_mse=np.zeros(E, np.float32), best_epoch=np.ones(E, np.int32))

    monkeypatch.setattr(jloop, "fit_rate_experts", fake_fit)
    jcodec.encode_dataset([(im, _jcfg(c.K)) for im, c in jobs])
    chunks = []
    _record(monkeypatch, codec, "fit_rate_experts", chunks)
    one = codec.encode_dataset(jobs, device="cpu")
    got = [(tuple(a[1]), tuple(k["img_of"]), len(a[0])) for a, k in chunks]
    assert got == jchunks == [((3, 4, 3, 4), (0, 0, 1, 1), 2)], (got, jchunks)
    assert codec._plan_group(imgs, ijobs, False, 16).budget == one_chunk

    # one byte short of the whole group: two chunks, one image each
    budget = one_chunk - 1
    monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", budget)
    chunks.clear()
    chunked = codec.encode_dataset(jobs, device="cpu")
    got = [(tuple(a[1]), tuple(k["img_of"]), len(a[0])) for a, k in chunks]
    assert got == [((3, 4), (0, 0), 1), ((3, 4), (0, 0), 1)], got
    plan = codec._plan_group(imgs, ijobs, False, 16)
    assert plan.budget == budget and plan.staging == "full"
    assert plan.chunks == [[0, 1], [2, 3]]
    assert plan.per_expert == [one_expert_full] * 4
    for ch in plan.chunks:
        n_imgs = len({ijobs[e][0] for e in ch})
        assert sum(plan.per_expert[e] for e in ch) + n_imgs * fixed <= budget
    # every job's stats carry the plan its group ran
    assert all(st.plan == plan for _, st in chunked)
    assert [s for s, _ in chunked] == [s for s, _ in one] == [s for s, _ in whole]


def test_dataset_seed_contract_singletons():
    """An explicit seed (tests/test_e2e.py:443): partner-less job j encodes
    as `encode_image(seed=job_seed(seed, j))`."""
    tr = TrainSpec(epochs=1, batch_size=1024)
    a = synth_scene(40, 40, channels=C, seed=1)
    b = synth_scene(32, 32, channels=C, seed=2)
    cfg = CodecConfig(K=4, base_codec="lpc", train=tr)
    res = codec.encode_dataset([(a, cfg), (b, cfg)], seed=9, device="cpu")
    for j, im in enumerate((a, b)):
        assert res[j][0] == codec.encode_image(im, cfg, seed=codec.job_seed(9, j),
                                               device="cpu")[0]
    assert codec.job_seed(9, 0) != codec.job_seed(9, 1) != 9


def test_dataset_seed_contract_grouped_path_independent():
    """An explicit seed (tests/test_e2e.py:466): every job of a group
    trains from `tile_generator(seed, 0)` on every path (the pipelined
    one-job-per-image path and expert chunks), so a job's bytes do not
    depend on how unrelated jobs grouped."""
    tr = TrainSpec(epochs=1, batch_size=1024)
    a, b = synth_scene(40, 40, channels=C, seed=3), synth_scene(40, 40, channels=C, seed=4)
    odd = synth_scene(32, 32, channels=C, seed=5)
    cfg = CodecConfig(K=4, base_codec="lpc", train=tr)
    cfg5 = CodecConfig(K=5, base_codec="lpc", train=tr)
    res = codec.encode_dataset([(a, cfg), (b, cfg)], seed=11, device="cpu")
    for j, im in enumerate((a, b)):
        assert res[j][0] == codec.encode_image(im, cfg, seed=11, device="cpu")[0]
    res3 = codec.encode_dataset([(a, cfg), (odd, cfg), (b, cfg)], seed=11, device="cpu")
    assert res3[0][0] == res[0][0] and res3[2][0] == res[1][0]
    experts = codec.encode_dataset([(a, cfg), (a, cfg5), (odd, cfg)], seed=11, device="cpu")
    assert experts[0][0] == res[0][0]
    assert experts[1][0] == codec.encode_image(a, cfg5, seed=11, device="cpu")[0]


def test_dataset_bucketed_mixed_shapes_one_chunk(monkeypatch):
    """bucket=True (tests/test_bucketing.py:145): two shapes of one bucket
    train as one expert chunk with per-expert masks, and each stream is
    `encode_image(bucket=True)`'s byte for byte; its header carries the
    real shape."""
    tr = TrainSpec(epochs=2, batch_size=1024)
    a = synth_scene(100, 90, channels=C, effective_bits=12, seed=21)
    b = synth_scene(120, 128, channels=C, effective_bits=12, seed=22)
    jobs = [(im, CodecConfig(K=K, base_codec="lpc", train=tr)) for im in (a, b) for K in (3, 5)]
    calls = []
    _record(monkeypatch, codec, "fit_rate_experts", calls)
    res = codec.encode_dataset(jobs, bucket=True, device="cpu")
    assert len(calls) == 1
    assert [tuple(h) for h in calls[0][1]["hws"]] == [(100, 90)] * 2 + [(120, 128)] * 2
    for (im, cfg), (stream, _) in zip(jobs, res):
        rec, dst = codec.decode_stream(stream, device="cpu")
        assert (dst.header.height, dst.header.width) == im.shape[1:]
        assert np.array_equal(rec >> cfg.K, im >> cfg.K)
        assert stream == codec.encode_image(im, cfg, bucket=True, device="cpu")[0]
    # without bucket=True the shapes never share a chunk
    calls.clear()
    codec.encode_dataset(jobs, device="cpu")
    assert [len(c[0][1]) for c in calls] == [2, 2]


def _flips_ok(a, b):
    diff = a.astype(np.int32) - b.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


def test_dataset_streams_cross_decode():
    """The port's dataset streams decode in the JAX package, and the JAX
    package's in the port: header K right, MSBs exact, residual flips
    bounded."""
    imgs = _scenes((60, 61))
    Ks = (3, 5)
    res = codec.encode_dataset([(im, _cfg(K)) for im in imgs for K in Ks], device="cpu")
    jres = jcodec.encode_dataset([(im, _jcfg(K)) for im in imgs for K in Ks])
    pairs = [(im, K) for im in imgs for K in Ks]
    for (im, K), (stream, _), (jstream, _) in zip(pairs, res, jres):
        for s in (stream, jstream):
            own, dh = codec.decode_stream(s, device="cpu")
            theirs, jdh = jcodec.decode_stream(s)
            assert dh.header.K == jdh.header.K == K
            assert np.array_equal(own >> K, im >> K) and np.array_equal(theirs >> K, im >> K)
            _flips_ok(own, theirs)


def test_dataset_mesh_and_default_device():
    """A mesh whose "ep" axis is 1 keeps the single-card path, byte for
    byte (the fan-out itself: tests/test_torch_mesh.py); a mesh needs a
    torch.distributed world, and without one make_mesh names torchrun."""
    from lbdrn_msic_tpu_torch.parallel.shard import make_mesh

    im = synth_scene(40, 40, channels=C, seed=1)
    jobs = [(im, _cfg(4)), (im, _cfg(5))]
    one_rank = types.SimpleNamespace(size=lambda dim: 1, get_local_rank=lambda name: 0)
    assert ([s for s, _ in codec.encode_dataset(jobs, mesh=one_rank, device="cpu")]
            == [s for s, _ in codec.encode_dataset(jobs, device="cpu")])
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(ep=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            codec.encode_dataset(jobs)
