"""Top-level codec API: encode an image array to a bitstream and back.

Orchestrates the pipeline the reference spreads over encode.py / decode.py
(reference encode.py:167-289, decode.py:151-225): tile split, per-tile
training on the device, weight + base-layer coding, header assembly; and
the inverse; `encode_rate_points` encodes one image at several K, one
network per K trained together (the reference's run.sh rate sweep).  Pure
array-in/array-out.  Streams are the JAX package's v1 format: either
package decodes the other's streams.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.codecs.base_layer import decode_base, encode_base
from lbdrn_msic_tpu_torch.codecs.weights import compress_weights, decompress_weights
from lbdrn_msic_tpu_torch.core.config import CodecConfig
from lbdrn_msic_tpu_torch.features.engine import (
    lsb_scale,
    pad_plane,
    split_msb_lsb,
    tap_matrix_dtype,
)
from lbdrn_msic_tpu_torch.io.header import (
    StreamHeader,
    decode_header,
    encode_header,
    header_from_config,
    header_size,
)
from lbdrn_msic_tpu_torch.io.tiles import merge_tiles, split_image
from lbdrn_msic_tpu_torch.models.siren import (
    flatten_params,
    pad_dim,
    unflatten_params,
    unstack_params,
)
from lbdrn_msic_tpu_torch.train.loop import fit, fit_rate_experts
from lbdrn_msic_tpu_torch.utils.profiling import PhaseTimer
from lbdrn_msic_tpu_torch.utils.transfer import put_image


@dataclasses.dataclass
class TileStats:
    nn_bytes: int
    base_bytes: int
    best_mse: float
    best_epoch: int
    train_time: float
    base_time: float


@dataclasses.dataclass
class EncodeStats:
    tiles: List[TileStats]
    total_bytes: int
    n_subpixels: int
    elapsed: float
    # host-side phase accounting: dispatch (h2d + prep + training queued),
    # train_wait (blocking on the device), weights_codec, base_wait
    phases: Optional[dict] = None

    @property
    def bpsp(self) -> float:
        return self.total_bytes * 8 / self.n_subpixels


@dataclasses.dataclass
class DecodeStats:
    elapsed: float
    header: StreamHeader
    # base_decode (host base codec), dispatch (weight decode + device
    # residual dispatch), fetch_assemble (d2h bitplanes + host assembly)
    phases: Optional[dict] = None


# Staging budget per tile, kept at the JAX package's value so `pick_staging`
# decides as it does (re-deriving it for an 80 GB card is ROADMAP work).
STAGE_BUDGET_BYTES = 8 << 30


def _cached_bytes(H: int, W: int, C: int, fspec, g: int) -> int:
    """Device bytes of the f32 feature cache plus, for g > 1, its
    granule-grouped copy (the JAX package's accounting; in torch the
    grouped form is a free view)."""
    g = max(1, g)
    rows = -(-H * W // g) * g
    one = rows * pad_dim(fspec.feature_dim(C)) * 4
    return one * (2 if g > 1 else 1)


def _staging_bytes(H: int, W: int, C: int, fspec, g: int, tap_itemsize: int,
                   raw_itemsize: int):
    """(full, banded) staged-bytes estimates for one tile."""
    side = 2 * fspec.D + 1
    Wg = -(-W // max(1, g)) * max(1, g)
    full = H * W * C * side * side * tap_itemsize
    banded = (H + 2 * fspec.D) * Wg * C * side * raw_itemsize
    return full, banded


def _tap_itemsize(max_value: int, relative: bool) -> int:
    if relative:
        return 1 if max_value <= 127 else (2 if max_value <= 32767 else 4)
    return 1 if max_value <= 255 else 2


def pick_staging(H, W, C, max_msb, fspec, tspec) -> str:
    """The JAX package's decision rule for how training batches are built:
    the f32 feature cache when it fits the budget, else the full integer
    tap matrix, else banded row taps, else scalar gathers.  Only "cached"
    is ported; the caller raises for the others."""
    g = tspec.sample_granule
    if not fspec.use_colors:
        if fspec.use_coords and _cached_bytes(H, W, C, fspec, g) <= STAGE_BUDGET_BYTES:
            return "cached"
        return "gather"
    if _cached_bytes(H, W, C, fspec, g) <= STAGE_BUDGET_BYTES:
        return "cached"
    full, banded = _staging_bytes(
        H, W, C, fspec, g, _tap_itemsize(max_msb, fspec.relative),
        _tap_itemsize(max_msb, False),
    )
    if full <= STAGE_BUDGET_BYTES:
        return "full"
    if banded <= STAGE_BUDGET_BYTES:
        return "banded"
    return "gather"


def _prepare_tile(img: torch.Tensor, K: int, D: int):
    """Training prep on the device: MSB/LSB split, reflect pad + scale."""
    msb, lsb = split_msb_lsb(img, K)
    plane, plane_scale = pad_plane(msb, D)
    return plane, plane_scale, lsb


def tile_generator(seed: int, tile_idx: int) -> torch.Generator:
    """CPU generator of one tile's init params and epoch permutations."""
    state = np.random.SeedSequence([seed, tile_idx]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def _msb_plane(tile: np.ndarray, K: int) -> np.ndarray:
    """The base layer as the encoder stores it: uint8 when the MSB fits
    (reference LBDRNdataset.py:100), else uint16."""
    msb = tile >> K
    return msb.astype(np.uint8) if int(msb.max()) <= 255 else msb.astype(np.uint16)


def _train_tile(tile: np.ndarray, cfg: CodecConfig, generator: torch.Generator,
                device: torch.device, use_fused: Optional[bool] = None):
    """Train one tile's network; returns (flat_fn, fit_result)."""
    C, H, W = tile.shape
    fspec = cfg.features
    max_msb = int(tile.max()) >> cfg.K
    staging = pick_staging(H, W, C, max_msb, fspec, cfg.train)
    if staging != "cached":
        raise NotImplementedError(
            f"tile {H}x{W}x{C} needs {staging!r} staging, not ported yet "
            "(ROADMAP: other staging modes)"
        )
    dev = put_image(tile, device)
    plane, plane_scale, labels = _prepare_tile(dev, cfg.K, fspec.D)
    label_scale = float(np.float32(lsb_scale(cfg.K)))
    result = fit(
        plane, plane_scale, labels, label_scale, generator,
        fspec, cfg.model, cfg.train, H, W, C,
        use_fused=use_fused, device=device,
    )

    def flat_fn():
        return flatten_params(result.params, fspec.feature_dim(C))

    return flat_fn, result


def encode_image(
    img: np.ndarray,
    cfg: CodecConfig,
    seed: Optional[int] = None,
    use_fused: Optional[bool] = None,
    device=None,
) -> tuple[bytes, EncodeStats]:
    """img: (C, H, W) uint16 -> (bitstream, stats).

    `device=None` means CUDA.  `seed` defaults to cfg.train.seed; each tile
    draws from `tile_generator(seed, tile_index)`.  `use_fused` (default:
    on CUDA) trains with the fused-step kernel, else with the exact
    autograd step.  The host base-layer codec of a tile runs in a worker
    thread while the device trains; tiles run one after another.
    """
    device = resolve_device(device)
    if img.ndim == 2:
        img = img[None]
    C, H, W = img.shape
    seed = cfg.train.seed if seed is None else seed
    t0 = time.time()
    timer = PhaseTimer()
    nn_streams, base_streams, tiles_stats = [], [], []
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        for tile_idx, tile in enumerate(split_image(img, cfg.split_ratio)):
            t1 = time.time()
            with timer.phase("dispatch"):
                base_future = pool.submit(
                    lambda t=tile: encode_base(_msb_plane(t, cfg.K), cfg.base_codec)
                )
                flat_fn, result = _train_tile(
                    tile, cfg, tile_generator(seed, tile_idx), device, use_fused
                )
            with timer.phase("train_wait"):
                flat = flat_fn()  # blocks on the device result
            t2 = time.time()
            with timer.phase("weights_codec"):
                nn = compress_weights(flat, cfg.precision, cfg.weight_codec)
            with timer.phase("base_wait"):
                base = base_future.result()
            t3 = time.time()
            nn_streams.append(nn)
            base_streams.append(base)
            tiles_stats.append(TileStats(
                nn_bytes=len(nn),
                base_bytes=len(base),
                best_mse=result.best_mse,
                best_epoch=result.best_epoch,
                train_time=t2 - t1,
                base_time=t3 - t2,
            ))
    header = header_from_config(
        cfg, W, H,
        [len(s) for s in nn_streams],
        [len(s) for s in base_streams],
        version=1,
    )
    out = bytearray(encode_header(header))
    for nn, base in zip(nn_streams, base_streams):
        out += nn
        out += base
    stream = bytes(out)
    return stream, EncodeStats(
        tiles=tiles_stats,
        total_bytes=len(stream),
        n_subpixels=C * H * W,
        elapsed=time.time() - t0,
        phases=dict(timer.phases),
    )


def _experts_compatible(cfgs: List[CodecConfig]) -> bool:
    """Rate-point jobs can train together as experts iff they differ only
    in K."""
    c0 = cfgs[0]
    return all(
        c.split_ratio == 1
        and c.features == c0.features
        and c.model == c0.model
        and c.train == c0.train
        and c.precision == c0.precision
        and c.weight_codec == c0.weight_codec
        and c.base_codec == c0.base_codec
        and c.features.use_colors
        for c in cfgs
    )


def plan_rate_points(img: np.ndarray, cfgs: List[CodecConfig]):
    """The JAX package's staging plan for a rate sweep of compatible
    configs: (staging, tap dtypes, groups of config indices, staged bytes
    per expert).  "full" when every expert's tap matrix fits the budget
    alone, else "banded" when its row taps do, else "gather"; experts are
    chunked into groups whose staged bytes fit the budget together."""
    C, H, W = img.shape
    fspec = cfgs[0].features
    g = cfgs[0].train.sample_granule
    max_img = int(img.max())
    sizes = [
        _staging_bytes(H, W, C, fspec, g, _tap_itemsize(max_img >> c.K, fspec.relative),
                       _tap_itemsize(max_img >> c.K, False))
        for c in cfgs
    ]
    if max(s[0] for s in sizes) <= STAGE_BUDGET_BYTES:
        staging, per_expert = "full", [s[0] for s in sizes]
    elif max(s[1] for s in sizes) <= STAGE_BUDGET_BYTES:
        staging, per_expert = "banded", [s[1] for s in sizes]
    else:
        staging, per_expert = "gather", [s[1] for s in sizes]
    groups: List[List[int]] = [[]]
    acc = 0
    for i, b in enumerate(per_expert):
        if groups[-1] and acc + b > STAGE_BUDGET_BYTES:
            groups.append([])
            acc = 0
        groups[-1].append(i)
        acc += b
    dtypes = [tap_matrix_dtype(max_img >> c.K, fspec.relative) for c in cfgs]
    return staging, dtypes, groups, per_expert


def encode_rate_points(
    img: np.ndarray,
    cfgs: List[CodecConfig],
    seed: Optional[int] = None,
    use_fused: Optional[bool] = None,
    device=None,
) -> List[tuple[bytes, EncodeStats]]:
    """Encode one image at several rate points: one network per K, all
    trained together (`fit_rate_experts`; kernel K2 on the card).

    img: (C, H, W) uint16.  `device=None` means CUDA; `use_fused` as in
    `encode_image`.  The image crosses to the device once for every rate
    point; the host base codecs of every K run in worker threads while the
    device trains.  Every expert takes `encode_image`'s draws at the same
    seed (`tile_generator(seed, 0)`), so each stream is byte-identical to
    `encode_image(img, cfg, seed)`.  Configs that differ beyond K are
    encoded one by one with `encode_image` (the same bytes).  Returns one
    (stream, stats) per config, in order.
    """
    device = resolve_device(device)
    if img.ndim == 2:
        img = img[None]
    C, H, W = img.shape
    if not _experts_compatible(cfgs):
        return [encode_image(img, c, seed, use_fused, device) for c in cfgs]
    cfg0 = cfgs[0]
    fspec = cfg0.features
    seed = cfg0.train.seed if seed is None else seed
    staging, dtypes, groups, _ = plan_rate_points(img, cfgs)
    if staging != "full":
        raise NotImplementedError(
            f"image {C}x{H}x{W} needs {staging!r} staging for a rate sweep, "
            "not ported yet (ROADMAP: banded staging)"
        )

    results: List[Optional[tuple[bytes, EncodeStats]]] = [None] * len(cfgs)
    dev_img = put_image(img, device)  # one copy for every rate point
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        for grp in groups:
            t0 = time.time()
            timer = PhaseTimer()
            with timer.phase("dispatch"):
                base_futs = [
                    pool.submit(lambda K=cfgs[i].K: encode_base(_msb_plane(img, K),
                                                                cfg0.base_codec))
                    for i in grp
                ]
                result = fit_rate_experts(
                    dev_img, [cfgs[i].K for i in grp], tile_generator(seed, 0),
                    fspec, cfg0.model, cfg0.train, H, W, C,
                    tap_dtypes=[dtypes[i] for i in grp], use_fused=use_fused,
                    device=device,
                )
            with timer.phase("train_wait"):  # blocks on the device result
                flats = [flatten_params(unstack_params(result.params, e),
                                        fspec.feature_dim(C)) for e in range(len(grp))]
            t_train = time.time() - t0
            for e, i in enumerate(grp):
                cfg = cfgs[i]
                with timer.phase("weights_codec"):
                    nn = compress_weights(flats[e], cfg.precision, cfg.weight_codec)
                with timer.phase("base_wait"):
                    base = base_futs[e].result()
                header = header_from_config(cfg, W, H, [len(nn)], [len(base)], version=1)
                stream = encode_header(header) + nn + base
                results[i] = (stream, EncodeStats(
                    tiles=[TileStats(
                        nn_bytes=len(nn), base_bytes=len(base),
                        best_mse=result.best_mse[e], best_epoch=result.best_epoch[e],
                        train_time=t_train / len(grp), base_time=0.0,
                    )],
                    total_bytes=len(stream),
                    n_subpixels=C * H * W,
                    elapsed=time.time() - t0,
                ))
            for i in grp:  # the group's phases, shared by its points
                results[i][1].phases = dict(timer.phases)
    return results  # type: ignore[return-value]


def _dispatch_decode(data: bytes, pt: PhaseTimer, device: torch.device):
    """Header parse, then per tile: base decode, weight decode and the
    device residual dispatch.  Returns (header, finishes), one zero-arg
    finish() per tile that fetches and assembles it."""
    from lbdrn_msic_tpu_torch.decode.reconstruct import dispatch_streamed

    header = decode_header(data)
    ptr = header_size(data)
    fspec = header.feature_spec()
    mspec = header.model_spec()
    pending = []
    for t in range(header.n_tiles):
        nn = data[ptr : ptr + header.nn_bytes[t]]
        ptr += header.nn_bytes[t]
        base_stream = data[ptr : ptr + header.base_bytes[t]]
        ptr += header.base_bytes[t]
        with pt.phase("base_decode"):
            base = decode_base(base_stream, header.base_codec)
        C = base.shape[0]
        with pt.phase("dispatch"):
            flat = decompress_weights(nn, header.weight_codec)
            params = unflatten_params(flat, fspec.feature_dim(C), C, mspec, device=device)
            pending.append(dispatch_streamed(base, params, fspec, mspec, header.K, device))
    return header, pending


def _finalize_decode(header, pending, pt) -> np.ndarray:
    with pt.phase("fetch_assemble"):
        tiles = [finish() for finish in pending]
        return merge_tiles(tiles, header.height, header.width, header.split_ratio)


def decode_stream(data: bytes, device=None) -> tuple[np.ndarray, DecodeStats]:
    """bitstream -> ((C, H, W) uint16 image, stats).  `device=None` means
    CUDA."""
    device = resolve_device(device)
    t0 = time.time()
    pt = PhaseTimer()
    with torch.no_grad():
        header, pending = _dispatch_decode(data, pt, device)
        img = _finalize_decode(header, pending, pt)
    return img, DecodeStats(elapsed=time.time() - t0, header=header, phases=dict(pt.phases))
