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
import warnings
from typing import List, Optional

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.codecs.base_layer import (
    decode_base,
    encode_base,
    payload_codec,
    require_cv2,
)
from lbdrn_msic_tpu_torch.codecs.weights import compress_weights, decompress_weights
from lbdrn_msic_tpu_torch.core.config import CodecConfig
from lbdrn_msic_tpu_torch.features.engine import (
    lsb_scale,
    pad_plane,
    row_taps_dtype,
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
    staging: str = "cached"  # how the training batches were built
    staged_bytes: int = 0  # their staging buffers' device bytes (a sweep: its group's)
    step_losses: Optional[np.ndarray] = None  # (epochs, steps), with collect_curves


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


def _warn_gather_fallback(H, W, C):
    """A tile above every staged layout's budget trains by scalar gathers
    (far slower): `pick_staging` says so instead of crawling silently."""
    warnings.warn(
        f"tile {H}x{W}x{C} exceeds the staging budget even banded; "
        f"falling back to scalar gathers (~25x slower training). "
        f"Use split_ratio to tile the image (e.g. -sr 2).",
        RuntimeWarning,
        stacklevel=3,
    )


def pick_staging(H, W, C, max_msb, fspec, tspec):
    """The JAX package's rule for how training batches are built
    (train/loop.py::fit): the f32 feature cache when it fits the budget,
    else the full integer tap matrix, else banded row taps, else scalar
    gathers (with a RuntimeWarning).  Returns (staging, dtype): float32
    for "cached", the tap matrix's dtype for "full" and "gather", the raw
    row taps' for "banded"."""
    g = tspec.sample_granule
    if not fspec.use_colors:
        if fspec.use_coords and _cached_bytes(H, W, C, fspec, g) <= STAGE_BUDGET_BYTES:
            return "cached", torch.float32
        return "gather", torch.int16
    if _cached_bytes(H, W, C, fspec, g) <= STAGE_BUDGET_BYTES:
        return "cached", torch.float32
    tap_dt = tap_matrix_dtype(max_msb, fspec.relative)
    full, banded = _staging_bytes(
        H, W, C, fspec, g, _tap_itemsize(max_msb, fspec.relative),
        _tap_itemsize(max_msb, False),
    )
    if full <= STAGE_BUDGET_BYTES:
        return "full", tap_dt
    if banded <= STAGE_BUDGET_BYTES:
        return "banded", row_taps_dtype(max_msb)
    _warn_gather_fallback(H, W, C)
    return "gather", tap_dt


BUCKET_SMALL_Q, BUCKET_LARGE_Q = 128, 512


def bucket_dims(H: int, W: int, D: int = 0) -> tuple[int, int]:
    """Canonical bucket shape for (H, W), as the JAX package buckets: each
    dimension rounds up to a multiple of 128 (up to 1024) or of 512
    (above), so tiles of many shapes train at a few (7340x7815 and
    7605x7815 share 7680x8192; 6000^2 becomes 6144^2).  A dimension that
    would be padded by fewer than D takes the next step up, so that every
    real pixel's window sees the reflect pad of its own shape
    (`_pad_to_bucket`)."""
    def up(x: int) -> int:
        q = BUCKET_SMALL_Q if x <= 1024 else BUCKET_LARGE_Q
        b = -(-x // q) * q
        if b != x and b - x < D:
            b += q
        return b

    return up(H), up(W)


def _pad_to_bucket(tile: np.ndarray, D: int, Hb: int, Wb: int) -> np.ndarray:
    """Pad (C, H, W) to (C, Hb, Wb): the first D rows and columns past each
    edge reflect the image, so every real pixel's (2D+1)^2 window reads what
    the reflect pad of the real shape (`features/engine.pad_plane`) gives
    it, corner included; the rest repeats the edge (never read by a real
    pixel's window, masked out of every batch, and max() is unchanged, so
    the plane's scale is too)."""
    C, H, W = tile.shape
    dh, dw = Hb - H, Wb - W
    rh, rw = min(D, dh, H - 1), min(D, dw, W - 1)
    out = np.pad(tile, ((0, 0), (0, rh), (0, rw)), mode="reflect")
    if dh > rh or dw > rw:
        out = np.pad(out, ((0, 0), (0, dh - rh), (0, dw - rw)), mode="edge")
    return out


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
                device: torch.device, use_fused: Optional[bool] = None,
                bucket: bool = False):
    """Train one tile's network; returns (flat_fn, fit_result).

    `bucket=True` pads the tile up to its bucket (`bucket_dims`, pad by
    `_pad_to_bucket`) and trains at the bucket's shape with the real (H, W)
    masked in (`fit(hw=)`): RD-equivalent to the exact-shape fit, not
    byte-identical.  It applies to colour features without coordinates
    (coordinates are normalized by the shape); other configs train at the
    exact shape, with a RuntimeWarning.
    """
    C, H, W = tile.shape
    fspec = cfg.features
    hw = None
    dev_tile = tile
    if bucket and not (fspec.use_colors and not fspec.use_coords):
        warnings.warn(
            "bucket=True requested but shape bucketing applies only to "
            "colors/no-coords feature configs (coords features normalize by "
            "the static H/W) — training exact-shape.",
            RuntimeWarning,
            stacklevel=3,
        )
    elif bucket:
        Hb, Wb = bucket_dims(H, W, fspec.D)
        if (Hb, Wb) != (H, W):
            dev_tile = _pad_to_bucket(tile, fspec.D, Hb, Wb)
            hw = (H, W)
            H, W = Hb, Wb
    max_msb = int(tile.max()) >> cfg.K
    staging, tap_dtype = pick_staging(H, W, C, max_msb, fspec, cfg.train)
    dev = put_image(dev_tile, device)
    plane, plane_scale, labels = _prepare_tile(dev, cfg.K, fspec.D)
    label_scale = float(np.float32(lsb_scale(cfg.K)))
    result = fit(
        plane, plane_scale, labels, label_scale, generator,
        fspec, cfg.model, cfg.train, H, W, C,
        staging=staging, tap_dtype=tap_dtype, use_fused=use_fused, hw=hw, device=device,
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
    header_version: int = 1,
    collect_curves: bool = False,
    bucket: bool = False,
) -> tuple[bytes, EncodeStats]:
    """img: (C, H, W) uint16 -> (bitstream, stats).

    `device=None` means CUDA.  `seed` defaults to cfg.train.seed; each tile
    draws from `tile_generator(seed, tile_index)`.  `use_fused` (default:
    on CUDA) trains with the fused-step kernel, else with the exact
    autograd step.  The host base-layer codec of a tile runs in a worker
    thread while the device trains; tiles run one after another.

    `header_version`: 1 (default) or 0, the reference's header layout (the
    body after it is the same).  `collect_curves`: each tile's per-step
    losses land in `TileStats.step_losses`.  `bucket`: train each tile at
    its bucket's shape (`_train_tile`); RD-equivalent, not byte-identical,
    to the exact-shape encode.
    """
    device = resolve_device(device)
    if cfg.base_codec == "jp2":
        require_cv2()  # fail before training, not after it
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
                    tile, cfg, tile_generator(seed, tile_idx), device, use_fused, bucket
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
                staging=result.staging,
                staged_bytes=result.staged_bytes,
                step_losses=result.step_losses.cpu().numpy() if collect_curves else None,
            ))
    header = header_from_config(
        cfg, W, H,
        [len(s) for s in nn_streams],
        [len(s) for s in base_streams],
        version=header_version,
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
        # the expert loop has no coordinate features yet: point by point
        and not c.features.use_coords
        for c in cfgs
    )


def plan_rate_points(img: np.ndarray, cfgs: List[CodecConfig]):
    """The JAX package's staging plan for a rate sweep of compatible
    configs: (staging, tap dtypes, groups of config indices, staged bytes
    per expert).  "full" when every expert's tap matrix fits the budget
    alone (dtypes: the tap matrices'), else "banded" when its row taps do
    (the raw row taps'), else "gather", which the sweep leaves to
    `encode_image` one config at a time; experts are chunked into groups
    whose staged bytes fit the budget together."""
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
    dtypes = [row_taps_dtype(max_img >> c.K) if staging == "banded"
              else tap_matrix_dtype(max_img >> c.K, fspec.relative) for c in cfgs]
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
    `encode_image(img, cfg, seed)`.  Configs that differ beyond K, and
    sweeps whose banded row taps exceed the budget (`plan_rate_points`:
    "gather"), are encoded one by one with `encode_image` (the same bytes).
    Returns one (stream, stats) per config, in order.
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
    if staging == "gather":
        return [encode_image(img, c, seed, use_fused, device) for c in cfgs]

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
                    staging=staging, device=device,
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
                        staging=result.staging, staged_bytes=result.staged_bytes,
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
            # a v0 header has no codec field: the payload's magic names it
            codec_name = header.base_codec if header.version else payload_codec(base_stream)
            base = decode_base(base_stream, codec_name)
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
