"""Top-level codec API: encode an image array to a bitstream and back.

Orchestrates the pipeline the reference spreads over encode.py / decode.py
(reference encode.py:167-289, decode.py:151-225): tile split, per-tile
training on the device, weight + base-layer coding, header assembly; and
the inverse; `encode_rate_points` encodes one image at several K, one
network per K trained together (the reference's run.sh rate sweep).  Pure
array-in/array-out.  Streams are the JAX package's v1 format: either
package decodes the other's streams.

`mesh` (a `parallel.shard.make_mesh` DeviceMesh; None: one card) spreads
the work over the ranks of a torch.distributed world, SPMD: every rank
calls the entry point with the same arguments and gets the same result.
A "dp" axis trains each tile data-parallel (`encode_image`) and decodes
each tile in row bands (`decode_stream`, `decode_pipelined_iter`); an
"ep" axis fans the experts of a sweep or a dataset out over the ranks
(`encode_rate_points`, `encode_dataset`).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
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
from lbdrn_msic_tpu_torch.parallel.distributed import collect_objects
from lbdrn_msic_tpu_torch.parallel.halo import reconstruct_sp
from lbdrn_msic_tpu_torch.parallel.shard import axis_rank, axis_size, fit_dp, fit_experts
from lbdrn_msic_tpu_torch.train.loop import fit, fit_rate_experts
from lbdrn_msic_tpu_torch.utils.profiling import NoTimer, PhaseTimer
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
    # host seconds by phase (`utils/profiling.PhaseTimer`): dispatch (the
    # upload, the base codecs' submission and the fit), and inside it the
    # fit's stage (copies, labels, staged features or taps, buffers,
    # init), steps (every epoch's batches and step calls issued) and eval
    # (each eval's issue and the sync reading its MSE), with stage_device
    # and eval_device the stage's and the evals' seconds on the device
    # clock (CUDA events; none on the CPU); then train_wait (fetching the
    # trained weights), weights_codec and base_wait (`encode_image`), or
    # finalize (a rate sweep's or a dataset chunk's weight coding and base
    # codec wait, for the group).  base_code: the base coders' own seconds
    # on their worker threads, summed over the job's or the group's
    # coders (every encode entry but the mesh's; `encode_pipelined`
    # records only it).  A rate sweep's group and a dataset's chunk share
    # one dict among their points.  None on the other paths
    phases: Optional[dict] = None
    # the plan of the expert group the job trained in (`encode_dataset`);
    # None where it trained alone
    plan: Optional[GroupPlan] = None

    @property
    def bpsp(self) -> float:
        return self.total_bytes * 8 / self.n_subpixels


@dataclasses.dataclass
class DecodeStats:
    elapsed: float
    header: StreamHeader
    # host seconds by phase: base_decode (host base codec), dispatch
    # (weight decode + device residual dispatch) or dispatch_pipelined (the
    # streamed lpc path: both, interleaved), fetch_assemble (d2h bitplanes
    # + host assembly); with `decode_pipelined_iter`, dispatch_wait (the
    # caller's wait on the dispatch worker, which runs the first three)
    phases: Optional[dict] = None


# Staging budget per tile, and per chunk of an expert group: half the
# card (NVIDIA H100 80GB HBM3, 700.00 W).  Above its staged bytes a
# Gaofen-sized fit measured +3.5 to +6.8 GB of image, labels, batches,
# activations and allocator slack, so a fit staging up to this budget
# should peak near 50 GB, inside 64 GB (80 % of the card).  Measured at
# this budget (chip_smoke.py staging and flagship lines): the GF-2 "full"
# rate sweep (33.2 GiB of taps) peaks at 39.5 GB allocated, 41.0 GB
# reserved; the flagship's GF-2 and WFI chunks (~36 GiB each) at
# 42.3-42.4 GB allocated, 45.4-46.9 GB reserved.
STAGE_BUDGET_BYTES = 40 << 30


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


def pick_staging(H, W, C, max_msb, fspec, tspec, warn=True):
    """The JAX package's rule for how training batches are built
    (train/loop.py::fit): the f32 feature cache when it fits the budget,
    else the full integer tap matrix, else banded row taps, else scalar
    gathers (with a RuntimeWarning).  Returns (staging, dtype): float32
    for "cached", the tap matrix's dtype for "full" and "gather", the raw
    row taps' for "banded".  `warn=False` keeps the gather warning quiet
    for size estimates (`tiles_overlap`), so that it fires only where a
    tile's staging is really chosen."""
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
    if warn:
        _warn_gather_fallback(H, W, C)
    return "gather", tap_dt


# Two tiles' staging and images stay below this for `encode_image` to
# double-buffer them: together they stay within what one tile may stage.
OVERLAP_BUDGET_BYTES = STAGE_BUDGET_BYTES


def tiles_overlap(shape, max_value: int, itemsize: int, cfg: CodecConfig) -> bool:
    """Whether `encode_image` prepares tile t+1 while tile t trains, for an
    image of `shape` (C, H, W), largest sample `max_value` and `itemsize`
    bytes a sample, split by cfg.split_ratio: the JAX package's rule.  The
    last tile absorbs the split remainders, so it bounds the estimate of
    one tile's staging (`_cached_bytes`, the "full" or "banded" bytes of
    `_staging_bytes`, or 0 for "gather"); two tiles' staging and images
    must stay below OVERLAP_BUDGET_BYTES."""
    C, H, W = shape
    sr = cfg.split_ratio
    if sr * sr <= 1:
        return False
    tH, tW = H // sr + H % sr, W // sr + W % sr
    max_msb = max_value >> cfg.K
    staging, _ = pick_staging(tH, tW, C, max_msb, cfg.features, cfg.train, warn=False)
    g = max(1, cfg.train.sample_granule)
    if staging == "cached":
        sbytes = _cached_bytes(tH, tW, C, cfg.features, g)
    elif staging in ("full", "banded"):
        # the JAX dtype's itemsize (the port widens absolute taps above 255)
        isz = _tap_itemsize(max_msb, cfg.features.relative and staging == "full")
        full, banded = _staging_bytes(tH, tW, C, cfg.features, g, isz, isz)
        sbytes = full if staging == "full" else banded
    else:
        sbytes = 0
    return 2 * (sbytes + C * tH * tW * itemsize) < OVERLAP_BUDGET_BYTES


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


def job_seed(seed: int, job_idx: int) -> int:
    """The seed of job `job_idx` of a multi-job encode called with an
    explicit `seed` (the counterpart of the JAX package's
    ``fold_in(key, job_idx)``): `encode_pipelined` jobs and partner-less
    `encode_dataset` jobs encode as ``encode_image(img, cfg,
    seed=job_seed(seed, job_idx))``."""
    return int(np.random.SeedSequence(seed, spawn_key=(job_idx,)).generate_state(1)[0])


def _msb_plane(tile: np.ndarray, K: int) -> np.ndarray:
    """The base layer as the encoder stores it: uint8 when the MSB fits
    (reference LBDRNdataset.py:100), else uint16."""
    msb = tile >> K
    return msb.astype(np.uint8) if int(msb.max()) <= 255 else msb.astype(np.uint16)


def _submit_base(pool, img: np.ndarray, K: int, base_codec: str,
                 timer: Optional[PhaseTimer] = None):
    """The base layer of `img` at K coded on a worker of `pool`: a future of
    its bytes.  `timer` takes the coder's own seconds as `base_code`,
    beside the caller's wait for them."""
    def code():
        with (timer or NoTimer()).phase("base_code"):
            return encode_base(_msb_plane(img, K), base_codec)

    return pool.submit(code)


@dataclasses.dataclass
class _TileOnDevice:
    """One tile uploaded and prepared for `fit`: the padded base plane, its
    scale and the LSB labels on the device, the shape it trains at (its
    bucket's with bucketing), the real (H, W) then, and its staging."""

    plane: torch.Tensor
    plane_scale: torch.Tensor
    labels: torch.Tensor
    H: int
    W: int
    hw: Optional[tuple]
    staging: str
    tap_dtype: torch.dtype


def _upload_tile(tile: np.ndarray, cfg: CodecConfig, device: torch.device,
                 bucket: bool = False) -> _TileOnDevice:
    """The staging choice, host-to-device copy and prep of one tile.

    `bucket=True` pads the tile up to its bucket (`bucket_dims`, pad by
    `_pad_to_bucket`) to train at the bucket's shape with the real (H, W)
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
            stacklevel=4,
        )
    elif bucket:
        Hb, Wb = bucket_dims(H, W, fspec.D)
        if (Hb, Wb) != (H, W):
            dev_tile = _pad_to_bucket(tile, fspec.D, Hb, Wb)
            hw = (H, W)
            H, W = Hb, Wb
    staging, tap_dtype = pick_staging(H, W, C, int(tile.max()) >> cfg.K, fspec, cfg.train)
    plane, plane_scale, labels = _prepare_tile(put_image(dev_tile, device), cfg.K, fspec.D)
    return _TileOnDevice(plane, plane_scale, labels, H, W, hw, staging, tap_dtype)


def _upload_tile_aside(tile: np.ndarray, cfg: CodecConfig, device: torch.device,
                       bucket: bool):
    """`_upload_tile` on a stream of its own (run in a worker thread while
    the caller's stream trains another tile): (tile, event that ends its
    work), the event None off CUDA.  `_adopt_tile` hands it over."""
    if device.type != "cuda":
        return _upload_tile(tile, cfg, device, bucket), None
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        up = _upload_tile(tile, cfg, device, bucket)
        done = torch.cuda.Event()
        done.record(side)
    return up, done


def _adopt_tile(up: _TileOnDevice, done, device: torch.device) -> _TileOnDevice:
    """Make the caller's stream wait for a tile uploaded aside, and tell
    the caching allocator that its tensors are used on that stream."""
    if done is not None:
        main = torch.cuda.current_stream(device)
        main.wait_event(done)
        for t in (up.plane, up.plane_scale, up.labels):
            t.record_stream(main)
    return up


def _train_tile(tile: np.ndarray, cfg: CodecConfig, generator: torch.Generator,
                device: torch.device, use_fused: Optional[bool] = None,
                bucket: bool = False, up: Optional[_TileOnDevice] = None, mesh=None,
                timer: Optional[PhaseTimer] = None):
    """Train one tile's network; returns (flat_fn, fit_result).  `up`: the
    tile already on the device (`_upload_tile`), else it is uploaded here;
    `bucket` as `_upload_tile` takes it.  With a `mesh` whose "dp" axis is
    > 1 the tile trains data-parallel over it (`parallel.shard.fit_dp`).
    `timer` takes the fit's phases (`fit`; not on the data-parallel path)."""
    C = tile.shape[0]
    if up is None:
        up = _upload_tile(tile, cfg, device, bucket)
    label_scale = float(np.float32(lsb_scale(cfg.K)))
    if axis_size(mesh, "dp") > 1:
        result = fit_dp(mesh, up.plane, up.plane_scale, up.labels, label_scale, generator,
                        cfg.features, cfg.model, cfg.train, up.H, up.W, C, staging=up.staging,
                        tap_dtype=up.tap_dtype, hw=up.hw, device=device)
    else:
        result = fit(
            up.plane, up.plane_scale, up.labels, label_scale, generator,
            cfg.features, cfg.model, cfg.train, up.H, up.W, C,
            staging=up.staging, tap_dtype=up.tap_dtype, use_fused=use_fused, hw=up.hw,
            device=device, timer=timer,
        )

    def flat_fn():
        return flatten_params(result.params, cfg.features.feature_dim(C))

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
    mesh=None,
) -> tuple[bytes, EncodeStats]:
    """img: (C, H, W) uint16 -> (bitstream, stats).

    `device=None` means CUDA.  `seed` defaults to cfg.train.seed; each tile
    draws from `tile_generator(seed, tile_index)`.  `use_fused` (default:
    on CUDA) trains with the fused-step kernel, else with the exact
    autograd step.  The host base-layer codec of a tile runs in a worker
    thread while the device trains.  With split_ratio > 1 the tiles are
    double-buffered where `tiles_overlap` allows it, as in the JAX
    package: while tile t trains, a worker thread uploads and prepares
    tile t+1 on a CUDA stream of its own, and its base codec starts; tile
    t+1 trains once tile t's fit has returned, and the streams are
    byte-identical to the serial order (the same draws, the same
    programs).

    `header_version`: 1 (default) or 0, the reference's header layout (the
    body after it is the same).  `collect_curves`: each tile's per-step
    losses land in `TileStats.step_losses`.  `bucket`: train each tile at
    its bucket's shape (`_upload_tile`); RD-equivalent, not byte-identical,
    to the exact-shape encode.

    `mesh`: a "dp" axis > 1 trains every tile data-parallel over its ranks
    (`_train_tile`), the tiles one after another (no double buffering);
    the stream is deterministic and RD-equivalent to the single-card one
    (the exact step, summed over the ranks), not byte-identical.  Under a
    mesh `bucket` is refused with a RuntimeWarning and the tiles train at
    their exact shape, as in the JAX package.
    """
    device = resolve_device(device)
    if mesh is not None and bucket:
        warnings.warn(
            "bucket=True requested but shape bucketing applies on a single device "
            "only (a dp mesh would shard the pad unevenly) — training exact-shape.",
            RuntimeWarning,
            stacklevel=2,
        )
        bucket = False
    if cfg.base_codec == "jp2":
        require_cv2()  # fail before training, not after it
    if img.ndim == 2:
        img = img[None]
    C, H, W = img.shape
    seed = cfg.train.seed if seed is None else seed
    t0 = time.time()
    timer = PhaseTimer()
    nn_streams, base_streams, tiles_stats = [], [], []
    tiles = list(split_image(img, cfg.split_ratio))
    overlap = mesh is None and tiles_overlap(img.shape, int(img.max()), img.dtype.itemsize, cfg)

    def base_of(tile):
        return _submit_base(pool, tile, cfg.K, cfg.base_codec, timer)

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as upload_pool:
        ahead = None  # (base future, upload future) of the next tile
        for tile_idx, tile in enumerate(tiles):
            t1 = time.time()
            with timer.phase("dispatch"):
                if ahead is None:
                    base_future = base_of(tile)
                    up = _upload_tile(tile, cfg, device, bucket)
                else:
                    base_future, up_future = ahead
                    up = _adopt_tile(*up_future.result(), device)
                ahead = None
                if overlap and tile_idx + 1 < len(tiles):
                    nxt = tiles[tile_idx + 1]
                    ahead = (base_of(nxt),
                             upload_pool.submit(_upload_tile_aside, nxt, cfg, device, bucket))
                flat_fn, result = _train_tile(tile, cfg, tile_generator(seed, tile_idx), device,
                                              use_fused, up=up, mesh=mesh, timer=timer)
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
                # an exclusive window, as the JAX package's: t1 is read
                # after the previous tile's finalize (its `fit` returns
                # when training ends, where JAX's dispatch returns at
                # once and needs a clamp), so the windows are disjoint
                # and sum to no more than the wall clock
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


def _coded_job(cfg: CodecConfig, shape, flat: np.ndarray, base_future, fit, e: Optional[int],
               t_train: float, t0: float, header_version: int = 1):
    """One untiled job's (stream, stats): its weights coded, its base
    codec's bytes (awaited), a header with the real (height, width) of
    `shape` (C, H, W).  `fit` is the job's fit result; `e` picks the job's
    expert of an expert fit (None: a one-network fit)."""
    C, H, W = shape
    nn = compress_weights(flat, cfg.precision, cfg.weight_codec)
    base = base_future.result()
    header = header_from_config(cfg, W, H, [len(nn)], [len(base)], version=header_version)
    stream = encode_header(header) + nn + base
    best_mse, best_epoch = ((fit.best_mse, fit.best_epoch) if e is None
                            else (fit.best_mse[e], fit.best_epoch[e]))
    return stream, EncodeStats(
        tiles=[TileStats(
            nn_bytes=len(nn), base_bytes=len(base), best_mse=best_mse, best_epoch=best_epoch,
            train_time=t_train, base_time=0.0, staging=fit.staging,
            staged_bytes=fit.staged_bytes,
        )],
        total_bytes=len(stream),
        n_subpixels=C * H * W,
        elapsed=time.time() - t0,
    )


def encode_pipelined(
    jobs: List[tuple[np.ndarray, CodecConfig]],
    seed: Optional[int] = None,
    header_version: int = 1,
    bucket: bool = False,
    seeds: Optional[List[int]] = None,
    device=None,
) -> List[tuple[bytes, EncodeStats]]:
    """Encode a list of (image, cfg) jobs, one after another on the device,
    with the host work of each job overlapping its neighbours' training:
    job i's base codec runs in a worker thread while it trains, and its
    weight coding and stream assembly in another while job i + 1 uploads,
    stages and trains.

    Each stream is byte-identical to ``encode_image(img, cfg, seed=s,
    header_version=header_version, bucket=bucket)`` with s = `seeds[i]`
    when given, else ``job_seed(seed, i)`` for an explicit `seed`, else
    cfg.train.seed.  Tiled jobs (split_ratio > 1) go to `encode_image`.
    `device=None` means CUDA.
    """
    device = resolve_device(device)
    if any(cfg.base_codec == "jp2" for _, cfg in jobs):
        require_cv2()
    results: List[Optional[tuple[bytes, EncodeStats]]] = [None] * len(jobs)

    def finalize(i, cfg, shape, flat, base_future, timer, result, t_start, t_train):
        results[i] = _coded_job(cfg, shape, flat, base_future, result, None, t_train, t_start,
                                header_version)
        results[i][1].phases = dict(timer.phases)  # its base coder has finished

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as fin_pool:
        fins = []
        for i, (img, cfg) in enumerate(jobs):
            if img.ndim == 2:
                img = img[None]
            if seeds is not None:
                s = seeds[i]
            else:
                s = cfg.train.seed if seed is None else job_seed(seed, i)
            if cfg.split_ratio != 1:
                results[i] = encode_image(img, cfg, s, device=device,
                                          header_version=header_version, bucket=bucket)
                continue
            t_start = time.time()
            timer = PhaseTimer()
            base_future = _submit_base(pool, img, cfg.K, cfg.base_codec, timer)
            flat_fn, result = _train_tile(img, cfg, tile_generator(s, 0), device,
                                          bucket=bucket)
            # the fit ended on its last eval's sync: fetch before the next
            # job's steps are queued behind this copy
            flat = flat_fn()
            fins.append(fin_pool.submit(finalize, i, cfg, img.shape, flat, base_future, timer,
                                        result, t_start, time.time() - t_start))
        for f in fins:
            f.result()
    return results  # type: ignore[return-value]


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
    alone (dtypes: the tap matrices'), else "banded" when its row taps do
    (the raw row taps'), else "gather", which the sweep leaves to
    `encode_image` one config at a time; experts are chunked into groups
    whose staged bytes fit the budget together.  The same packing as
    `_plan_group`'s, without its fixed image bytes: the JAX package's rule
    at the card's budget."""
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
    header_version: int = 1,
    mesh=None,
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
    `header_version` (1 or 0) is every stream's header layout, on every
    path.  With a `mesh` whose "ep" axis is > 1 the rate points fan out
    over its ranks (`_encode_jobs_mesh`), each stream the same bytes.
    Returns one (stream, stats) per config, in order.
    """
    device = resolve_device(device)
    if img.ndim == 2:
        img = img[None]
    C, H, W = img.shape
    if not _experts_compatible(cfgs):
        return [encode_image(img, c, seed, use_fused, device, header_version) for c in cfgs]
    if axis_size(mesh, "ep") > 1:
        return _encode_jobs_mesh([img], [(0, c) for c in cfgs], seed, header_version, mesh,
                                 device, use_fused=use_fused)
    cfg0 = cfgs[0]
    fspec = cfg0.features
    seed = cfg0.train.seed if seed is None else seed
    staging, dtypes, groups, _ = plan_rate_points(img, cfgs)
    if staging == "gather":
        return [encode_image(img, c, seed, use_fused, device, header_version) for c in cfgs]

    results: List[Optional[tuple[bytes, EncodeStats]]] = [None] * len(cfgs)
    dev_img = put_image(img, device)  # one copy for every rate point
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        for grp in groups:
            t0 = time.time()
            timer = PhaseTimer()
            with timer.phase("dispatch"):
                base_futs = [_submit_base(pool, img, cfgs[i].K, cfg0.base_codec, timer)
                             for i in grp]
                result = fit_rate_experts(
                    dev_img, [cfgs[i].K for i in grp], tile_generator(seed, 0),
                    fspec, cfg0.model, cfg0.train, H, W, C,
                    tap_dtypes=[dtypes[i] for i in grp], use_fused=use_fused,
                    staging=staging, device=device, timer=timer,
                )
            with timer.phase("train_wait"):  # blocks on the device result
                flats = [flatten_params(unstack_params(result.params, e),
                                        fspec.feature_dim(C)) for e in range(len(grp))]
            t_train = time.time() - t0
            with timer.phase("finalize"):  # weight coding, base codec wait
                for e, i in enumerate(grp):
                    results[i] = _coded_job(cfgs[i], img.shape, flats[e], base_futs[e], result,
                                            e, t_train / len(grp), t0, header_version)
            for i in grp:  # the group's phases, shared by its points
                results[i][1].phases = dict(timer.phases)
    return results  # type: ignore[return-value]


def _expert_layout(E: int, ep: int) -> tuple[int, int, int]:
    """(rounds, ep_eff, Epad) for fanning E experts over an ep-wide axis
    (the JAX package's rule): ceil(E / ep) rounds are needed regardless, so
    the experts go to the narrowest part of the axis that finishes in that
    many rounds — E = 3 on ep = 8 uses 3 ranks, E = 9 on ep = 8 five ranks
    of two rounds (Epad = 10 slots, one of them spare)."""
    rounds = -(-E // ep)
    ep_eff = -(-E // rounds)
    return rounds, ep_eff, rounds * ep_eff


def _encode_jobs_mesh(
    imgs: List[np.ndarray],
    ijobs: List[tuple[int, CodecConfig]],
    seed: Optional[int],
    header_version: int,
    mesh,
    device: torch.device,
    bucket: bool = False,
    use_fused: Optional[bool] = None,
) -> List[tuple[bytes, EncodeStats]]:
    """(image, K) jobs fanned out as experts over the mesh's "ep" axis
    (`parallel.shard.fit_experts`; kernel K2 on each rank's card), the
    JAX package's `_encode_jobs_mesh`.  `ijobs` are (index into imgs, cfg)
    pairs; the images share one shape, or one bucket with `bucket`
    (padded by `_pad_to_bucket`, per-expert pad masks), and the configs
    differ only in K.  By `_expert_layout`, the rank at ep coordinate r
    trains jobs [r * rounds, (r + 1) * rounds) (the JAX package's spare
    padded slots train nothing here), starts their host base codecs and
    codes their streams (`_coded_job`); the finished streams are gathered
    in job order, so every rank returns all of them.  Each stream is
    `encode_image`'s at the same seed, byte for byte (with `bucket`,
    `encode_image(bucket=True)`'s): every expert trains from
    `tile_generator(seed, 0)` and K2's expert e is K1 on its slices.

    Staging: the experts take "full" taps unless one rank's `rounds`
    experts exceed the budget together, then "banded" row taps (the JAX
    package's downgrade loop over the experts ONE rank holds, where it
    budgets the whole padded stack: a rank stages only its own experts; its
    "cached" mode is "full" here, since K2 reads taps).  Where even banded
    taps exceed it, each rank encodes its jobs with `encode_image` (scalar
    gathers, with a RuntimeWarning), the same bytes."""
    cfgs = [c for _, c in ijobs]
    cfg0 = cfgs[0]
    fspec = cfg0.features
    C, H, W = imgs[0].shape
    dims = [tuple(im.shape[1:]) for im in imgs]
    if bucket:
        H, W = bucket_dims(H, W, fspec.D)
    needs_hws = any(dims[i] != (H, W) for i, _ in ijobs)
    ep, r = axis_size(mesh, "ep"), axis_rank(mesh, "ep")
    E = len(ijobs)
    rounds, _, _ = _expert_layout(E, ep)
    mine = list(range(min(r * rounds, E), min((r + 1) * rounds, E)))
    gen_seed = cfg0.train.seed if seed is None else seed
    maxes = {i: int(imgs[i].max()) for i in sorted({i for i, _ in ijobs})}
    max_msb = max(maxes.values()) >> min(c.K for c in cfgs)
    g = cfg0.train.sample_granule
    per = _staging_bytes(H, W, C, fspec, g, _tap_itemsize(max_msb, fspec.relative),
                         _tap_itemsize(max_msb, False))
    first = {"cached": 0, "full": 0, "banded": 1}.get(
        pick_staging(H, W, C, max_msb, fspec, cfg0.train, warn=False)[0], 2)
    staging = next((mode for mode, b in list(zip(("full", "banded"), per))[first:]
                    if rounds * b <= STAGE_BUDGET_BYTES), "gather")

    def padded(i):
        return _pad_to_bucket(imgs[i], fspec.D, H, W) if dims[i] != (H, W) else imgs[i]

    t0 = time.time()
    done = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        if staging == "gather":
            _warn_gather_fallback(H, W, C)
            for e in mine:
                i, cfg = ijobs[e]
                done.append((e, encode_image(imgs[i], cfg, gen_seed, use_fused, device,
                                             header_version, bucket=bucket)))
        else:
            base_futs = {e: _submit_base(pool, imgs[ijobs[e][0]], ijobs[e][1].K,
                                         cfg0.base_codec)
                         for e in mine}
            mine_imgs = {ijobs[e][0] for e in mine}
            dev_imgs = [put_image(padded(i), device) if i in mine_imgs else None
                        for i in range(len(imgs))]
            dtypes = [row_taps_dtype(maxes[i] >> c.K) if staging == "banded"
                      else tap_matrix_dtype(maxes[i] >> c.K, fspec.relative) for i, c in ijobs]
            result = fit_experts(
                mesh, dev_imgs, [c.K for c in cfgs], tile_generator(gen_seed, 0), fspec,
                cfg0.model, cfg0.train, H, W, C, tap_dtypes=dtypes, use_fused=use_fused,
                staging=staging, img_of=[i for i, _ in ijobs],
                hws=[dims[i] for i, _ in ijobs] if needs_hws else None, device=device,
            )
            t_train = time.time() - t0
            for e in mine:
                i, cfg = ijobs[e]
                flat = flatten_params(unstack_params(result.params, e), fspec.feature_dim(C))
                done.append((e, _coded_job(cfg, (C,) + dims[i], flat, base_futs[e], result, e,
                                           t_train / len(mine), t0, header_version)))
    results = dict(kv for part in collect_objects(done, mesh.get_group("ep")) for kv in part)
    return [results[e] for e in range(E)]


def encode_dataset(
    jobs: List[tuple[np.ndarray, CodecConfig]],
    seed: Optional[int] = None,
    header_version: int = 1,
    mesh=None,
    max_experts: int = 16,
    bucket: bool = False,
    device=None,
) -> List[tuple[bytes, EncodeStats]]:
    """Encode a dataset of (image, cfg) jobs with cross-image expert
    batching (the reference's run.sh workload: many images x many K).

    Experts are (image, K) pairs: jobs of one shape and one
    config-modulo-K train together (`fit_rate_experts` with `img_of`;
    kernel K2 on the card) in chunks of up to `max_experts` networks whose
    staged taps fit the budget, label stores shared per image, each chunk's
    host base codecs in a pool of 4 while it trains, and its weight coding
    while the next chunk trains.  A group with one rate point per image
    goes through `encode_pipelined`; jobs without a partner (a unique
    shape or config) too, and each of those streams is byte-identical to
    `encode_image`'s.  Results come back in job order.  Each expert is
    bit-identical to `fit` on its image and K, so every stream is
    `encode_image`'s at the same seed, chunked or not.  An expert-batched
    job's `EncodeStats.plan` is the `GroupPlan` its group ran (staging,
    chunks, budget); None on the other paths.

    Seeds: with ``seed=None`` every job trains from
    ``tile_generator(cfg.train.seed, 0)``, as `encode_image(img, cfg)`
    does.  With an explicit seed, every job of a group trains from
    ``tile_generator(seed, 0)`` whatever path the group takes (expert
    chunks, the pipelined one-job-per-image path, or the per-job path of
    a group whose taps exceed every staging budget), so a job's bytes do
    not depend on how other jobs grouped; a partner-less job j encodes as
    ``encode_image(img, cfg, seed=job_seed(seed, j))``, j its index in
    `jobs`.

    ``bucket=True`` groups by bucket shape (`bucket_dims`) instead of
    exact shape, for colour features without coordinates (as
    `encode_image(bucket=True)` gates it): images of one bucket are padded
    (`_pad_to_bucket`) and train together with per-expert pad masks
    (`fit_rate_experts(hws=)`); each stream is then
    `encode_image(bucket=True)`'s.  `device=None` means CUDA.

    `mesh`: with an "ep" axis > 1 every group of two or more jobs fans out
    over the axis in chunks (`_encode_jobs_mesh`), the JAX package's rule:
    up to max(max_experts, ep) jobs a chunk, 5 x Hb x Wb x C bytes a job
    within STAGE_BUDGET_BYTES; the streams are the same bytes as without
    the mesh.  Partner-less jobs encode on every rank as without it.
    """
    device = resolve_device(device)
    njobs = [(img[None] if img.ndim == 2 else img, cfg) for img, cfg in jobs]
    if any(cfg.base_codec == "jp2" for _, cfg in njobs):
        require_cv2()

    def bucket_ok(cfg) -> bool:
        return bucket and cfg.features.use_colors and not cfg.features.use_coords

    def same_group(img, cfg, img0, cfg0) -> bool:
        if not _experts_compatible([cfg0, cfg]):
            return False
        if img.shape == img0.shape:
            return True
        if not (bucket_ok(cfg) and img.shape[0] == img0.shape[0]):
            return False
        D = cfg.features.D
        return bucket_dims(*img.shape[1:], D) == bucket_dims(*img0.shape[1:], D)

    # group job indices by (shape or bucket, config modulo K)
    groups: List[List[int]] = []
    for j, (img, cfg) in enumerate(njobs):
        for grp in groups:
            if same_group(img, cfg, *njobs[grp[0]]):
                grp.append(j)
                break
        else:
            groups.append([j])

    results: List[Optional[tuple[bytes, EncodeStats]]] = [None] * len(njobs)
    singles = [grp[0] for grp in groups if len(grp) == 1]
    for grp in groups:
        if len(grp) > 1:
            gres = _encode_job_group([njobs[j] for j in grp], seed, header_version,
                                     max_experts, bucket_ok(njobs[grp[0]][1]), device, mesh)
            for j, r in zip(grp, gres):
                results[j] = r
    if singles:
        seeds = None if seed is None else [job_seed(seed, j) for j in singles]
        for j, r in zip(singles, encode_pipelined([njobs[j] for j in singles], None,
                                                  header_version, bucket, seeds, device)):
            results[j] = r
    return results  # type: ignore[return-value]


@dataclasses.dataclass
class GroupPlan:
    """How `_encode_job_group` trains one group: the shape every expert
    trains at (a bucket's with `bucket`), the real (height, width) per
    unique image, the staging mode, each expert's tap dtype and staged
    bytes, the budget every chunk's staging and images fit, and the chunks
    (lists of expert indices)."""

    H: int
    W: int
    dims: List[tuple]
    staging: str
    dtypes: list
    per_expert: List[int]
    budget: int
    chunks: List[List[int]]


def _plan_group(uniq: List[np.ndarray], ijobs: List[tuple], bucket: bool,
                max_experts: int) -> Optional[GroupPlan]:
    """The plan for one expert group: the JAX package's rule (its codec.py
    `_encode_job_group`) at the card's budget, without its two TPU fences
    (a halved budget for a group of several chunks, one expert a chunk for
    Gaofen-sized scenes).  "full" tap staging when every expert's tap
    matrix fits the budget alone, else "banded", else None (the group is
    encoded job by job); chunks pack whole images' experts, up to
    `max_experts` and within the budget with each image's uint16 image and
    label store, and an image whose experts overflow the budget splits by
    it.  The chunks train one after another (each fit ends on its last
    eval's sync), so each may take the whole budget; chunking never
    changes a stream's bytes."""
    C, H, W = uniq[0].shape
    cfg0 = ijobs[0][1]
    fspec = cfg0.features
    g = cfg0.train.sample_granule
    maxes = [int(im.max()) for im in uniq]
    dims = [tuple(im.shape[1:]) for im in uniq]
    if bucket:
        H, W = bucket_dims(H, W, fspec.D)
    sizes = [
        _staging_bytes(H, W, C, fspec, g, _tap_itemsize(maxes[i] >> c.K, fspec.relative),
                       _tap_itemsize(maxes[i] >> c.K, False))
        for i, c in ijobs
    ]
    budget = STAGE_BUDGET_BYTES
    if max(s[0] for s in sizes) <= budget:
        staging, per_expert = "full", [s[0] for s in sizes]
        dtypes = [tap_matrix_dtype(maxes[i] >> c.K, fspec.relative) for i, c in ijobs]
    elif max(s[1] for s in sizes) <= budget:
        staging, per_expert = "banded", [s[1] for s in sizes]
        dtypes = [row_taps_dtype(maxes[i] >> c.K) for i, c in ijobs]
    else:
        return None
    per_image_fixed = 4 * H * W * C  # uint16 image + label store
    # pack whole images (their experts stay adjacent); an image whose own
    # experts overflow splits by budget
    by_img: dict = {}
    for e, (i, _) in enumerate(ijobs):
        by_img.setdefault(i, []).append(e)
    units: List[List[int]] = []
    for es in by_img.values():
        span: List[int] = []
        acc = per_image_fixed
        for e in es:
            if span and (len(span) >= max_experts or acc + per_expert[e] > budget):
                units.append(span)
                span, acc = [], per_image_fixed
            span.append(e)
            acc += per_expert[e]
        units.append(span)
    chunks: List[List[int]] = [[]]
    acc = 0
    for span in units:
        cost = per_image_fixed + sum(per_expert[e] for e in span)
        if chunks[-1] and (len(chunks[-1]) + len(span) > max_experts or acc + cost > budget):
            chunks.append([])
            acc = 0
        chunks[-1].extend(span)
        acc += cost
    return GroupPlan(H, W, dims, staging, dtypes, per_expert, budget, chunks)


def _encode_job_group(
    gjobs: List[tuple[np.ndarray, CodecConfig]],
    seed: Optional[int],
    header_version: int,
    max_experts: int,
    bucket: bool,
    device: torch.device,
    mesh=None,
) -> List[tuple[bytes, EncodeStats]]:
    """Expert-batch one compatible group of (image, cfg) jobs (one shape,
    or one bucket with `bucket`; configs differing only in K).  See
    `encode_dataset`."""
    # dedup images by identity: the rate points of one image share it
    uniq: List[np.ndarray] = []
    idmap: dict = {}
    ijobs: List[tuple[int, CodecConfig]] = []
    for img, cfg in gjobs:
        if id(img) not in idmap:
            idmap[id(img)] = len(uniq)
            uniq.append(img)
        ijobs.append((idmap[id(img)], cfg))
    if axis_size(mesh, "ep") > 1:
        # chunks bounded as the JAX package bounds them: ~5x (plane + labels)
        # bytes a job, at most max(max_experts, ep) jobs
        C0, H0, W0 = uniq[0].shape
        Hb, Wb = bucket_dims(H0, W0, gjobs[0][1].features.D) if bucket else (H0, W0)
        per = 5 * Hb * Wb * C0
        cap = max(max_experts, axis_size(mesh, "ep"))
        mchunks: List[List[tuple[int, CodecConfig]]] = [[]]
        acc = 0
        for j in ijobs:
            if mchunks[-1] and (len(mchunks[-1]) >= cap or acc + per > STAGE_BUDGET_BYTES):
                mchunks.append([])
                acc = 0
            mchunks[-1].append(j)
            acc += per
        return [r for ch in mchunks
                for r in _encode_jobs_mesh(uniq, ch, seed, header_version, mesh, device, bucket)]
    # every path of the group trains from the group's draws (the seed contract)
    seeds = None if seed is None else [seed] * len(gjobs)
    # one job per image (a single-rate-point dataset): per-job fits stage
    # the fastest way (the f32 feature cache) and no upload is shared, so
    # the pipelined path wins (JAX package: 0.63 against 1.03 s a job)
    if len(ijobs) == len(uniq):
        return encode_pipelined(gjobs, None, header_version, bucket, seeds, device)
    plan = _plan_group(uniq, ijobs, bucket, max_experts)
    if plan is None:  # even banded taps exceed the budget: job by job
        return encode_pipelined(gjobs, None, header_version, bucket, seeds, device)

    C = uniq[0].shape[0]
    H, W, dims = plan.H, plan.W, plan.dims
    cfg0 = gjobs[0][1]
    fspec = cfg0.features
    gen_seed = cfg0.train.seed if seed is None else seed
    needs_hws = any(d != (H, W) for d in dims)
    results: List[Optional[tuple[bytes, EncodeStats]]] = [None] * len(gjobs)

    def finalize(chunk, flats, result, base_futs, t0, t_train):
        for e, j in enumerate(chunk):
            i, cfg = ijobs[j]
            results[j] = _coded_job(cfg, (C,) + dims[i], flats[e], base_futs[e], result, e,
                                    t_train / len(chunk), t0, header_version)
            results[j][1].plan = plan

    # the expert loop evaluates expert by expert, one row block at a time,
    # so the JAX package's EVAL_UNROLL_PX switch has no counterpart here
    dev_cache: dict = {}  # image index -> device copy, kept across chunks
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as fin_pool:
        fins = []  # (chunk, its timer, its finalize future)
        for chunk in plan.chunks:
            t0 = time.time()
            timer = PhaseTimer()  # the phases `encode_rate_points` records
            with timer.phase("dispatch"):
                c_imgs = sorted({ijobs[j][0] for j in chunk})
                for stale in [i for i in dev_cache if i not in c_imgs]:
                    del dev_cache[stale]
                for i in c_imgs:
                    if i not in dev_cache:
                        im = uniq[i]
                        if dims[i] != (H, W):
                            im = _pad_to_bucket(im, fspec.D, H, W)
                        dev_cache[i] = put_image(im, device)
                base_futs = [_submit_base(pool, uniq[ijobs[j][0]], ijobs[j][1].K,
                                          cfg0.base_codec, timer)
                             for j in chunk]
                result = fit_rate_experts(
                    tuple(dev_cache[i] for i in c_imgs), [ijobs[j][1].K for j in chunk],
                    tile_generator(gen_seed, 0), fspec, cfg0.model, cfg0.train, H, W, C,
                    tap_dtypes=[plan.dtypes[j] for j in chunk], staging=plan.staging,
                    img_of=[c_imgs.index(ijobs[j][0]) for j in chunk],
                    hws=[dims[ijobs[j][0]] for j in chunk] if needs_hws else None,
                    device=device, timer=timer,
                )
            # the fit ended on its last eval's sync: fetch before the next
            # chunk's steps are queued behind these copies
            with timer.phase("train_wait"):
                flats = [flatten_params(unstack_params(result.params, e), fspec.feature_dim(C))
                         for e in range(len(chunk))]
            fins.append((chunk, timer, fin_pool.submit(finalize, chunk, flats, result,
                                                       base_futs, t0, time.time() - t0)))
        for chunk, timer, f in fins:
            with timer.phase("finalize"):  # weight coding, base codec wait
                f.result()
            for j in chunk:  # the chunk's phases, shared by its points
                results[j][1].phases = dict(timer.phases)
    return results  # type: ignore[return-value]


def _dispatch_decode(data: bytes, pt: PhaseTimer, device: torch.device, mesh=None):
    """Header parse, then per tile: base decode, weight decode and the
    device residual dispatch.  Returns (header, finishes), one zero-arg
    finish() per tile that fetches and assembles it.  A row-chunked (v2)
    `lpc` base of a colour-only stream takes the streamed path instead
    (`dispatch_streamed_lpc`, phase "dispatch_pipelined"): its chunks decode
    on the host while the device computes the bands already decoded.

    With a `mesh` whose "dp" axis sp > 1 the streamed path is skipped, and
    a tile of th rows with th % sp == 0 and th // sp > D decodes in row
    bands over the axis (`parallel.halo.reconstruct_sp`), the others on
    this rank alone.  `reconstruct_sp` holds collectives, so it runs in the
    tile's finish(), on the caller's thread in stream order, never in a
    dispatch worker."""
    from lbdrn_msic_tpu_torch.codecs import lpc
    from lbdrn_msic_tpu_torch.decode.reconstruct import (
        dispatch_streamed,
        dispatch_streamed_lpc,
    )

    header = decode_header(data)
    ptr = header_size(data)
    fspec = header.feature_spec()
    mspec = header.model_spec()
    sp = axis_size(mesh, "dp")
    pending = []
    for t in range(header.n_tiles):
        nn = data[ptr : ptr + header.nn_bytes[t]]
        ptr += header.nn_bytes[t]
        base_stream = data[ptr : ptr + header.base_bytes[t]]
        ptr += header.base_bytes[t]
        # a v0 header has no codec field: the payload's magic names it
        codec_name = header.base_codec if header.version else payload_codec(base_stream)
        # every tile, as the JAX package's decode without a mesh (its `sp == 1`
        # guard is the mesh's data-parallel width, not the split ratio)
        if codec_name == "lpc" and sp == 1 and not fspec.use_coords:
            info = lpc.chunk_info(base_stream)  # a header peek before any weight work
            if info is not None and info[5] > 1:  # None: a v1 (one-chunk) stream
                with pt.phase("dispatch_pipelined"):
                    C = info[0]
                    flat = decompress_weights(nn, header.weight_codec)
                    params = unflatten_params(flat, fspec.feature_dim(C), C, mspec,
                                              device=device)
                    got = dispatch_streamed_lpc(base_stream, params, fspec, mspec, header.K,
                                                device)
                if got is not None:
                    pending.append(got[1])
                    continue
        with pt.phase("base_decode"):
            base = decode_base(base_stream, codec_name)
        C, th, _ = base.shape
        with pt.phase("dispatch"):
            flat = decompress_weights(nn, header.weight_codec)
            params = unflatten_params(flat, fspec.feature_dim(C), C, mspec, device=device)
            if sp > 1 and th % sp == 0 and th // sp > fspec.D:
                pending.append(functools.partial(reconstruct_sp, mesh, base, params, fspec,
                                                 mspec, header.K, device))
            else:
                pending.append(dispatch_streamed(base, params, fspec, mspec, header.K, device))
    return header, pending


def _finalize_decode(header, pending, pt) -> np.ndarray:
    with pt.phase("fetch_assemble"):
        tiles = [finish() for finish in pending]
        return merge_tiles(tiles, header.height, header.width, header.split_ratio)


def decode_stream(data: bytes, device=None, mesh=None) -> tuple[np.ndarray, DecodeStats]:
    """bitstream -> ((C, H, W) uint16 image, stats).  `device=None` means
    CUDA.  `mesh`: a "dp" axis > 1 decodes each tile in row bands over its
    ranks (`_dispatch_decode`), bit-identical to the single-card decode."""
    device = resolve_device(device)
    t0 = time.time()
    pt = PhaseTimer()
    with torch.no_grad():
        header, pending = _dispatch_decode(data, pt, device, mesh)
        img = _finalize_decode(header, pending, pt)
    return img, DecodeStats(elapsed=time.time() - t0, header=header, phases=dict(pt.phases))


# decode-ahead budget: decoded bases and outputs of the streams dispatched
# beyond the one being finalized (`decode_pipelined_iter`); host bytes,
# not the card's
DECODE_AHEAD_BYTES = 6 << 30


def decode_pipelined_iter(streams, mesh=None, ahead: int = 2, device=None):
    """Decode an iterable of bitstreams with cross-stream pipelining: one
    dispatch worker runs the host base and weight decodes and the device
    dispatch of the streams up to `ahead` past the one the caller's thread
    fetches and assembles.  The worker is one thread, so the device work is
    queued in stream order; results yield in order, bit-identical to
    `decode_stream`.  At most `ahead` + 1 streams are live, and the next
    dispatch waits while the estimate of in-flight host bytes (8 bytes a
    pixel, read from each header) exceeds DECODE_AHEAD_BYTES.  `mesh` as
    `decode_stream` takes it: the row-band decodes and their collectives
    run in the caller's thread as each stream is finalized, in stream
    order on every rank.  `device=None` means CUDA."""
    import collections

    device = resolve_device(device)
    it = iter(streams)
    inflight = collections.deque()  # (t0, timer, future, estimated bytes)
    live_bytes = 0

    def est_bytes(data: bytes) -> int:
        h = decode_header(data)
        return h.width * h.height * 8

    def dispatch(data, pt):
        with torch.no_grad():  # grad mode is per thread
            return _dispatch_decode(data, pt, device, mesh)

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:

        def submit_next() -> bool:
            nonlocal live_bytes
            data = next(it, None)
            if data is None:
                return False
            pt = PhaseTimer()
            b = est_bytes(data)
            inflight.append((time.time(), pt, pool.submit(dispatch, data, pt), b))
            live_bytes += b
            return True

        more = submit_next()  # depth 1 is unconditional
        while more and len(inflight) <= ahead and live_bytes <= DECODE_AHEAD_BYTES:
            more = submit_next()
        while inflight:
            t0, pt, fut, b = inflight.popleft()
            with pt.phase("dispatch_wait"):
                header, fins = fut.result()
            img = _finalize_decode(header, fins, pt)
            live_bytes -= b
            while more and len(inflight) <= ahead and live_bytes <= DECODE_AHEAD_BYTES:
                more = submit_next()
            yield img, DecodeStats(elapsed=time.time() - t0, header=header,
                                   phases=dict(pt.phases))


def decode_pipelined(streams: List[bytes], mesh=None,
                     device=None) -> List[tuple[np.ndarray, DecodeStats]]:
    """List form of `decode_pipelined_iter`."""
    return list(decode_pipelined_iter(streams, mesh, device=device))
