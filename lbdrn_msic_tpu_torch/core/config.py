"""Typed configuration for the codec.

Single source of truth for every knob the reference spreads over argparse
(reference encode.py:168-196) and hand-edited module globals
(reference constants.py:1-14).  Unlike the reference — where the decoder
silently depends on `constants.py` matching its state at encode time — the
feature-set switches here are serialized into the bitstream header
(io/header.py), so a stream is always self-describing.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Feature construction switches (reference constants.py:1-14).

    The per-pixel input vector is the concatenation of:
    - optional normalized coordinates in [-1, 1] (+ optional sin/cos
      positional embedding with ``n_freq`` frequencies scaled by
      ``sigma**k * pi``),
    - optional (2D+1)^2 MSB neighborhoods per band, max-normalized and
      (optionally) center-subtracted ("relative colors").
    """

    use_coords: bool = False
    embedding: bool = False
    sigma: float = 1.4
    n_freq: int = 12
    use_colors: bool = True
    relative: bool = True
    D: int = 2  # neighborhood radius: (2D+1)^2 taps per band

    def num_coord_features(self) -> int:
        if not self.use_coords:
            return 0
        per_axis = 1 + 2 * self.n_freq * int(self.embedding)
        return 2 * per_axis

    def num_color_features(self, channels: int) -> int:
        if not self.use_colors:
            return 0
        return channels * (2 * self.D + 1) ** 2

    def feature_dim(self, channels: int) -> int:
        return self.num_coord_features() + self.num_color_features(channels)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """SIREN MLP shape (reference LBDRNmodel.py:46-82).

    ``num_layers`` hidden SIREN layers of width ``base_channel`` followed by
    a final layer with sigmoid activation; w0=30 throughout.
    """

    base_channel: int = 64
    num_layers: int = 2
    w0: float = 30.0
    w0_initial: float = 30.0
    c: float = 6.0

    def __post_init__(self):
        if self.base_channel < 1 or (self.base_channel & (self.base_channel - 1)):
            raise ValueError(
                f"base_channel must be a power of two for header packing "
                f"(got {self.base_channel})"
            )
        if not (0 < self.num_layers <= 15):
            raise ValueError(f"num_layers must be in 1..15 (got {self.num_layers})")

    def param_count(self, dim_in: int, dim_out: int) -> int:
        bc = self.base_channel
        n = (dim_in + 1) * bc
        for _ in range(self.num_layers - 1):
            n += (bc + 1) * bc
        n += (bc + 1) * dim_out
        return n

    def log2_bc(self) -> int:
        return int(math.log2(self.base_channel))


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Overfit-loop hyperparameters (reference encode.py:168-196 defaults)."""

    lr: float = 1e-3
    batch_size: int = 8192
    epochs: int = 10
    val_every: int = 1  # reference -vd/--val_duration
    seed: int = 19920517
    # StepLR: lr *= gamma every `max(1, epochs // 3)` epochs
    # (reference encode.py:85).
    lr_gamma: float = 0.1
    # Sampling granule: batches are built from g-pixel runs instead of
    # single pixels.  g=1 is the reference's exact uniform pixel shuffle;
    # g>1 trades a slightly correlated batch for g-fold fewer (g-fold
    # larger) gather descriptors on TPU.  batch_size must divide by it.
    sample_granule: int = 1
    # LR schedule: "step" is the reference's StepLR (lr *= 0.1 every
    # epochs//3 epochs, encode.py:85) — by epoch 9 of a 10-epoch run the
    # LR is 1e-6 and training is effectively frozen.  "cosine" anneals
    # smoothly to 0 over all steps; it changes nothing about the bitstream
    # (the weights are the stream) and is the default of the TPU recipe
    # (scripts/recipe_study.py quantifies the RD gain).
    schedule: str = "step"

    def __post_init__(self):
        if self.schedule not in ("step", "cosine"):
            raise ValueError(f"unknown LR schedule {self.schedule!r}")

    def lr_step_size(self) -> int:
        return max(1, self.epochs // 3)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Full per-run codec configuration."""

    K: int = 5  # number of dropped LSBs, the rate knob (1..11)
    split_ratio: int = 1  # spatial tiling: sr x sr independent tiles
    precision: int = 16  # weight-codec retained bits (reference -prec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    features: FeatureSpec = dataclasses.field(default_factory=FeatureSpec)
    train: TrainSpec = dataclasses.field(default_factory=TrainSpec)
    base_codec: str = "jp2"  # 'jp2' (OpenJPEG lossless) | 'lpc' (native C++)
    weight_codec: str = "fpz"  # 'fpz' (native C++ predictive float codec)

    def __post_init__(self):
        if not (1 <= self.K <= 15):
            raise ValueError(f"K must be in 1..15 (4-bit header field), got {self.K}")
        if not (0 <= self.features.D <= 15):
            raise ValueError(f"D must be in 0..15 (4-bit header field), got {self.features.D}")
        if not (1 <= self.split_ratio <= 255):
            raise ValueError(f"split_ratio must fit one byte, got {self.split_ratio}")

    def run_name(self, image_stem: str) -> str:
        """Output directory naming scheme, format-compatible with the
        reference's run dirs (reference encode.py:210-213).  Non-reference
        knobs (the cosine schedule) append a suffix so default runs keep
        reference-identical names."""
        t = self.train
        name = (
            f"{image_stem}_r{self.split_ratio}_K{self.K}"
            f"_bc{self.model.base_channel}_nl{self.model.num_layers}"
            f"_D{self.features.D}_prec{self.precision}"
            f"_lr{t.lr}_bs{t.batch_size}_e{t.epochs}"
        )
        if t.schedule != "step":
            name += f"_{t.schedule}"
        if t.sample_granule != 1:
            name += f"_g{t.sample_granule}"
        return name


BASE_CODEC_IDS = {"jp2": 0, "lpc": 1}
BASE_CODEC_NAMES = {v: k for k, v in BASE_CODEC_IDS.items()}
WEIGHT_CODEC_IDS = {"fpz": 0, "raw16": 1}
WEIGHT_CODEC_NAMES = {v: k for k, v in WEIGHT_CODEC_IDS.items()}
