"""The benchmark's one traffic generator.

A mix is a data file, `benchmark/traffic/<mix>.json`, read here; a
configuration is `benchmark/configs/<config>.json`.  From them and the
run's seed this module makes the scenes (the frozen `synth_scene`), the
codec configurations and the jobs, and runs a job through the port's codec
entry that the mix names:

- ``rate_points``: one scene at every K of ``ks`` (`encode_rate_points`);
- ``dataset``: ``scenes_per_job`` scenes at every K of ``ks`` in one call
  (`encode_dataset`);
- ``image``: one scene at ``ks[0]`` (`encode_image`);
- ``decode``: set-up encodes ``streams`` streams, scene ``i % scenes`` at
  ``ks[i % len(ks)]`` with ``setup_epochs`` epochs; the window decodes
  them round robin through `decode_pipelined_iter` (``ahead``), a stream
  a job.

Jobs of an encode mix take the pool's scenes in turn.  Every seed makes
the same sizes, the same number of scenes and the same jobs; only the
pixel values differ.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import List, Optional

import numpy as np

from reference.frozen import synth_scene

ENTRIES = ("rate_points", "dataset", "image", "decode")
# every key a mix may hold (benchmark/README.md says what each does)
TRAFFIC_KEYS = ("entry", "ks", "scenes", "scenes_per_job", "sample_jobs", "trace_jobs",
                "streams", "setup_epochs", "ahead", "sample_points", "sample_range",
                "host_threads")
# configuration keys that describe the scene and the record, not the codec
HARNESS_KEYS = ("bands", "effective_bits", "scene_rows", "scene_cols", "dtype", "deployment",
                "source_values", "assumed")


def seeds_of(seed: int, n: int, salt: int) -> List[int]:
    """n 32-bit seeds drawn from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), salt])
    return [int(s) for s in ss.generate_state(n, np.uint32)]


@dataclasses.dataclass
class Point:
    """One (scene, K) output of a job: its stream and the entry's stats."""
    scene: int
    K: int
    stream: bytes
    stats: object = None


@dataclasses.dataclass
class Job:
    index: int
    t0: float
    t1: float
    points: List[Point]
    phases: Optional[dict]  # the entry's host phases, summed over the job
    decoded: Optional[np.ndarray] = None  # a decode job's output, where kept
    steps: Optional[tuple] = None  # (training steps taken, the configuration's)
    kept: bool = False  # its first and last steps were kept for the judge


class Mix:
    """A cell's traffic: its scenes, its configurations and its jobs."""

    def __init__(self, traffic: dict, config: dict, seed: int, device):
        if traffic["entry"] not in ENTRIES:
            raise ValueError(f"unknown entry {traffic['entry']!r}; known: {ENTRIES}")
        unknown = set(traffic) - set(TRAFFIC_KEYS)
        if unknown:
            raise ValueError(f"traffic keys {sorted(unknown)} are read by nothing; known: "
                             f"{TRAFFIC_KEYS}")
        self.t, self.c, self.seed, self.device = traffic, config, seed, device
        self.entry = traffic["entry"]
        self.ks = list(traffic["ks"])
        self.encoder_seed = seeds_of(seed, 1, 1)[0]
        if config.get("split_ratio", 1) != 1:
            raise ValueError("split_ratio > 1: the judge reads one tile a stream; a tiled cell "
                             "needs it to read every tile")
        self.codec_config(self.ks[0])  # an unknown configuration key fails here
        self.scenes: List[np.ndarray] = []
        self.streams: List[Point] = []

    # ---------------------------------------------------------- set-up
    def shape(self):
        return (self.c["bands"], self.c["scene_rows"], self.c["scene_cols"])

    def make_scenes(self):
        C, H, W = self.shape()
        n = int(self.t["scenes"])
        seeds = seeds_of(self.seed, n, 0)
        with concurrent.futures.ThreadPoolExecutor(max_workers=min(n, 4)) as pool:
            self.scenes = list(pool.map(
                lambda s: synth_scene(H, W, C, self.c["effective_bits"], seed=s, fast=True),
                seeds))

    def codec_config(self, K: int, epochs: Optional[int] = None):
        """The port's CodecConfig at K: every key of the configuration file
        that names a field of CodecConfig, ModelSpec, FeatureSpec or
        TrainSpec goes there; the benchmark's own keys (HARNESS_KEYS) are
        the scene's; any other key is refused."""
        from lbdrn_msic_tpu_torch.core.config import (CodecConfig, FeatureSpec, ModelSpec,
                                                      TrainSpec)
        parts = {"cfg": {}, "model": {}, "features": {}, "train": {}}
        fields = {name: {f.name for f in dataclasses.fields(cls)} for name, cls in
                  (("model", ModelSpec), ("features", FeatureSpec), ("train", TrainSpec))}
        fields["cfg"] = {f.name for f in dataclasses.fields(CodecConfig)} - {
            "K", "model", "features", "train"}
        for key, val in self.c.items():
            if key in HARNESS_KEYS:
                continue
            where = [name for name, names in fields.items() if key in names]
            if len(where) != 1:
                raise ValueError(f"configuration key {key!r} names no single field of the "
                                 f"port's CodecConfig; the benchmark's own: {HARNESS_KEYS}")
            parts[where[0]][key] = val
        if epochs is not None:
            parts["train"]["epochs"] = epochs
        return CodecConfig(K=K, model=ModelSpec(**parts["model"]),
                           features=FeatureSpec(**parts["features"]),
                           train=TrainSpec(**parts["train"]), **parts["cfg"])

    def setup(self):
        """Scenes, and for a decode mix its streams (encoded here)."""
        self.make_scenes()
        if self.entry == "decode":
            from lbdrn_msic_tpu_torch.codec import encode_pipelined
            n = int(self.t["streams"])
            jobs = [(self.scenes[i % len(self.scenes)],
                     self.codec_config(self.ks[i % len(self.ks)], self.t["setup_epochs"]))
                    for i in range(n)]
            seeds = seeds_of(self.seed, n, 2)
            out = encode_pipelined(jobs, seeds=seeds, device=self.device)
            self.streams = [Point(i % len(self.scenes), self.ks[i % len(self.ks)], s)
                            for i, (s, _) in enumerate(out)]

    # ---------------------------------------------------------- encode jobs
    def job_inputs(self, j: int) -> list:
        """(scene index, K) of every point of encode job j."""
        n = len(self.scenes)
        if self.entry == "dataset":
            per = int(self.t["scenes_per_job"])
            first = (j * per) % n
            return [((first + s) % n, K) for s in range(per) for K in self.ks]
        if self.entry == "image":
            return [(j % n, self.ks[0])]
        return [(j % n, K) for K in self.ks]

    def run_encode(self, j: int, epochs: Optional[int] = None) -> Job:
        from lbdrn_msic_tpu_torch import codec

        ins = self.job_inputs(j)
        t0 = time.time()
        if self.entry == "rate_points":
            img = self.scenes[ins[0][0]]
            res = codec.encode_rate_points(img, [self.codec_config(K, epochs) for _, K in ins],
                                           seed=self.encoder_seed, device=self.device)
        elif self.entry == "image":
            img = self.scenes[ins[0][0]]
            res = [codec.encode_image(img, self.codec_config(ins[0][1], epochs),
                                      seed=self.encoder_seed, device=self.device)]
        else:
            res = codec.encode_dataset(
                [(self.scenes[s], self.codec_config(K, epochs)) for s, K in ins],
                seed=self.encoder_seed, device=self.device)
        t1 = time.time()
        points = [Point(s, K, stream, stats) for (s, K), (stream, stats) in zip(ins, res)]
        return Job(j, t0, t1, points, _job_phases(self.entry, res))


def _job_phases(entry: str, res) -> Optional[dict]:
    """The entry's host phases over the whole job: a rate sweep copies its
    group's phases to each of the group's points, so equal copies count
    once; `encode_dataset` records none."""
    seen, out = set(), {}
    for _, stats in res:
        ph = stats.phases
        key = tuple(sorted((ph or {}).items()))
        if not ph or key in seen:
            continue
        seen.add(key)
        for k, v in ph.items():
            out[k] = out.get(k, 0.0) + v
    return out or None
