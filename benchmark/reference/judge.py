"""What decides `correct`: the port's outputs of the window held against
the plain reference (`plain.py`, `stream.py`), number by number, each
against its limit in `benchmark/limits/<workload>.json`.

The numbers (the limits file holds the ones a cell compares):

- ``header_wrong``: header fields that differ from the configuration, and
  weight payloads whose length is not the network's (exact, limit 0);
- ``msb_wrong``: sub-pixels of the program's decode whose MSBs differ from
  the scene's (the base layer is lossless: exact, limit 0);
- ``flip_share``: the largest share, over the judged streams, of
  sub-pixels where the program's decode differs from the reference's
  decode of the same stream (features, forward, rounding);
- ``steps_wrong``: training steps of the window's jobs that the
  configuration's epochs and batch do not account for, missing or extra
  (exact, limit 0);
- ``steps_unkept``: of the jobs picked for the replay, the first three and
  last three steps that the tap did not keep (a job trained by steps the
  tap cannot see; exact, limit 0);
- ``rows_live_wrong``: live rows of the kept batches beyond what the
  configuration's batch gives that step (the batch size, or the epoch's
  remainder), or short of it (exact, limit 0);
- ``rows_repeated``: live rows of a kept batch that repeat a (features,
  labels) row more often than the job's scenes hold it (exact, limit 0);
- ``evals_wrong``: points of the window's jobs whose reported best MSE
  and best epoch are not the first minimum of one of the evals the
  program read (one series a fit and expert, one eval an epoch), or that
  series has another number of evals than the configuration's epochs
  give (exact, limit 0);
- ``eval_mse_gap``: the largest relative gap, over the judged points,
  between the best MSE the program reports (the eval that chose the
  stream's network) and the reference's MSE of the stream's network over
  the whole scene;
- ``init_wrong``: init entries outside the init scheme (exact, limit 0);
- ``rows_foreign``: rows of the kept batches that are no (features,
  labels) row of the job's scenes (exact, limit 0);
- ``step_loss_gap``: the largest relative gap between the loss of one of
  the first three steps and the reference's loss on the same state and
  batch;
- ``late_loss_gap``: the same of the fit's last three steps, on the
  program's own state there (the reference cannot follow the thousands of
  steps between: `steps_wrong` counts them);
- ``step_grad_gap``: the first step's gradient as the optimizer got it
  (its first moment / 0.1), the worst leaf's gap of norms against the
  reference's, over the larger of that leaf's and the median leaf's norm;
- ``step_change_gap``: the parameters' change over the three steps
  against the reference's own three steps from the same init, measured
  alike, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import plain
from reference.stream import lfpz_decode, parse_header, tile_weights

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median's


def batch_geometry(c: dict) -> dict:
    """The configuration's batches over a flat granule grid (the program's
    grid wherever the granule divides the width): pixels n, batch bs,
    granule g, granules n_g and a batch bpg, steps an epoch."""
    n = c["scene_rows"] * c["scene_cols"]
    bs = min(c["batch_size"], n)
    g = c["sample_granule"] if bs % c["sample_granule"] == 0 else 1
    n_g, bpg = -(-n // g), bs // g
    return {"n": n, "bs": bs, "g": g, "n_g": n_g, "bpg": bpg, "steps": -(-n_g // bpg)}


def live_rows_off(geo: dict, t: int, live: int) -> int:
    """How far a batch's live rows at Adam step t lie outside what the
    configuration gives that step: whole granules, the last granule of the
    grid short by its padding."""
    s = (t - 1) % geo["steps"]
    full = min(geo["bpg"], geo["n_g"] - s * geo["bpg"]) * geo["g"]
    slack = geo["n_g"] * geo["g"] - geo["n"]
    return max(live - full, full - slack - live, 0)


def expected_header(c: dict, K: int, shape) -> dict:
    C, H, W = shape
    return {"split_ratio": c.get("split_ratio", 1), "width": W, "height": H, "K": K, "D": c["D"],
            "base_channel": c["base_channel"], "num_layers": c["num_layers"],
            "use_coords": False, "embedding": False, "use_colors": True,
            "relative": c["relative"], "weight_codec": c["weight_codec"],
            "base_codec": c["base_codec"], "precision": c["precision"]}


def judge_streams(mix, kept, device, control: bool = False) -> tuple:
    """(numbers, failed items) of the kept (point, program decode) pairs.
    `control`: the reference decode in bfloat16 takes the program's place."""
    c = mix.c
    dims = plain.feature_dims(c["bands"], c["D"], c["base_channel"], c["num_layers"])
    top_k = max(mix.ks)
    n = {"header_wrong": 0, "msb_wrong": 0, "flip_share": 0.0}
    if mix.entry != "decode":
        n["eval_mse_gap"] = 0.0
    fit = []  # printed, not compared: no fault reads it at three times a sound run
    failed = 0
    planes = {}
    for p, decoded in kept:
        scene = mix.scenes[p.scene]
        h = parse_header(p.stream)
        want = expected_header(c, p.K, scene.shape)
        bad = sum(h.get(k) != v for k, v in want.items())
        try:
            flat = lfpz_decode(tile_weights(p.stream, h)[0])
            layers = plain.layers_from_flat(flat, dims, device)
        except ValueError:
            n["header_wrong"] += bad + 1
            failed += 1
            continue
        n["header_wrong"] += bad
        key = (p.scene, p.K)
        if key not in planes:
            planes = {key: plain.BasePlane(scene, p.K, c["D"], device)}
        plane = planes[key]
        if control:
            decoded = plain.reconstruct(plane, layers, c["relative"], torch.bfloat16)
        r = plain.judge_decode(plane, layers, decoded, c["relative"])
        n["msb_wrong"] += r["msb_wrong"]
        share = r["flips"] / r["n"]
        n["flip_share"] = max(n["flip_share"], share)
        if p.K == top_k:
            fit.append(r["mse_ratio"])
        if mix.entry != "decode":  # the eval that chose this network, against its MSE
            best = float(p.stats.tiles[0].best_mse)
            n["eval_mse_gap"] = max(n["eval_mse_gap"],
                                    abs(best - r["mse"]) / max(r["mse"], 1e-30))
        failed += bool(bad or r["msb_wrong"])
    info = {"fit_mse_ratio": max(fit)} if fit and mix.entry != "decode" else {}
    return n, failed, info


def _expert(t: torch.Tensor, e: int, expert: bool) -> torch.Tensor:
    return t[e] if expert else t


def _norms(ts) -> np.ndarray:
    return np.array([float(t.double().norm()) for t in ts])


def _gap(prog: np.ndarray, ref: np.ndarray, keep=None) -> float:
    scale = np.maximum(ref, np.median(ref))
    g = np.abs(prog - ref) / np.maximum(scale, 1e-30)
    if keep is not None:
        g = g[keep]
    return float(g.max()) if g.size else 0.0


def judge_steps(mix, records: list, device) -> dict:
    """The kept steps of each picked job, replayed by the reference: the
    init, every batch row, each step's loss, the first gradient, the
    three first steps' change of the parameters, the last steps' loss."""
    c = mix.c
    dims = plain.feature_dims(c["bands"], c["D"], c["base_channel"], c["num_layers"])
    F = dims[0]
    L = len(dims) - 1
    geo = batch_geometry(c)
    n = {"init_wrong": 0, "rows_foreign": 0, "rows_live_wrong": 0, "rows_repeated": 0,
         "step_loss_gap": 0.0, "step_grad_gap": 0.0, "step_change_gap": 0.0,
         "late_loss_gap": 0.0}
    by_job = {}
    for r in records:
        by_job.setdefault(r["job"], []).append(r)
    b1 = plain.ADAM[0]
    for j, recs in sorted(by_job.items()):
        recs = sorted(recs, key=lambda r: r["t"])
        keys, counts = job_row_keys(mix, j, device)
        expert = recs[0]["expert"]
        first = [r for r in recs if not r["late"]][:3]
        for e in range(recs[0]["x"].shape[0] if expert else 1):
            def leaves(ts):
                return [_expert(t, e, expert).to(device) for t in ts]

            pre = leaves(first[0]["pre"])
            n["init_wrong"] += plain.init_violations(pre[:L], pre[L:], dims)
            zeros = [torch.zeros_like(t) for t in pre]
            traj, m, v = pre, zeros, zeros
            for r in recs:
                x, y = leaves([r["x"], r["y"]])
                mask = r["mask"].to(device)
                mask = mask[e] if mask.dim() == 2 else mask
                live = mask > 0
                n["rows_live_wrong"] += live_rows_off(geo, r["t"], int(live.sum()))
                rows = torch.cat([x[live][:, :F], y[live]], dim=1)
                foreign, repeated = rows_against(plain.row_keys(rows), keys, counts)
                n["rows_foreign"] += foreign
                n["rows_repeated"] += repeated
                # the loss on the program's own state: a per-step oracle
                own = leaves(r["pre"])
                _, _, _, loss_ref, grads = plain.train_step(own[:L], own[L:], zeros, zeros, x, y,
                                                            mask, r["lr"], r["t"])
                gap = abs(float(_expert(r["loss"], e, expert)) - loss_ref) / max(abs(loss_ref),
                                                                                  1e-30)
                name = "late_loss_gap" if r["late"] else "step_loss_gap"
                n[name] = max(n[name], gap)
                if r["late"]:
                    continue
                if r is first[0]:
                    g_ref = _norms(grads)
                    g_prog = _norms([t / (1 - b1) for t in leaves(r["m"])])
                    n["step_grad_gap"] = max(n["step_grad_gap"], _gap(g_prog, g_ref))
                    keep = g_ref >= GRAD_FLOOR * np.median(g_ref)
                # the reference's own trajectory for the change
                traj, m, v, _, _ = plain.train_step(traj[:L], traj[L:], m, v, x, y, mask,
                                                    r["lr"], r["t"])
            d_prog = _norms([a - b for a, b in zip(leaves(first[-1]["post"]), pre)])
            d_ref = _norms([a - b for a, b in zip(traj, pre)])
            n["step_change_gap"] = max(n["step_change_gap"], _gap(d_prog, d_ref, keep))
    return n


def job_row_keys(mix, j: int, device) -> tuple:
    """The distinct keys of every (features, labels) row of job j's
    (scene, K) points, sorted, and how many rows hold each."""
    keys = []
    for s, K in mix.job_inputs(j):
        plane = plain.BasePlane(mix.scenes[s], K, mix.c["D"], device)
        for r0, R in plane.blocks():
            keys.append(plain.row_keys(torch.cat([plane.features(r0, R, mix.c["relative"]),
                                                  plane.labels(r0, R)], dim=1)))
    return torch.unique(torch.cat(keys), return_counts=True)


def rows_against(batch: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor) -> tuple:
    """(rows whose key the scenes do not hold, rows beyond the scenes'
    count of their key) of a batch's row keys."""
    uniq, cnt = torch.unique(batch, return_counts=True)
    at = torch.searchsorted(keys, uniq).clamp(max=keys.numel() - 1)
    held = keys[at] == uniq
    foreign = int(cnt[~held].sum())
    repeated = int((cnt[held] - counts[at[held]]).clamp(min=0).sum())
    return foreign, repeated


def eval_series(evals: list) -> dict:
    """Job -> its evals as series, one a fit and expert: a fit's evals come
    epoch by epoch, its experts in order within an epoch; a fit ends where
    the epoch falls.  A series is [(epoch, MSE)]."""
    out = {}
    for job in dict.fromkeys(e[0] for e in evals):
        fits, last = [], None
        for _, epoch, mse in (e for e in evals if e[0] == job):
            if epoch is None or (last is not None and 0 <= epoch < last) or not fits:
                fits.append({})
            if epoch is not None and epoch >= 0:
                last = epoch
            fits[-1].setdefault(epoch, []).append(mse)
        series = []
        for fit in fits:
            width = max(len(v) for v in fit.values())
            for e in range(width):
                series.append([(ep, v[e] if e < len(v) else None) for ep, v in fit.items()])
        out[job] = series
    return out


def judge_evals(mix, jobs: list, evals: list) -> int:
    """Points whose best MSE and epoch no eval series of their job accounts
    for: a series matches a point where its eval at the point's best
    epoch read the point's best MSE bit for bit; it must be that series'
    first minimum, with one eval every `val_every` epochs."""
    c = mix.c
    epochs, every = c["epochs"], min(c.get("val_every", 1), c["epochs"])
    want = [e for e in range(epochs) if (e + 1) % every == 0] if epochs > 1 else []
    series = eval_series(evals)
    wrong = 0
    for job in jobs:
        pool = list(series.get(job.index, []))
        for p in job.points:
            tile = p.stats.tiles[0]
            if not want:
                continue
            hit = [s for s in pool if (tile.best_epoch - 1, tile.best_mse) in s]
            if not hit:
                wrong += 1
                continue
            s = hit[0]
            pool.remove(s)
            vals = [v for _, v in s]
            ok = ([ep for ep, _ in s] == want and None not in vals
                  and vals.index(min(vals)) == tile.best_epoch - 1)
            wrong += not ok
        wrong += len(pool) if want else 0  # evals that chose no point's network
    return wrong


def judge(mix, jobs, outputs, records, evals, limits: dict, device,
          control: bool = False) -> dict:
    """Every number of the cell beside its limit, and `correct`: each
    number within its limit, and none missing."""
    numbers, failed, info = judge_streams(mix, outputs["kept"], device, control)
    if mix.entry != "decode":
        numbers.update(judge_steps(mix, records, device))
        numbers["steps_wrong"] = sum(abs(j.steps[0] - j.steps[1]) for j in jobs)
        kept = {}
        for r in records:
            kept[(r["job"], r["late"])] = kept.get((r["job"], r["late"]), 0) + 1
        numbers["steps_unkept"] = sum(max(0, 3 - kept.get((j.index, late), 0))
                                      for j in jobs if j.kept for late in (False, True))
        numbers["evals_wrong"] = judge_evals(mix, jobs, evals)
    out, correct = {}, True
    for name, limit in limits.items():
        if name not in numbers:
            correct = False
            out[name] = {"value": None, "limit": limit}
            continue
        ok = numbers[name] <= limit
        correct = correct and ok
        failed += 0 if ok or name in ("msb_wrong", "header_wrong") else 1
        out[name] = {"value": numbers[name], "limit": limit}
    return {"correct": bool(correct and outputs["kept"]), "failed": int(failed),
            "numbers": out, "info": info}
