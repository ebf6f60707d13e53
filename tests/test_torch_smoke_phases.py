"""chip_smoke.py's phase clock: every phase line carries its wall seconds
(`total_seconds`: its own where it has one, else the time since the phase
line before it) and enters the total line's `phase_seconds` map under its
name (a profile line under profile_<of>); the total line and lines with no
phase stay as given."""

import importlib.util
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_clock",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_lines_carry_their_seconds(capsys):
    smoke = _smoke()
    smoke._phase_mark[0] = time.time() - 5.0  # main started five seconds ago
    smoke.emit({"phase": "a"})
    smoke.emit({"phase": "b", "total_seconds": 1.25})
    smoke.emit({"phase": "profile", "of": "encode"})
    smoke.emit({"kernels": []})
    smoke.emit({"phase": "total", "script_seconds": 9.0, "phase_seconds": smoke.PHASE_SECONDS})
    a, b, prof, kernels, total = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert 5.0 <= a["total_seconds"] < 60.0
    assert b["total_seconds"] == 1.25
    assert 0.0 <= prof["total_seconds"] < 5.0  # since b's line, not since main
    assert kernels == {"kernels": []}
    assert total == {"phase": "total", "script_seconds": 9.0,
                     "phase_seconds": {"a": a["total_seconds"], "b": 1.25,
                                       "profile_encode": prof["total_seconds"]}}
