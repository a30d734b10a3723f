"""A benchmark root of tiny cells for the CPU tests: ``make_root(path)``
writes a ``BENCHMARK.json`` and its data files (configurations, traffic,
limits) under ``path``, in the layout of the real one."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

WORLD_3D = {
    "n_windows": 4, "precursor_mz_range": [400.0, 800.0], "fragment_mz_range": [200.0, 1000.0],
    "n_cycles": 120, "cycle_time": 1.0, "noise_peaks_per_spectrum": 30, "ms1_noise_peaks_per_spectrum": 30,
    "n_targets": 384, "n_detectable": 192, "n_fragments": 10, "n_isotopes": 3, "fwhm_rt": 4.0,
    "peak_ppm_sigma": 2.0, "lib_ppm_bias": 4.0, "lib_rt_sigma": 4.0, "base_intensity": 10000.0,
    "with_mobility": False,
}
WORLD_4D = dict(WORLD_3D, with_mobility=True, mobility_range=[0.6, 1.6], mobility_fwhm=0.08, lib_mobility_sigma=0.01,
                n_targets=256, n_detectable=128)
PROGRAM = {"n_scan_bins": 8, "coarse_bin_width": 1.0}
LIMITS = {"store_diff": 0, "selection_gap": 4e-6, "feature_gap": 1e-3, "frag_gap": 1e-3}


def traffic() -> dict:
    t = json.loads((HERE / "traffic" / "final.json").read_text())
    t.update(slice_precursors=256, rt_tolerance_s=20.0, warmup_calls=1)
    t["check"] = {"windows": 2, "max_precursors": 4096}
    return t


def make_root(path: Path, limits: dict | None = None) -> Path:
    """The tiny root: cells ``tiny3d.final`` and ``tiny4d.final``."""
    path = Path(path)
    bench = copy.deepcopy(json.loads((HERE.parent / "BENCHMARK.json").read_text()))
    for d in ("configs", "traffic", "checks"):
        (path / "perfbench" / d).mkdir(parents=True, exist_ok=True)
    bench["configs"] = []
    for name, world in (("tiny3d", WORLD_3D), ("tiny4d", WORLD_4D)):
        file = f"perfbench/configs/{name}.json"
        (path / file).write_text(json.dumps({"world": world, "program": PROGRAM}))
        bench["configs"].append({"name": name, "source": "tests", "file": file, "reduced": [], "why": "tests"})
    (path / "perfbench" / "traffic" / "final.json").write_text(json.dumps(traffic()))
    cells = [("tiny3d.final", "tiny3d", "final"), ("tiny4d.final", "tiny4d", "final")]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tests"} for n, c, t in cells]
    rename = {"astral3d.final": "tiny3d.final", "timstof4d.final": "tiny4d.final"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    for n, _, t in cells:
        lim = limits or LIMITS
        (path / "perfbench" / "checks" / f"{n}.json").write_text(json.dumps({"limits": lim}))
    (path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return path
