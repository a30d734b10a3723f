"""``BENCHMARK.json`` keeps to the benchmark's contract, and a cell, a
traffic mix and a per-layer metric added as files of their own are found by
name with nothing else edited."""

import json
import re
import shutil

from tiny import ROOT

from perfbench.bench import cell as cell_mod
from perfbench.bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == TOP_KEYS
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "checks" / f"{w['name']}.json").is_file()
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    metrics = set()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        metrics.add(m["name"])
    assert "setup_s" in metrics
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        metrics.add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    assert len(metrics) == len(b["end_to_end"]) + len(b["per_layer"])
    # each cell reports setup_s, another end-to-end metric and a per-layer metric
    for name in cells:
        c = spec.Cell.find(name)
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and c.per_layer
    # the budget of a full check with 24 cells
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024


def test_added_files_are_found_by_name(tiny_root):
    """A new configuration, traffic mix, limits and per-layer metric, each a
    file of its own, and entries in BENCHMARK.json: the harness finds them."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    src = tiny_root / "perfbench"
    shutil.copy(src / "configs" / "tiny3d.json", src / "configs" / "tiny3d_b.json")
    shutil.copy(src / "traffic" / "final.json", src / "traffic" / "final_b.json")
    shutil.copy(src / "checks" / "tiny3d.final.json", src / "checks" / "tiny3d_b.final_b.json")
    (src / "metrics").mkdir(exist_ok=True)
    (src / "metrics" / "units_in_window.final_b.py").write_text("def read(run):\n    return run.window.units\n")
    bench["configs"].append({"name": "tiny3d_b", "source": "tests", "file": "perfbench/configs/tiny3d_b.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny3d_b.final_b", "config": "tiny3d_b", "traffic": "final_b", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "units_in_window.final_b", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "precursors_per_s",
                               "workloads": ["tiny3d_b.final_b"]})
    for m in bench["end_to_end"]:
        if m["name"] == "precursors_per_s":
            m["workloads"].append("tiny3d_b.final_b")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.Cell.find("tiny3d_b.final_b", root=tiny_root)
    assert c.config["world"]["n_windows"] == 4 and c.traffic["loop"] == "final"
    assert [m["name"] for m in c.per_layer] == ["units_in_window.final_b"]
    result, lines = cell_mod.run_cell("tiny3d_b.final_b", 3, 0.5, True, 0.0, device="cpu", root=tiny_root)
    assert result["metrics"]["units_in_window.final_b"]["value"] >= 1
    assert result["correct"], lines
