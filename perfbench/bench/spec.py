"""The cell's entries in ``BENCHMARK.json`` and the files they name.

A cell (``workloads``) names its configuration (``configs[].file``, a JSON
file) and its traffic (``perfbench/traffic/<traffic>.json``); its metrics are
the entries of ``end_to_end`` and ``per_layer`` that list it (or list no
cells). Each per-layer metric's reader is ``perfbench/metrics/<name>.py``
and each cell's limits ``perfbench/checks/<cell>.json``. Nothing here names
a cell, a configuration, a mix or a metric: new ones are new files and
entries.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path

    @classmethod
    def find(cls, workload: str, bench: dict | None = None, root: Path | None = None) -> "Cell":
        root = Path(root) if root is not None else ROOT
        if bench is None:
            bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        config = json.loads((root / conf["file"]).read_text())
        traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]

        return cls(
            name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
            end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]), root=root,
        )

    def reader_path(self, metric: str) -> Path:
        """The metric's reader: under the cell's root, else this benchmark's."""
        path = self.root / "perfbench" / "metrics" / f"{metric}.py"
        return path if path.exists() else HERE / "metrics" / f"{metric}.py"

    def limits(self) -> dict:
        return json.loads((self.root / "perfbench" / "checks" / f"{self.name}.json").read_text())["limits"]
