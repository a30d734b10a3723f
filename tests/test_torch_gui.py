"""The port's GUI server (``alphadia_torch/gui``), the port's side of the
JAX package's ``tests/integration/test_gui_server.py``:

- the per-session token and the loopback Host check refuse foreign calls;
- ``build_schema()`` equals the JAX package's but for the display name of
  the ``tpu`` section ("Engine"), and ``descriptions.json`` equals JAX's
  parse of the comments in its ``default.yaml``;
- browse, validation errors, an output folder that cannot be written
  (answered as a JSON error);
- ``_results`` equals JAX's on one output folder (pyarrow's parquet with
  nulls, a stat.tsv, figures at both levels);
- results and figures are confined to recorded runs;
- a small search through ``/api/run`` on the CPU ends ``done``, its
  ``fdr.png`` listed and served byte for byte, and a second run cancelled
  ends ``cancelled``.

    PYTHONPATH=. python tests/test_torch_gui.py --write-descriptions   # after default.yaml's comments change
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.gui import schema as port_schema
from alphadia_torch.gui.server import JobManager, _results, make_handler
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.rawdata import save_npz
from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_tpu.gui import schema as jax_schema
from alphadia_tpu.gui.server import _results as jax_results

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]
TOKEN = "test-token-456"


def jax_descriptions() -> dict:
    parsed = jax_schema._parse_comments(jax_schema.DEFAULT_YAML.read_text())
    return {f"{section}.{key}": text for (section, key), text in parsed.items()}


@pytest.fixture()
def server(tmp_path_factory, monkeypatch):
    from http.server import ThreadingHTTPServer

    monkeypatch.setenv("ALPHADIA_TPU_CACHE", str(tmp_path_factory.mktemp("gui_cache")))
    jobs = JobManager()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(jobs, TOKEN))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    if jobs._proc is not None and jobs._proc.poll() is None:
        jobs.cancel()
        jobs._proc.wait(timeout=30)


def _get(url, token=TOKEN):
    req = urllib.request.Request(url, headers={"X-Auth-Token": token})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _get_bytes(url, token=TOKEN):
    req = urllib.request.Request(url, headers={"X-Auth-Token": token})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def _post(url, payload, token=TOKEN):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST", headers={"X-Auth-Token": token})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_auth_required(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server + "/api/schema", token="wrong")
    assert exc.value.code == 403
    code, _ = _post(server + "/api/run", {}, token="")
    assert code == 403
    req = urllib.request.Request(server + "/api/schema", headers={"X-Auth-Token": TOKEN, "Host": "evil.example:8855"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=10)
    assert exc.value.code == 403
    with urllib.request.urlopen(server + "/", timeout=10) as r:
        assert r.status == 200


def test_schema_and_static_page(server):
    schema = _get(server + "/api/schema")
    assert schema["raw_path_list"]["required"]
    assert {"general", "search", "fdr", "tpu"} <= {s["id"] for s in schema["config"]}
    assert sum(len(s["parameters"]) for s in schema["config"]) > 80
    with urllib.request.urlopen(server + "/", timeout=10) as r:
        page = r.read().decode()
    assert "alphadia-torch" in page and "/api/run" in page and "alphadia-tpu" not in page


def test_schema_equals_jax_but_the_engine_name():
    ours, theirs = port_schema.build_schema(), jax_schema.build_schema()
    renamed = {s["id"]: s["name"] for s in ours["config"]}
    assert renamed["tpu"] == "Engine" and {s["id"]: s["name"] for s in theirs["config"]}["tpu"] == "TPU Engine"
    for s in ours["config"]:
        if s["id"] == "tpu":
            s["name"] = "TPU Engine"
    assert json.dumps(ours, sort_keys=False) == json.dumps(theirs, sort_keys=False)


def test_descriptions_equal_jax_parse():
    assert port_schema.descriptions() == jax_descriptions()


def test_browse(server, tmp_path):
    (tmp_path / "run.mzML").write_text("x")
    (tmp_path / "sample.d").mkdir()
    (tmp_path / "lib.tsv").write_text("x")
    (tmp_path / "db.fasta").write_text(">x\nPEPTIDE\n")
    d = _get(server + f"/api/browse?path={tmp_path}")
    by_name = {e["name"]: e for e in d["entries"]}
    assert by_name["run.mzML"]["raw"]
    assert by_name["sample.d"]["raw"] and by_name["sample.d"]["dir"]
    assert by_name["lib.tsv"]["lib"] and by_name["db.fasta"]["fasta"]
    assert "error" in _get(server + f"/api/browse?path={tmp_path}/missing/deeper")


def test_run_validation_errors(server, tmp_path):
    code, res = _post(server + "/api/run", {"raw_path_list": []})
    assert code == 400 and "output_directory" in res["error"]
    code, res = _post(server + "/api/run", {"output_directory": str(tmp_path)})
    assert code == 400 and "raw file" in res["error"]
    code, res = _post(server + "/api/run", {"output_directory": str(tmp_path), "raw_path_list": ["/nope.mzML"]})
    assert code == 400 and "not found" in res["error"]
    code, res = _post(server + "/api/cancel", {})
    assert code == 400
    req = urllib.request.Request(server + "/api/run", data=b"{not json", method="POST", headers={"X-Auth-Token": TOKEN})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=10)
    assert exc.value.code == 400


def test_run_unwritable_output_is_json_error(server, tmp_path):
    raw = tmp_path / "run.npz"
    raw.write_bytes(b"\x00")
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    code, res = _post(server + "/api/run", {"output_directory": str(blocker / "out"), "raw_path_list": [str(raw)]})
    assert code == 400 and "cannot write to output directory" in res["error"]


def test_results_equal_jax(tmp_path):
    out = tmp_path / "out"
    (out / "figures").mkdir(parents=True)
    (out / "quant" / "run_0" / "figures").mkdir(parents=True)
    for p in (out / "figures" / "b.png", out / "quant" / "run_0" / "figures" / "fdr.png", out / "figures" / "notes.txt"):
        p.write_bytes(b"\x89PNG")
    pd.DataFrame({
        "precursor.sequence": ["PEPTIDE", "PEPTIDE", "AAK", None, "CCR"],
        "pg.name": ["P1", "P1;P2", None, "P3", "P3"],
        "run": ["run_0", "run_1", "run_0", "run_1", "run_1"],
        "precursor.qval": [0.0, 0.001, np.nan, 0.002, 0.003],
    }).to_parquet(out / "precursors.parquet")
    (out / "stat.tsv").write_text("run\tchannel\tprecursors\nrun_0\t0\t12\nrun_1\t0\t10\n")
    (out / "log.txt").write_text("done\n")
    theirs, ours = jax_results(str(out)), _results(str(out))
    assert ours == theirs
    assert ours["summary"] == {"precursors": 5, "peptides": 3, "protein_groups": 3, "runs": 2}
    assert _results(str(tmp_path / "missing")) == jax_results(str(tmp_path / "missing"))


def test_figure_confinement(server, tmp_path):
    (tmp_path / "a.png").write_bytes(b"\x89PNG")
    for path in ("/etc/hostname", str(tmp_path / "a.png")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server + "/api/figure?path=" + path)
        assert ei.value.code == 403
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server + "/api/results?output=/etc")
    assert ei.value.code == 403


def _wait(server, states, seconds):
    deadline = time.time() + seconds
    st = {}
    while time.time() < deadline:
        st = _get(server + "/api/status")
        if st["state"] in states:
            return st
        time.sleep(0.5)
    return st


def test_run_search_through_gui(server, tmp_path, monkeypatch):
    """A small search on the CPU through the API, then a cancelled one."""
    monkeypatch.setenv("ALPHADIA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(n_peptides=150, n_windows=4, n_cycles=200, seed=11))
    prec, frag = add_synthetic_decoys(prec, frag)
    raw = tmp_path / "run.npz"
    save_npz(raw, spectra)
    lib = tmp_path / "lib.hdf"
    SpecLibFlat(prec, frag).save_hdf(lib)
    out = tmp_path / "out"
    payload = {
        "raw_path_list": [str(raw)],
        "library": str(lib),
        "output_directory": str(out),
        "config": {
            "general": {"random_state": 3, "input_library_type": "flat", "thread_count": 2},
            "calibration": {"batch_size": 150, "optimization_lock_target": 50, "min_steps": 2, "max_steps": 4},
            "tpu": {"selection_batch": 256, "scoring_batch": 256},
        },
    }
    code, res = _post(server + "/api/run", payload)
    assert code == 200 and res.get("ok"), res
    code, res2 = _post(server + "/api/run", payload)
    assert code == 400 and "already running" in res2["error"]
    st = _wait(server, ("done", "failed", "cancelled"), 300)
    assert st["state"] == "done", f"state={st['state']} log={st.get('log_tail', '')[-3000:]}"
    assert "alphadia_torch.cli" in st["cmd"] and "precursors.parquet" in st["results"]

    hist = _get(server + "/api/history")["runs"]
    assert hist[0]["output"] == str(out) and hist[0]["state"] == "done"
    res = _get(server + "/api/results?output=" + str(out))
    assert res == jax_results(str(out))
    assert res["summary"]["precursors"] > 0 and "stat.tsv" in res["files"]
    fdr_png = str(out / "quant" / "run" / "figures" / "fdr.png")
    assert fdr_png in res["figures"]
    assert _get_bytes(server + "/api/figure?path=" + fdr_png) == Path(fdr_png).read_bytes()

    # a second run, cancelled while it runs: the process group ends
    code, res = _post(server + "/api/run", {**payload, "output_directory": str(tmp_path / "out2")})
    assert code == 200, res
    code, res = _post(server + "/api/cancel", {})
    assert code == 200 and res["ok"]
    st = _wait(server, ("done", "failed", "cancelled"), 60)
    assert st["state"] == "cancelled", st
    assert _get(server + "/api/history")["runs"][0]["state"] == "cancelled"


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-descriptions"]:
        port_schema.DESCRIPTIONS_JSON.write_text(json.dumps(jax_descriptions(), indent=1) + "\n")
        print(f"wrote {port_schema.DESCRIPTIONS_JSON}")
    else:
        sys.exit(__doc__)
