"""The port's local web GUI server: configuration and run monitoring as a
local HTTP app of the standard library (``ThreadingHTTPServer``, a JSON
API, one static page), each search launched as an ``alphadia-torch``
process of its own (``python -m alphadia_torch.cli``). The child runs on
the card unless ``ALPHADIA_TORCH_DEVICE=cpu`` is set in the server's
environment, which it inherits.

API:
  GET  /api/schema          -> workflow parameter schema (gui/schema.py)
  GET  /api/browse?path=    -> directory listing for the file picker
  POST /api/run             -> start a search subprocess (one at a time)
  GET  /api/status          -> job state + log tail + output summary
  POST /api/cancel          -> terminate the running job's process group
  GET  /api/history         -> past runs (persisted across GUI restarts)
  GET  /api/results?output= -> output-dir summary: stat.tsv rows, ID
                               counts from precursors.parquet, figures
  GET  /api/figure?path=    -> serve a figure (confined to history dirs)
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import signal
import subprocess
import sys
import threading
import webbrowser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from alphadia_torch.gui.schema import build_schema
from alphadia_torch.utils.parquet import read_parquet

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).parent / "static"

RAW_SUFFIXES = {".mzml", ".hdf", ".hdf5", ".h5", ".npz", ".d"}
LIB_SUFFIXES = {".hdf", ".hdf5", ".h5", ".tsv", ".csv"}


def _history_path() -> Path:
    """``gui_history.json`` in ``ALPHADIA_TPU_CACHE`` (the JAX package's
    variable), else in ``~/.cache/alphadia_torch``."""
    root = Path(
        os.environ.get("ALPHADIA_TPU_CACHE", Path.home() / ".cache" / "alphadia_torch")
    )
    root.mkdir(parents=True, exist_ok=True)
    return root / "gui_history.json"


class RunHistory:
    """The past runs, kept across restarts of the GUI.

    Also the allow-list that confines /api/results and /api/figure to
    directories the user launched runs into."""

    MAX = 40

    def __init__(self):
        self._lock = threading.Lock()
        try:
            self._runs = json.loads(_history_path().read_text())
        except (OSError, json.JSONDecodeError):
            self._runs = []

    def record(self, output: str, state: str, n_raw: int) -> None:
        import time as _time

        with self._lock:
            self._runs = [r for r in self._runs if r["output"] != output]
            self._runs.insert(
                0,
                {
                    "output": output,
                    "state": state,
                    "n_raw": n_raw,
                    "time": _time.strftime("%Y-%m-%d %H:%M:%S"),
                },
            )
            del self._runs[self.MAX :]
            try:
                _history_path().write_text(json.dumps(self._runs, indent=1))
            except OSError:
                pass

    def update_state(self, output: str, state: str) -> None:
        with self._lock:
            for r in self._runs:
                if r["output"] == output:
                    r["state"] = state
                    break
            try:
                _history_path().write_text(json.dumps(self._runs, indent=1))
            except OSError:
                pass

    def list(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._runs]

    def allowed(self, path_str: str) -> bool:
        """True when path is inside one of the recorded output dirs."""
        try:
            p = Path(path_str).resolve()
        except OSError:
            return False
        with self._lock:
            roots = [r["output"] for r in self._runs]
        for root in roots:
            try:
                p.relative_to(Path(root).resolve())
                return True
            except ValueError:
                continue
        return False


class JobManager:
    """One search at a time, each a process of its own."""

    def __init__(self, history: RunHistory | None = None):
        self._lock = threading.Lock()
        self._proc: subprocess.Popen | None = None
        self._info: dict = {"state": "idle"}
        self.history = history or RunHistory()

    def start(self, payload: dict) -> dict:
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                return {"error": "a search is already running"}
            output = payload.get("output_directory") or ""
            raw_files = payload.get("raw_path_list") or []
            if not output:
                return {"error": "output_directory is required"}
            if not raw_files:
                return {"error": "at least one raw file is required"}
            missing = [f for f in raw_files if not Path(f).exists()]
            if missing:
                return {"error": f"raw files not found: {missing}"}
            cmd = [sys.executable, "-m", "alphadia_torch.cli", "-o", output]
            for f in raw_files:
                cmd += ["-f", f]
            if payload.get("library"):
                cmd += ["-l", payload["library"]]
            for fasta in payload.get("fasta_list") or []:
                cmd += ["--fasta", fasta]
            config = payload.get("config") or {}
            if config:
                cmd += ["--config-dict", json.dumps(config)]
            # filesystem/launch failures come back as JSON errors, not a
            # dropped connection (unwritable output dir, missing python…)
            try:
                Path(output).mkdir(parents=True, exist_ok=True)
                log_path = Path(output) / "gui_run.log"
                log_file = open(log_path, "wb")
            except OSError as e:
                return {"error": f"cannot write to output directory: {e}"}
            try:
                # own process group so cancel kills the whole tree (exact
                # pgid, never by pattern)
                self._proc = subprocess.Popen(
                    cmd,
                    stdout=log_file,
                    stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
            except OSError as e:
                return {"error": f"could not launch search process: {e}"}
            finally:
                log_file.close()
            self._info = {
                "state": "running",
                "pid": self._proc.pid,
                "output_directory": output,
                "log_path": str(log_path),
                "cmd": cmd,
            }
            self.history.record(output, "running", len(raw_files))
            return {"ok": True, "pid": self._proc.pid}

    def status(self) -> dict:
        with self._lock:
            info = dict(self._info)
            proc = self._proc
        if proc is not None and info.get("state") in ("running", "cancelling"):
            rc = proc.poll()
            if rc is not None:
                info["state"] = (
                    "done"
                    if rc == 0
                    else ("cancelled" if info.get("state") == "cancelling" else "failed")
                )
                info["returncode"] = rc
                with self._lock:
                    # compare-and-set: a new job may have started while we
                    # polled outside the lock — never clobber its state
                    # with this (now stale) terminal record
                    if self._proc is proc:
                        self._info = dict(info)
                if info.get("output_directory"):
                    self.history.update_state(
                        info["output_directory"], info["state"]
                    )
        log_path = info.get("log_path")
        if log_path and Path(log_path).exists():
            # the front-end polls this every ~2 s: read only the tail,
            # never the whole (potentially huge) log
            with open(log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 16384))
                data = f.read()
            info["log_tail"] = data.decode("utf-8", errors="replace")
        out = info.get("output_directory")
        if info.get("state") == "done" and out:
            results = {}
            for name in ("precursors.parquet", "stat.tsv", "pg.matrix.parquet"):
                p = Path(out) / name
                if p.exists():
                    results[name] = p.stat().st_size
            info["results"] = results
        return info

    def cancel(self) -> dict:
        with self._lock:
            proc = self._proc
            if proc is None or proc.poll() is not None:
                return {"error": "no running job"}
            self._info["state"] = "cancelling"
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except ProcessLookupError:
            pass
        return {"ok": True}


def _browse(path_str: str) -> dict:
    path = Path(path_str or "~").expanduser()
    if not path.is_dir():
        path = path.parent
    if not path.is_dir():
        return {"error": f"not a directory: {path}"}
    entries = []
    try:
        for p in sorted(path.iterdir()):
            if p.name.startswith(".") and p.name != "..":
                continue
            is_dir = p.is_dir()
            suffix = p.suffix.lower()
            entries.append(
                {
                    "name": p.name,
                    "path": str(p),
                    "dir": is_dir,
                    # .d directories ARE raw files
                    "raw": suffix in RAW_SUFFIXES
                    or p.name.lower().endswith(".mzml.gz"),
                    "lib": (not is_dir) and suffix in LIB_SUFFIXES,
                    "fasta": (not is_dir) and suffix in (".fasta", ".fa"),
                }
            )
    except PermissionError:
        return {"error": f"permission denied: {path}"}
    return {"path": str(path), "parent": str(path.parent), "entries": entries}


def _n_unique(values: np.ndarray) -> int:
    """Distinct values, nulls (NaN, None) not counted, as pandas' ``nunique``."""
    if values.dtype == object:
        kept = np.array([v for v in values.tolist() if v is not None and v == v], dtype=object)
        return len(np.unique(kept.astype(str))) if kept.size else 0
    if values.dtype.kind == "f":
        values = values[~np.isnan(values)]
    return len(np.unique(values))


def _results(output: str) -> dict:
    """Summarize one finished output directory for the Results tab."""
    out_dir = Path(output)
    if not out_dir.is_dir():
        return {"error": f"not a directory: {output}"}
    res: dict = {"output": str(out_dir)}

    stat = out_dir / "stat.tsv"
    if stat.exists():
        import csv

        with open(stat) as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        # round floats for display; keep a bounded, stable column order
        res["stat"] = rows[:50]

    prec = out_dir / "precursors.parquet"
    if prec.exists():
        df = read_parquet(prec)
        summary = {"precursors": len(next(iter(df.values()))) if df else 0}
        for col, key in (("precursor.sequence", "peptides"), ("pg.name", "protein_groups"), ("run", "runs")):
            if col in df:
                summary[key] = _n_unique(df[col])
        res["summary"] = summary

    figures = []
    for pattern in ("figures/*.png", "quant/*/figures/*.png"):
        for p in sorted(out_dir.glob(pattern)):
            figures.append(str(p))
    res["figures"] = figures[:200]

    tables = {}
    for name in (
        "precursors.parquet", "stat.tsv", "internal.tsv",
        "pg.matrix.parquet", "precursor.matrix.parquet",
        "peptide.matrix.parquet", "speclib.mbr.hdf", "log.txt",
    ):
        p = out_dir / name
        if p.exists():
            tables[name] = p.stat().st_size
    res["files"] = tables
    return res


def make_handler(jobs: JobManager, token: str):
    """Request handler bound to one JobManager and one auth token.

    Defenses (the server binds to 127.0.0.1, but local ports are still
    reachable by any page the user's browser visits):
      - every /api request must carry ``X-Auth-Token`` — a custom header
        forces a CORS preflight, which the server never answers, so
        cross-origin pages cannot call the API (CSRF);
      - the Host header must be a loopback name, so a DNS-rebinding page
        (attacker domain re-resolving to 127.0.0.1) is refused outright.
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route http noise to logging
            logger.debug("gui: " + fmt, *args)

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reject_bad_origin(self) -> bool:
            host = (self.headers.get("Host") or "").rsplit(":", 1)[0]
            if host not in ("127.0.0.1", "localhost", "[::1]", "::1"):
                self._json({"error": "forbidden host"}, 403)
                return True
            return False

        def _reject_bad_token(self) -> bool:
            sent = self.headers.get("X-Auth-Token") or ""
            if not secrets.compare_digest(sent, token):
                self._json({"error": "missing or invalid auth token"}, 403)
                return True
            return False

        def do_GET(self):
            if self._reject_bad_origin():
                return
            url = urlparse(self.path)
            if url.path.startswith("/api/") and self._reject_bad_token():
                return
            if url.path in ("/", "/index.html"):
                body = (STATIC_DIR / "index.html").read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/api/schema":
                self._json(build_schema())
            elif url.path == "/api/status":
                self._json(jobs.status())
            elif url.path == "/api/browse":
                q = parse_qs(url.query)
                self._json(_browse(q.get("path", [""])[0]))
            elif url.path == "/api/history":
                self._json({"runs": jobs.history.list()})
            elif url.path == "/api/results":
                q = parse_qs(url.query)
                out = q.get("output", [""])[0]
                if not jobs.history.allowed(out):
                    self._json({"error": "unknown output directory"}, 403)
                    return
                try:
                    self._json(_results(out))
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}"}, 500)
            elif url.path == "/api/figure":
                q = parse_qs(url.query)
                p = q.get("path", [""])[0]
                # confined: inside a recorded run dir, png only, no links
                if (
                    not jobs.history.allowed(p)
                    or not p.endswith(".png")
                    or not Path(p).is_file()
                    or Path(p).is_symlink()
                ):
                    self._json({"error": "forbidden"}, 403)
                    return
                body = Path(p).read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self._reject_bad_origin() or self._reject_bad_token():
                return
            n = int(self.headers.get("Content-Length") or 0)
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._json({"error": "invalid JSON"}, 400)
                return
            try:
                if self.path == "/api/run":
                    res = jobs.start(payload)
                elif self.path == "/api/cancel":
                    res = jobs.cancel()
                else:
                    self._json({"error": "not found"}, 404)
                    return
            except Exception as e:  # surface as JSON, not a dropped socket
                logger.warning(f"GUI {self.path} failed: {e}")
                res = {"error": f"{type(e).__name__}: {e}"}
            self._json(res, 400 if "error" in res else 200)

    return Handler


def serve(port: int = 8855, open_browser: bool = True) -> ThreadingHTTPServer:
    """Start the GUI server (returns the server; caller owns shutdown).

    The per-session auth token is embedded in the launch URL fragment;
    the page stores it and sends it as ``X-Auth-Token`` on every API
    call. The server exposes it as ``httpd.auth_token`` for tests.
    """
    jobs = JobManager()
    token = secrets.token_urlsafe(16)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(jobs, token))
    httpd.auth_token = token
    url = f"http://127.0.0.1:{httpd.server_address[1]}/#token={token}"
    logger.info(f"alphadia-torch GUI at {url}")
    if open_browser:
        threading.Timer(0.3, lambda: webbrowser.open(url)).start()
    return httpd


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="alphadia-torch local GUI")
    parser.add_argument("--port", type=int, default=8855)
    parser.add_argument("--no-browser", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    httpd = serve(port=args.port, open_browser=not args.no_browser)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
