"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` finds the cell's configuration, traffic and metrics by name
(``bench/spec.py``), makes the run from the seed, drives the traffic's loop
(``perfbench/loops/<loop>.py``) through a warm-up and then for ``seconds``,
and with ``trace`` profiles a stretch of whole units in the middle of the
window. After the window it reads the peak memory, looks for JAX among the
loaded modules, frees the program's state and runs the check
(``bench/check.py``). It returns the result line's object and the check's
lines.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench.bench import check, program, spec
from perfbench.bench.trace import Spans, Tracer
from perfbench.gen.world import make_world

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "alphadia_tpu")


class NoDevice(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


@dataclass
class Window:
    seconds: float = 0.0
    work: int = 0
    units: int = 0


@dataclass
class Run:
    workload: str
    seed: int
    device: torch.device
    config: dict
    traffic: dict
    world: object = None
    dia: object = None
    loop: object = None
    spans: Spans = field(default_factory=Spans)
    records: list = field(default_factory=list)
    traced: list = field(default_factory=list)  # records of the traced units
    trace: object = None
    traced_between: tuple = (0.0, 0.0)  # perf_counter bounds of the traced units
    window: Window = field(default_factory=Window)
    setup_parts: dict = field(default_factory=dict)  # seconds of each stage of the set-up
    store_size: tuple = (0, 0)  # the program's store: peaks, stored rows (peaks and ghosts)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def check_device(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")
    return torch.device("cuda:0")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(workload: str, seed: int, device=None, root=None) -> tuple[spec.Cell, Run]:
    """The set-up: the run from the seed, the program's store on the card,
    the traffic's loop and its warm-up."""
    cell = spec.Cell.find(workload, root=root)
    dev = check_device(cell.chips) if device is None else torch.device(device)
    run = Run(workload=workload, seed=int(seed), device=dev, config=cell.config, traffic=cell.traffic)
    t = time.perf_counter()
    run.world = make_world(cell.config["world"], run.seed, dev)
    _sync(dev)
    run.setup_parts["world"] = -t + (t := time.perf_counter())
    prog = cell.config["program"]
    run.dia = program.dia_data(run.world, prog["n_scan_bins"], prog["coarse_bin_width"])
    run.setup_parts["store"] = -t + (t := time.perf_counter())
    run.store_size = (run.dia.n_peaks, run.dia.n_stored_peaks)
    run.dia.device_arrays(1, dev)
    _sync(dev)
    run.setup_parts["upload"] = -t + (t := time.perf_counter())
    run.loop = importlib.import_module(f"perfbench.loops.{cell.traffic['loop']}").Loop(run)
    for _ in range(run.loop.warmup_units):
        run.loop.step(run.spans)
    _sync(dev)
    run.setup_parts["warmup"] = time.perf_counter() - t
    return cell, run


def measure(run: Run, seconds: float, trace: bool) -> int:
    """The window: whole units until ``seconds`` have passed, the units from
    the first past the middle traced with ``trace``. Returns the peak of the
    card's allocated memory over the window."""
    dev = run.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run.spans = Spans()
    tracer = Tracer(run.spans) if trace else None
    t0 = time.perf_counter()
    traced_from = None
    while True:
        if tracer is not None and traced_from is None and time.perf_counter() - t0 >= seconds / 2:
            tracer.start()
            traced_from = len(run.records)
            run.traced_between = (time.perf_counter(), 0.0)
        rec = run.loop.step(run.spans)
        run.records.append(rec)
        run.window.work += rec["work"]
        run.window.units += 1
        if tracer is not None and tracer.active and len(run.records) - traced_from >= run.loop.trace_units:
            tracer.stop()
            run.traced_between = (run.traced_between[0], time.perf_counter())
            run.trace = tracer.trace
            run.traced = run.records[traced_from:]
        if time.perf_counter() - t0 >= seconds and (tracer is None or run.trace is not None):
            break
    _sync(dev)
    run.window.seconds = time.perf_counter() - t0
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float, *, device=None,
             root=None) -> tuple[dict, list[str]]:
    """The result of one run and the check's lines. ``device`` (skipping
    the look for a card) and ``root`` (a directory holding a
    ``BENCHMARK.json`` and ``perfbench/``'s data files) serve the CPU tests."""
    cell, run = prepare(workload, seed, device, root)
    setup_s = time.perf_counter() - t_start
    peak = measure(run, seconds, trace)
    found = forbidden_modules()
    if found:
        raise Forbidden("modules of JAX or the JAX package are loaded: " + ", ".join(found))

    e2e = dict(run.loop.end_to_end(run.window))
    e2e["setup_s"] = setup_s
    e2e["device_peak_gib"] = peak / 2**30
    metrics = {}
    if not trace:
        for m in cell.end_to_end:  # a name's part after a dot names the cells, not the quantity
            metrics[m["name"]] = {"value": float(e2e[m["name"].split(".")[0]]), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = _reader(cell.reader_path(m["name"])).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = run.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
    attempted = int(run.window.work)
    breakdown = run.trace.breakdown() if trace else None

    walls = [b - a for n, a, b in run.spans.records if n == run.loop.unit_span]
    unit = run.loop.unit
    numbers, info = correctness(run)
    checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in cell.limits().items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    lines = [
        "setup_s " + repr(setup_s) + ": " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items()),
        f"store: {run.store_size[0]} peaks, {run.store_size[1]} rows",
        f"window {run.window.seconds!r} s, {run.window.units} {unit}s: " + " ".join(f"{w:.3f}" for w in walls),
        "; ".join(f"{k}: {v}" for k, v in info.items()),
    ]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, lines


def _reader(path):
    mod = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(module)
    return module


def correctness(run: Run, control: bool = False) -> tuple[dict, dict]:
    """The check's numbers (``bench/check.py``) and what they came from: the
    sample, the store compared while the program still holds it, then the
    program's state freed and the reference run. With ``control``, the
    control's extraction numbers against the reference too, under
    ``"control"`` in the second dict."""
    chk = run.traffic["check"]
    world, dev = run.world, run.device
    sample = check.draw(world, run.records, run.seed, chk["windows"], chk["max_precursors"])
    prog = check.program_outputs(run.records, sample)
    prog_cfg = run.config["program"]
    ref_dia = check.reference_dia(world, sample.slots, prog_cfg["n_scan_bins"], prog_cfg["coarse_bin_width"])
    numbers = {"store_diff": check.store_diff(run.dia, ref_dia, sample.slots, dev)}
    cfg, om = run.loop.cfg, run.loop.om()
    run.records.clear()
    run.loop = None
    run.dia.free_device()
    run.dia = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.run_reference(world, ref_dia, sample, cfg, om, dev)
    gaps, info = check.compare(prog, ref)
    numbers.update(gaps)
    info["sampled precursors"] = len(sample.rows)
    info["reference's widest read (peaks)"] = ref["widest_read"]
    info["program's slab (peaks)"] = cfg["tpu"]["gather_slab"]
    if control:
        info["control"] = check.compare(check.run_reference(world, ref_dia, sample, cfg, om, dev, control=True), ref)[0]
    return numbers, info
