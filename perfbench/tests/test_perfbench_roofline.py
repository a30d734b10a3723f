"""The XIC roofline's count reads the traffic: the same bytes whoever
extracted the candidates, and a brute-force count agrees with it."""

import numpy as np
import pytest

import tiny
from perfbench.bench import check, roofline
from perfbench.bench.cell import prepare


@pytest.fixture(scope="module")
def run_and_ref(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("root"))
    _, run = prepare("tiny3d.final", 41, "cpu", root)
    rec = run.loop.step(run.spans)
    sample = check.Sample(slots=np.arange(run.world.n_slots), rows=rec["rows"], rt=rec["rt"])
    dia = check.reference_dia(run.world, sample.slots, 8, 1.0)
    ref = check.run_reference(run.world, dia, sample, run.loop.cfg, run.loop.om(), "cpu")
    return run, rec, ref


def _brute(world, q):
    """Peaks in each (query, cycle) cell, counted once, by a plain loop."""
    seen, matches = set(), 0
    for i in range(len(q.slot)):
        for c in range(q.c0[i], q.c1[i]):
            s = c * world.n_slots + q.slot[i]
            a, b = world.spec_start[s], world.spec_start[s + 1]
            mz = world.mz[a:b].astype(np.float64)
            tol = q.tol_ppm[i] * 1e-6
            hit = np.flatnonzero((mz >= q.mz[i] * (1 - tol)) & (mz <= q.mz[i] * (1 + tol))) + a
            matches += len(hit)
            seen.update(hit.tolist())
    return len(seen), matches


def test_same_bytes_from_the_program_and_the_plain_version(run_and_ref):
    run, rec, ref = run_and_ref
    om = run.loop.om()
    index = roofline.PeakIndex(run.world, "cpu")
    a = index.count(roofline.candidate_queries(run.world, rec["cand"], om["ms1_error"], om["ms2_error"]))
    b = index.count(roofline.candidate_queries(run.world, ref["cand"], om["ms1_error"], om["ms2_error"]))
    assert (a.bytes, a.ops) == (b.bytes, b.ops) and a.bytes > 0


def test_count_agrees_with_a_plain_loop(run_and_ref):
    run, rec, _ = run_and_ref
    om = run.loop.om()
    rows = rec["rows"][:40]
    q = roofline.precursor_queries(run.world, rows, rec["rt"][:40], om["ms1_error"], om["ms2_error"], om["rt_error"])
    w = roofline.PeakIndex(run.world, "cpu").count(q)
    unique, matches = _brute(run.world, q)
    assert w.ops == roofline.OPS_PER_MATCH * matches
    cells = int(q.cells.sum())
    assert w.bytes == unique * 8 + len(q.slot) * 8 + q.rows * 4 + 4 * cells
    assert matches > 0
