"""What the per-layer metrics read, shared by the readers in
``perfbench/metrics`` (one file a metric). Each returns None where the run
holds nothing to read."""

from __future__ import annotations

from perfbench.bench import roofline


def device_idle(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s


def kernels_per_kprec(run):
    tr = run.trace
    work = sum(r["work"] for r in run.traced)
    if tr is None or not tr.kernels or not work:
        return None
    return tr.kernels / (work / 1000.0)


def xic_roofline(run):
    """The least time of the XIC function's work on the traced units over
    the device time of the kernels named ``xic`` in the trace, in %.
    Selection's queries count where the XIC kernel runs selection (3D data);
    the 4D path selects with plain extractions."""
    tr = run.trace
    kernel_s = tr.device_time(lambda name: "xic" in name.lower()) if tr is not None else 0.0
    if not kernel_s:
        return None
    om = run.loop.om()
    world = run.world
    index = roofline.PeakIndex(world, run.device)
    work = roofline.Work()
    for rec in run.traced:
        if world.mobility is None:
            q = roofline.precursor_queries(world, rec["rows"], rec["rt"], om["ms1_error"], om["ms2_error"],
                                           om["rt_error"])
            work.add(index.count(q))
        if len(rec["cand"]["precursor_idx"]):
            work.add(index.count(roofline.candidate_queries(world, rec["cand"], om["ms1_error"], om["ms2_error"])))
    del index
    return 100.0 * work.least_s() / kernel_s
