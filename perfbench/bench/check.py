"""What decides ``correct``: the program's outputs against the plain reference.

After the window the harness draws from the seed some of the run's
isolation windows, and from the precursors that the window sent through the
program those whose m/z lies in them (at most ``max_precursors``). The
reference (``perfbench/reference``, plain PyTorch in float32 with TF32 off)
builds its own peak store of those slots from the run's spectra and selects
and scores the same precursors at the same RTs and tolerances. The numbers
compared (each at most its limit, from ``perfbench/checks/<cell>.json``):

- ``store_diff``: rows and cell offsets of the sampled slots in which the
  program's store on the card (``DiaData.device_arrays``) differs from the
  reference's, bit for bit;
- ``selection_gap``: the candidates (keyed by precursor, rank, frames and
  scans) and their scores: the sum of |program - reference| over the union
  of candidates, a candidate that one side lacks counting as 0 there, over
  the sum of the reference's |score|;
- ``feature_gap``: the same for each of the 46 scoring features over the
  union of PSMs, the largest;
- ``frag_gap``: the same for each fragment quantity (height, intensity,
  correlation, mass error, observed m/z) over the union of fragments, the
  largest.

The reference's XICs are the definition's: every peak of the slot within
the ppm window in each cycle of the window (``reference/xic.py`` reads the
whole window, where the program reads at most ``tpu.gather_slab`` peaks).

The control is the reference one precision step down (TF32 in selection's
float32 products, scaled float8 in scoring's bfloat16 chains) in the
program's place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.settings import MASS_NEUTRON_AVG
from perfbench.reference.diadata import DiaData as RefDia
from perfbench.reference.scoring import FEATURE_COLUMNS, CandidateScoring, ScoringConfig
from perfbench.reference.selection import CandidateSelection, SelectionConfig
from perfbench.reference import xic as ref_xic

FRAG_COLUMNS = ("height", "intensity", "correlation", "mass_error", "mz_observed")
CAND_KEY = ("rank", "frame_start", "frame_center", "frame_stop", "scan_start", "scan_center", "scan_stop")
PSM_KEY = ("precursor_idx", "rank", "frame_center", "scan_center")
FRAG_KEY = ("precursor_idx", "rank", "number", "type", "charge")


@dataclass
class Sample:
    slots: np.ndarray  # the run's slots of the reference store: 0 (MS1), then the sampled windows' slots
    rows: np.ndarray  # library rows
    rt: np.ndarray  # each row's library RT as the window sent it


def draw(world, records: list[dict], seed: int, n_windows: int, max_precursors: int) -> Sample:
    """The sampled windows (each with the next one) and the precursors of
    ``records`` whose isotope envelope meets only windows of the sample; a
    row sent more than once is taken as first sent."""
    rng = np.random.default_rng([int(seed), 17])
    n_win = len(world.window_edges) - 1
    wins = rng.choice(n_win, size=min(n_windows, n_win), replace=False)
    wins = np.unique(np.concatenate([wins, np.minimum(wins + 1, n_win - 1)]))
    rows = np.concatenate([r["rows"] for r in records]) if records else np.zeros(0, np.int64)
    rt = np.concatenate([r["rt"] for r in records]) if records else np.zeros(0, np.float32)
    rows, first = np.unique(rows, return_index=True)
    rt = rt[first]
    # the windows that a precursor's envelope (mono to the last isotope) meets,
    # with a margin, as the drivers assign observations (search/common)
    prec = world.precursor
    n_iso = sum(1 for k in prec if k.startswith("i_"))
    mono = prec["mz_library"][rows].astype(np.float64)
    last = mono + MASS_NEUTRON_AVG * (n_iso - 1) / prec["charge"][rows].astype(np.float64)
    lo = np.searchsorted(world.window_edges, mono - 1e-3, side="right") - 1
    hi = np.searchsorted(world.window_edges, last + 1e-3, side="left") - 1
    lo, hi = np.clip(lo, 0, n_win - 1), np.clip(hi, 0, n_win - 1)
    ok = np.zeros(n_win + 1, np.int64)
    ok[wins] = 1
    covered = np.concatenate([[0], np.cumsum(ok)])  # windows of the sample below each index
    keep = (covered[hi + 1] - covered[lo]) == (hi - lo + 1)
    rows, rt = rows[keep], rt[keep]
    if len(rows) > max_precursors:
        pick = np.sort(rng.choice(len(rows), size=max_precursors, replace=False))
        rows, rt = rows[pick], rt[pick]
    return Sample(slots=np.concatenate([[0], 1 + wins]).astype(np.int64), rows=rows, rt=rt)


def program_outputs(records: list[dict], sample: Sample) -> dict:
    """The program's candidates, PSMs and fragments of the sampled rows, each
    from the record that first sent it."""
    taken = np.zeros(0, np.int64)
    out = {"cand": [], "psm": [], "frag": []}
    for r in records:
        mine = np.setdiff1d(np.intersect1d(r["rows"], sample.rows), taken)
        taken = np.union1d(taken, mine)
        for k in out:
            frame = r[k]
            keep = np.isin(frame["precursor_idx"].astype(np.int64), mine)
            out[k].append({c: v[keep] for c, v in frame.items()})
    return {k: _concat(v) for k, v in out.items()}


def _concat(frames: list[dict]) -> dict:
    frames = [f for f in frames if f]
    if not frames:
        return {}
    cols = set(frames[0]).intersection(*frames[1:])
    return {c: np.concatenate([f[c] for f in frames]) for c in cols}


def reference_dia(world, slots: np.ndarray, n_scan_bins: int, coarse_bin_width: float) -> RefDia:
    """The reference's store of ``slots`` from the run's spectra (numpy
    builder), on the run's m/z and mobility grid."""
    n_slots = world.n_slots
    spec = (np.arange(world.n_cycles)[:, None] * n_slots + slots[None, :]).ravel()
    a, b = world.spec_start[spec], world.spec_start[spec + 1]
    counts = b - a
    idx = np.concatenate([np.arange(x, y) for x, y in zip(a, b)]) if len(a) else np.zeros(0, np.int64)
    spec_start = np.zeros(len(spec) + 1, np.int64)
    np.cumsum(counts, out=spec_start[1:])
    iso = world.slot_isolation()[slots]
    cycle = iso[None, :, None, :]
    mob = world.mobility
    return RefDia.from_slots(
        cycle=cycle, rt_values=world.rt[spec], mz=world.mz[idx], intensity=world.intensity[idx],
        mobility=None if mob is None else mob[idx], spec_start=spec_start, n_cycles=world.n_cycles,
        mz_min=float(world.mz.min()), mz_max=float(world.mz.max()),
        mobility_range=None if mob is None else (float(mob.min()), float(mob.max())),
        n_scan_bins=n_scan_bins, coarse_bin_width=coarse_bin_width,
    )


def extraction_configs(config: dict, om: dict, compute_dtype: str) -> tuple[SelectionConfig, ScoringConfig]:
    """The drivers' settings as the extraction handler derives them from the
    configuration and the optimization state ``om``."""
    s, t = config["search"], config["tpu"]
    sel = SelectionConfig(
        rt_tolerance=om["rt_error"], precursor_mz_tolerance=om["ms1_error"], fragment_mz_tolerance=om["ms2_error"],
        candidate_count=int(om["num_candidates"]), top_k_fragments=s["top_k_fragments_selection"],
        exclude_shared_ions=s["exclude_shared_ions"], fwhm_rt=om["fwhm_rt"], batch_size=t["selection_batch"],
        gather_slab=t["gather_slab"], coarsen_wide_windows=t["coarsen_wide_windows"],
    )
    sco = ScoringConfig(
        precursor_mz_tolerance=om["ms1_error"], fragment_mz_tolerance=om["ms2_error"],
        top_k_fragments=s["top_k_fragments_scoring"], exclude_shared_ions=s["exclude_shared_ions"],
        quant_window=s["quant_window"], quant_all=s["quant_all"], experimental_xic=s["experimental_xic"],
        batch_size=t["scoring_batch"], gather_slab=t["gather_slab"], quad_sigma=tuple(om["quad_sigma"]),
        quad_delta_mu=tuple(om["quad_delta_mu"]), compute_dtype=compute_dtype,
    )
    return sel, sco


def run_reference(world, dia: RefDia, sample: Sample, config: dict, om: dict, device, control: bool = False) -> dict:
    """The reference's candidates, PSMs and fragments of the sample; with
    ``control`` one precision step down."""
    prec = {k: v[sample.rows] for k, v in world.precursor.items()}
    prec["rt_library"] = sample.rt.astype(np.float32)
    sel_cfg, sco_cfg = extraction_configs(config, om, "float8" if control else "float32")
    ref_xic.WIDEST["peaks"] = 0
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(control)
    try:
        cand = CandidateSelection(dia, prec, world.fragment, sel_cfg, device=device)()
        psm, frag = CandidateScoring(dia, prec, world.fragment, sco_cfg, device=device)(cand)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    return {"cand": cand, "psm": psm, "frag": frag, "widest_read": ref_xic.WIDEST["peaks"]}


def store_diff(dia_prog, dia_ref: RefDia, slots: np.ndarray, device) -> int:
    """Rows and offsets of the sampled slots that differ between the
    program's store on the card and the reference's, bit for bit."""
    p = dia_prog.device_arrays(1, device)
    r = dia_ref.device_arrays(1, device)
    diff = 0
    for j, s in enumerate(slots):
        cp = p["cell_start"][int(s)].long()
        cr = r["cell_start"][j].long()
        diff += int(((cp - cp[0, 0]) != (cr - cr[0, 0])).sum()) if cp.shape == cr.shape else cr.numel()
        a, b = int(cp[0, 0]), int(cp[-1, -1])
        c, d = int(cr[0, 0]), int(cr[-1, -1])
        if b - a != d - c:
            diff += abs((b - a) - (d - c)) + 1
            continue
        ps, rs = p["peak_store"], r["peak_store"]
        rows = (ps.packed[a:b].view(torch.int32) != rs.packed[c:d].view(torch.int32)).any(1)
        rows |= ps.cycle[a:b] != rs.cycle[c:d]
        rows |= ps.scanbin[a:b] != rs.scanbin[c:d]
        diff += int(rows.sum())
    return diff


def _keyed(frame: dict, cols) -> tuple[np.ndarray, dict]:
    """Rows sorted by the key columns; the keys as one structured array."""
    if not frame or not len(frame.get("precursor_idx", [])):
        return np.zeros(0, dtype=[(c, np.int64) for c in cols]), {}
    keys = np.rec.fromarrays([frame[c].astype(np.int64) for c in cols], names=list(cols))
    order = np.argsort(keys, order=list(cols), kind="stable")
    return keys[order], {c: v[order] for c, v in frame.items()}


def table_gap(prog: dict, ref: dict, key, columns) -> tuple[float, str, int]:
    """The distance of two tables of rows keyed by ``key``: for each column,
    the sum over the union of rows of |program - reference| (a row that one
    side lacks counts as 0 there) over the sum of |reference|; the largest
    over ``columns``, the column that gives it, and the rows on one side only."""
    kp, p = _keyed(prog, key)
    kr, r = _keyed(ref, key)
    union = np.union1d(kp, kr)
    ip, ir = np.searchsorted(union, kp), np.searchsorted(union, kr)
    worst, name = 0.0, ""
    for c in columns:
        a = np.zeros(len(union))
        b = np.zeros(len(union))
        if len(kp):
            a[ip] = np.nan_to_num(p[c].astype(np.float64), nan=0.0, posinf=0.0, neginf=0.0)
        if len(kr):
            b[ir] = np.nan_to_num(r[c].astype(np.float64), nan=0.0, posinf=0.0, neginf=0.0)
        num, den = np.abs(a - b).sum(), np.abs(b).sum()
        gap = (0.0 if num == 0 else float("inf")) if den == 0 else float(num / den)
        if gap > worst or not name:
            worst, name = gap, c
    return worst, name, len(union) * 2 - len(kp) - len(kr)


def compare(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The extraction's numbers of the program's outputs ``prog`` against the
    reference's ``ref`` (``selection_gap``: candidates and their scores;
    ``feature_gap``: the PSMs' 46 features; ``frag_gap``: the fragment
    quantities), and what each came from."""
    sel, _, n_c = table_gap(prog["cand"], ref["cand"], ("precursor_idx",) + CAND_KEY, ("score",))
    feat, f_name, n_p = table_gap(prog["psm"], ref["psm"], PSM_KEY, FEATURE_COLUMNS)
    frag, g_name, n_f = table_gap(prog["frag"], ref["frag"], FRAG_KEY, FRAG_COLUMNS)
    numbers = {"selection_gap": sel, "feature_gap": feat, "frag_gap": frag}
    info = {"candidates_one_side": n_c, "psms_one_side": n_p, "fragments_one_side": n_f, "feature_gap_from": f_name,
            "frag_gap_from": g_name}
    return numbers, info
