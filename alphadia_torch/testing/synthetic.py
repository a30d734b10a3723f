"""Synthetic DIA experiment generator with ground truth.

Produces ``(SpectrumData, precursor, fragment)`` where the library frames
are column dicts: a DIA acquisition of ``n_cycles`` cycles of [1 MS1 +
n_windows MS2 slots]; ``n_peptides`` target precursors with Gaussian
elution profiles, isotope envelopes in MS1 and b/y-like fragment peaks in
their quadrupole window, plus uniform noise peaks; and a flat library whose
coordinates carry a systematic m/z (ppm) and RT bias.

The numpy random calls are the JAX package's, in the same order, so one
seed gives identical arrays in both packages. ``from_sequence=True`` is the
port's own: each peptide's precursor m/z, b/y fragment m/z (with real series
numbers, inside ``fragment_mz_range``) and MS1 isotope envelope come from its
sequence, as a library built from sequences computes them, so that
sequence-derived decoys fall in the same isolation windows as their targets. Its extra draws come from a
generator of their own; the others are made as without it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from alphadia_torch.library import chem
from alphadia_torch.rawdata.source import SpectrumData

_AA = np.array(list("ACDEFGHIKLMNPQRSTVWY"))


@dataclass
class SyntheticConfig:
    n_peptides: int = 500
    n_windows: int = 8
    n_cycles: int = 400
    cycle_time: float = 1.5  # seconds
    precursor_mz_range: tuple = (400.0, 1000.0)
    fragment_mz_range: tuple = (200.0, 1400.0)
    n_fragments: int = 10
    n_isotopes: int = 3
    fwhm_rt: float = 6.0  # seconds
    noise_peaks_per_spectrum: int = 60
    peak_ppm_sigma: float = 2.0  # random mass error on observed peaks
    lib_ppm_bias: float = 4.0  # systematic library->observed ppm bias
    lib_rt_sigma: float = 8.0  # random library RT error (seconds)
    detectable_fraction: float = 0.85  # fraction of library precursors present
    base_intensity: float = 1e4
    seed: int = 0
    acq_seed: int = -1  # acquisition seed (-1 = seed + 1)
    run_intensity_factor: float = 1.0
    run_rt_shift: float = 0.0  # systematic RT shift of the run (seconds)
    with_mobility: bool = False
    mobility_range: tuple = (0.6, 1.4)  # 1/K0
    mobility_fwhm: float = 0.08
    lib_mobility_sigma: float = 0.01
    from_sequence: bool = False  # m/z and isotope envelopes from the sequences


def _random_sequences(rng: np.random.Generator, n: int, length=(7, 15)) -> np.ndarray:
    lens = rng.integers(length[0], length[1] + 1, n)
    return np.array(["".join(rng.choice(_AA, size=ln)) for ln in lens])


def make_synthetic_dia(
    cfg: SyntheticConfig | None = None,
) -> tuple[SpectrumData, dict, dict]:
    """Build the synthetic experiment: (spectra, precursor, fragment)."""
    cfg = cfg or SyntheticConfig()
    rng = np.random.default_rng(cfg.seed)
    acq_rng = np.random.default_rng(cfg.acq_seed if cfg.acq_seed >= 0 else cfg.seed + 1)

    # ---- acquisition scheme -----------------------------------------
    n_slots = cfg.n_windows + 1
    win_edges = np.linspace(*cfg.precursor_mz_range, cfg.n_windows + 1)
    iso_lower = np.concatenate([[-1.0], win_edges[:-1]])
    iso_upper = np.concatenate([[-1.0], win_edges[1:]])
    gradient = cfg.n_cycles * cfg.cycle_time
    n_spectra = cfg.n_cycles * n_slots
    spec_rt = (
        np.repeat(np.arange(cfg.n_cycles) * cfg.cycle_time, n_slots)
        + np.tile(np.arange(n_slots) * (cfg.cycle_time / n_slots), cfg.n_cycles)
    ).astype(np.float32)

    # ---- ground-truth peptides --------------------------------------
    n = cfg.n_peptides
    pmz = rng.uniform(*cfg.precursor_mz_range, n).astype(np.float64)
    # keep away from window edges so each precursor maps to exactly one window
    pmz = np.clip(pmz, cfg.precursor_mz_range[0] + 0.5, cfg.precursor_mz_range[1] - 0.5)
    rt_center = rng.uniform(0.08, 0.92, n) * gradient
    charge = rng.integers(2, 4, n)
    amplitude = cfg.base_intensity * 10 ** rng.normal(0.0, 0.5, n)
    detectable = rng.random(n) < cfg.detectable_fraction
    if cfg.from_sequence:
        seq_rng = np.random.default_rng([cfg.seed, 7])
        sequence, charge, pmz = _sequences_in_range(seq_rng, charge, cfg)
    window_of = np.clip(
        np.searchsorted(win_edges, pmz, side="right") - 1, 0, cfg.n_windows - 1
    )

    F = cfg.n_fragments
    frag_mz = rng.uniform(*cfg.fragment_mz_range, (n, F)).astype(np.float64)
    frag_mz.sort(axis=1)
    frag_rel = rng.dirichlet(np.ones(F) * 1.2, n).astype(np.float32)
    frag_type = np.where(np.arange(F)[None, :] % 2 == 0, 98, 121).astype(np.uint8)
    frag_type = np.broadcast_to(frag_type, (n, F)).copy()
    frag_charge = rng.integers(1, 3, (n, F)).astype(np.uint8)
    frag_number = np.broadcast_to(np.arange(1, F + 1, dtype=np.uint8), (n, F)).copy()

    iso_rel = np.stack(
        [np.ones(n), rng.uniform(0.3, 0.9, n), rng.uniform(0.1, 0.4, n)], axis=1
    )[:, : cfg.n_isotopes].astype(np.float32)
    if cfg.from_sequence:
        frag_mz, frag_number, frag_charge = _sequence_fragments(
            seq_rng, sequence, frag_type, frag_charge, cfg.fragment_mz_range
        )
        frag_mz *= 1.0 + cfg.lib_ppm_bias * 1e-6
        env = chem.isotope_envelopes(chem.peptide_compositions(list(sequence)), k_max=cfg.n_isotopes)
        iso_rel = (env / env[:, :1]).astype(np.float32)

    rt_center_obs = rt_center + cfg.run_rt_shift
    amplitude = amplitude * cfg.run_intensity_factor
    sigma = cfg.fwhm_rt / 2.3548
    half_width_cycles = int(np.ceil(3 * sigma / cfg.cycle_time))

    # ---- emit peaks (vectorized over (peptide, cycle, ion) grids) -----
    mob_center = rng.uniform(*cfg.mobility_range, n)
    mob_sigma = cfg.mobility_fwhm / 2.3548
    iso_spacing = 1.0033548378

    det_idx = np.nonzero(detectable)[0]
    c_center = rt_center_obs[det_idx] / cfg.cycle_time
    c0 = np.maximum(0, c_center.astype(np.int64) - half_width_cycles)
    c1 = np.minimum(cfg.n_cycles - 1, c_center.astype(np.int64) + half_width_cycles)
    pair_p = np.repeat(det_idx, c1 - c0 + 1)
    pair_c = np.concatenate([np.arange(a, b + 1) for a, b in zip(c0, c1)])

    def _emit(spec_idx_of_pair, ion_mz, ion_rel, amp_scale):
        """Expand (pair, ion) -> kept peaks. ion_mz/ion_rel: [n, K]."""
        K = ion_mz.shape[1]
        s_of = np.repeat(spec_idx_of_pair, K)
        p_of = np.repeat(pair_p, K)
        prof = np.exp(
            -0.5
            * ((spec_rt[spec_idx_of_pair] - rt_center_obs[pair_p]) / sigma).astype(
                np.float64
            )
            ** 2
        )
        inten = (
            amplitude[pair_p][:, None] * ion_rel[pair_p] * prof[:, None] * amp_scale
        ).ravel()
        keep = inten > 1.0
        mzk = ion_mz[pair_p].ravel()[keep]
        mz_obs = mzk * (1.0 + acq_rng.normal(0, cfg.peak_ppm_sigma * 1e-6, keep.sum()))
        out = [s_of[keep], mz_obs, inten[keep].astype(np.float32)]
        if cfg.with_mobility:
            out.append(
                (
                    mob_center[p_of[keep]] + acq_rng.normal(0, mob_sigma, keep.sum())
                ).astype(np.float32)
            )
        return out

    ms2_emit = _emit(pair_c * n_slots + 1 + window_of[pair_p], frag_mz, frag_rel, 1.0)
    iso_mz_all = (
        pmz[:, None] + iso_spacing * np.arange(cfg.n_isotopes)[None, :] / charge[:, None]
    )
    ms1_emit = _emit(pair_c * n_slots, iso_mz_all, iso_rel, 2.0)

    lo, hi = cfg.fragment_mz_range
    k = cfg.noise_peaks_per_spectrum
    noise_emit = [
        np.repeat(np.arange(n_spectra), k),
        acq_rng.uniform(lo, hi, n_spectra * k),
        (cfg.base_intensity * 0.05 * 10 ** acq_rng.normal(0, 0.4, n_spectra * k)).astype(
            np.float32
        ),
    ]
    if cfg.with_mobility:
        noise_emit.append(
            acq_rng.uniform(*cfg.mobility_range, n_spectra * k).astype(np.float32)
        )

    # ---- assemble flat arrays (sort by (spectrum, mz)) ----------------
    s_all = np.concatenate([ms2_emit[0], ms1_emit[0], noise_emit[0]])
    mz_all = np.concatenate([ms2_emit[1], ms1_emit[1], noise_emit[1]])
    int_all = np.concatenate([ms2_emit[2], ms1_emit[2], noise_emit[2]])
    order = np.lexsort((mz_all, s_all))
    s_all = s_all[order]
    mobility = None
    if cfg.with_mobility:
        mobility = np.concatenate([ms2_emit[3], ms1_emit[3], noise_emit[3]])[order]
    counts = np.bincount(s_all, minlength=n_spectra).astype(np.int64)
    start = np.zeros(n_spectra, dtype=np.int64)
    np.cumsum(counts[:-1], out=start[1:])

    spectra = SpectrumData(
        rt=spec_rt,
        ms_level=np.tile(
            np.concatenate([[1], np.full(cfg.n_windows, 2)]).astype(np.uint8),
            cfg.n_cycles,
        ),
        isolation_lower_mz=np.tile(iso_lower, cfg.n_cycles).astype(np.float32),
        isolation_upper_mz=np.tile(iso_upper, cfg.n_cycles).astype(np.float32),
        peak_start_idx=start,
        peak_stop_idx=start + counts,
        mz=mz_all[order].astype(np.float32),
        intensity=int_all[order],
        mobility=mobility,
    )

    # ---- library (with systematic bias vs observed) -------------------
    lib_mz = pmz / (1.0 + cfg.lib_ppm_bias * 1e-6)
    lib_frag_mz = frag_mz / (1.0 + cfg.lib_ppm_bias * 1e-6)
    lib_rt = rt_center + rng.normal(0, cfg.lib_rt_sigma, n)
    mobility_library = (
        (mob_center + rng.normal(0, cfg.lib_mobility_sigma, n)).astype(np.float32)
        if cfg.with_mobility
        else np.zeros(n, dtype=np.float32)
    )
    if not cfg.from_sequence:
        sequence = _random_sequences(rng, n)
    precursor = {
        "precursor_idx": np.arange(n, dtype=np.uint32),
        "elution_group_idx": np.arange(n, dtype=np.uint32),
        "channel": np.zeros(n, dtype=np.uint32),
        "decoy": np.zeros(n, dtype=np.uint8),
        "charge": charge.astype(np.uint8),
        "mz_library": lib_mz.astype(np.float32),
        "rt_library": lib_rt.astype(np.float32),
        "mobility_library": mobility_library,
        "sequence": sequence,
        "mods": np.array([""] * n, dtype=object),
        "mod_sites": np.array([""] * n, dtype=object),
        "proteins": np.array([f"PROT{j % 50}" for j in range(n)], dtype=object),
        "genes": np.array([f"GENE{j % 50}" for j in range(n)], dtype=object),
        "flat_frag_start_idx": (np.arange(n) * F).astype(np.uint32),
        "flat_frag_stop_idx": ((np.arange(n) + 1) * F).astype(np.uint32),
        # ground truth (not part of the library contract)
        "_truth_detectable": detectable,
        "_truth_rt": rt_center.astype(np.float32),
        "_truth_mobility": mob_center.astype(np.float32),
    }
    for i in range(cfg.n_isotopes):
        precursor[f"i_{i}"] = iso_rel[:, i]
    precursor["nAA"] = np.char.str_len(sequence).astype(np.uint8)

    fragment = {
        "mz_library": lib_frag_mz.ravel().astype(np.float32),
        "intensity": frag_rel.ravel().astype(np.float32),
        "cardinality": np.ones(n * F, dtype=np.uint8),
        "type": frag_type.ravel(),
        "loss_type": np.zeros(n * F, dtype=np.uint8),
        "charge": frag_charge.ravel(),
        "number": frag_number.ravel(),
        "position": (frag_number.ravel() - 1).astype(np.uint8),
    }
    if cfg.from_sequence:  # the cleavage site: y_k sits at nAA - 1 - k
        naa = np.repeat(precursor["nAA"].astype(np.int64), F)
        y = fragment["type"] == 121
        fragment["position"][y] = (naa[y] - 1 - frag_number.ravel()[y]).astype(np.uint8)
    return spectra, precursor, fragment


def make_run_from_library(precursor: dict, fragment: dict, cfg: SyntheticConfig | None = None) -> SpectrumData:
    """A synthetic acquisition holding the TARGETS of a flat library: their
    fragments at the library's m/z, eluting at ``rt_norm`` x the gradient.
    Drives the library-free path end to end: digest -> prediction -> this
    generator -> mzML -> search. The JAX package's function, its random
    calls in the same order, on column dicts."""
    cfg = cfg or SyntheticConfig()
    rng = np.random.default_rng(cfg.seed)
    acq_rng = np.random.default_rng(cfg.acq_seed if cfg.acq_seed >= 0 else cfg.seed + 1)

    is_target = precursor["decoy"] == 0 if "decoy" in precursor else np.ones(len(precursor["charge"]), bool)
    targets = {k: v[is_target] for k, v in precursor.items()}
    n_t = int(is_target.sum())
    n_slots = cfg.n_windows + 1
    win_edges = np.linspace(*cfg.precursor_mz_range, cfg.n_windows + 1)
    iso_lower = np.concatenate([[-1.0], win_edges[:-1]])
    iso_upper = np.concatenate([[-1.0], win_edges[1:]])
    gradient = cfg.n_cycles * cfg.cycle_time
    n_spectra = cfg.n_cycles * n_slots
    spec_rt = (
        np.repeat(np.arange(cfg.n_cycles) * cfg.cycle_time, n_slots)
        + np.tile(np.arange(n_slots) * (cfg.cycle_time / n_slots), cfg.n_cycles)
    ).astype(np.float32)

    rt_col = "rt_library" if "rt_library" in targets else "rt_norm"
    rt_norm = targets[rt_col].astype(np.float64)
    if rt_norm.max() > 1.5:  # already absolute
        rt_center = rt_norm
    else:
        rt_center = 0.05 * gradient + rt_norm * 0.9 * gradient
    mz_col = "mz_library" if "mz_library" in targets else "precursor_mz"
    pmz = targets[mz_col].astype(np.float64)
    charge = targets["charge"].astype(np.int64)
    amplitude = cfg.base_intensity * 10 ** rng.normal(0.0, 0.4, n_t)
    detectable = rng.random(n_t) < cfg.detectable_fraction
    window_of = np.clip(np.searchsorted(win_edges, pmz, side="right") - 1, 0, cfg.n_windows - 1)
    sigma = cfg.fwhm_rt / 2.3548
    half = int(np.ceil(3 * sigma / cfg.cycle_time))
    iso_spacing = 1.0033548378

    spec_mz: list[list] = [[] for _ in range(n_spectra)]
    spec_int: list[list] = [[] for _ in range(n_spectra)]
    spec_mob: list[list] = [[] for _ in range(n_spectra)]
    # planted mobility: the library's where it has one, else drawn
    if "mobility_library" in targets and np.abs(targets["mobility_library"]).max() > 0:
        mob_center = targets["mobility_library"].astype(np.float64)
    else:
        mob_center = rng.uniform(*cfg.mobility_range, n_t)
    mob_sigma = cfg.mobility_fwhm / 2.3548
    fmz_col = "mz_library" if "mz_library" in fragment else "mz"
    frag_mz_all = fragment[fmz_col].astype(np.float64)
    frag_int_all = fragment["intensity"].astype(np.float64)

    for i in range(n_t):
        if not detectable[i]:
            continue
        if not (cfg.precursor_mz_range[0] < pmz[i] < cfg.precursor_mz_range[1]):
            continue
        a, b = int(targets["flat_frag_start_idx"][i]), int(targets["flat_frag_stop_idx"][i])
        fmz, fint = frag_mz_all[a:b], frag_int_all[a:b]
        if len(fmz) == 0:
            continue
        c_center = rt_center[i] / cfg.cycle_time
        c0 = max(0, int(c_center) - half)
        c1 = min(cfg.n_cycles - 1, int(c_center) + half)
        slot = 1 + window_of[i]
        for c in range(c0, c1 + 1):
            s = c * n_slots + slot
            prof = np.exp(-0.5 * ((spec_rt[s] - rt_center[i]) / sigma) ** 2)
            inten = amplitude[i] * fint * prof
            keep = inten > 1.0
            if keep.any():
                spec_mz[s].append(fmz[keep] * (1.0 + acq_rng.normal(0, cfg.peak_ppm_sigma * 1e-6, keep.sum())))
                spec_int[s].append(inten[keep].astype(np.float32))
                if cfg.with_mobility:
                    spec_mob[s].append((mob_center[i] + acq_rng.normal(0, mob_sigma, int(keep.sum()))).astype(np.float32))
            s1 = c * n_slots
            prof1 = np.exp(-0.5 * ((spec_rt[s1] - rt_center[i]) / sigma) ** 2)
            iso_int = amplitude[i] * np.array([1.0, 0.6, 0.3]) * prof1 * 2
            keep1 = iso_int > 1.0
            if keep1.any():
                iso_mz = pmz[i] + iso_spacing * np.arange(3)[keep1] / charge[i]
                spec_mz[s1].append(iso_mz * (1.0 + acq_rng.normal(0, cfg.peak_ppm_sigma * 1e-6, keep1.sum())))
                spec_int[s1].append(iso_int[keep1].astype(np.float32))
                if cfg.with_mobility:
                    spec_mob[s1].append((mob_center[i] + acq_rng.normal(0, mob_sigma, int(keep1.sum()))).astype(np.float32))

    lo, hi = cfg.fragment_mz_range
    for s in range(n_spectra):
        k = cfg.noise_peaks_per_spectrum
        spec_mz[s].append(acq_rng.uniform(lo, hi, k))
        spec_int[s].append((cfg.base_intensity * 0.05 * 10 ** acq_rng.normal(0, 0.4, k)).astype(np.float32))
        if cfg.with_mobility:
            spec_mob[s].append(acq_rng.uniform(*cfg.mobility_range, k).astype(np.float32))

    counts = np.zeros(n_spectra, dtype=np.int64)
    all_mz, all_int, all_mob = [], [], []
    for s in range(n_spectra):
        mzs = np.concatenate(spec_mz[s])
        ints = np.concatenate(spec_int[s]).astype(np.float32)
        order = np.argsort(mzs, kind="stable")
        all_mz.append(mzs[order].astype(np.float32))
        all_int.append(ints[order])
        if cfg.with_mobility:
            all_mob.append(np.concatenate(spec_mob[s])[order])
        counts[s] = len(mzs)
    start = np.zeros(n_spectra, dtype=np.int64)
    np.cumsum(counts[:-1], out=start[1:])
    return SpectrumData(
        rt=spec_rt,
        ms_level=np.tile(np.concatenate([[1], np.full(cfg.n_windows, 2)]).astype(np.uint8), cfg.n_cycles),
        isolation_lower_mz=np.tile(iso_lower, cfg.n_cycles).astype(np.float32),
        isolation_upper_mz=np.tile(iso_upper, cfg.n_cycles).astype(np.float32),
        peak_start_idx=start,
        peak_stop_idx=start + counts,
        mz=np.concatenate(all_mz),
        intensity=np.concatenate(all_int),
        mobility=np.concatenate(all_mob) if cfg.with_mobility else None,
    )


def add_synthetic_decoys(
    precursor: dict, fragment: dict, seed: int = 99, multiplier: int = 1
) -> tuple[dict, dict]:
    """Append decoy precursors: same RT/window, slightly shifted precursor
    m/z, randomized fragment m/z (nothing planted in the data), sharing the
    target's elution group. ``multiplier`` appends that many decoy copies
    (copies beyond the first get their own elution groups)."""
    rng = np.random.default_rng(seed)
    n = len(precursor["precursor_idx"])
    n_frag_total = len(fragment["mz_library"])
    n_groups = int(precursor["elution_group_idx"].max()) + 1 if n else n

    prec_parts = [precursor]
    frag_parts = [fragment]
    for k in range(multiplier):
        decoy = dict(precursor)
        decoy["decoy"] = np.ones(n, np.uint8)
        decoy["precursor_idx"] = (
            precursor["precursor_idx"].astype(np.int64) + (k + 1) * n
        ).astype(np.uint32)
        decoy["mz_library"] = (
            precursor["mz_library"]
            + rng.uniform(0.15, 0.45, n) * rng.choice([-1, 1], n)
        ).astype(np.float32)
        for col in ("flat_frag_start_idx", "flat_frag_stop_idx"):
            decoy[col] = (
                precursor[col].astype(np.int64) + (k + 1) * n_frag_total
            ).astype(np.uint32)
        if k > 0:
            decoy["elution_group_idx"] = precursor["elution_group_idx"] + k * n_groups
        if "_truth_detectable" in decoy:
            decoy["_truth_detectable"] = np.zeros(n, bool)

        decoy_frag = dict(fragment)
        decoy_frag["mz_library"] = (
            fragment["mz_library"]
            + rng.uniform(3.0, 17.0, n_frag_total) * rng.choice([-1, 1], n_frag_total)
        ).astype(np.float32)
        prec_parts.append(decoy)
        frag_parts.append(decoy_frag)

    def cat(parts):
        return {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}

    return cat(prec_parts), cat(frag_parts)


def _fragment_sites(seq: str, lo: float, hi: float) -> dict:
    """For b (98) and y (121) ions: the series numbers 2 .. nAA - 1 whose ion
    lies in [lo, hi] at charge 1 or 2."""
    ladders = chem.fragment_mz_arrays(seq)
    sites = {}
    for t in (98, 121):
        sites[t] = [
            k for k in range(2, len(seq))
            if any(lo <= ladders[f"{chr(t)}_z{z}"][k - 1 if t == 98 else len(seq) - 1 - k] <= hi for z in (1, 2))
        ]
    return sites


def _sequences_in_range(rng: np.random.Generator, charge: np.ndarray, cfg: SyntheticConfig):
    """Random sequences whose precursor m/z at the drawn charge (or else at
    the other of 2 and 3) lies inside the isolation range, 0.5 from its ends,
    and which have a b and a y ion inside the fragment range for each of
    their fragments of that type; a sequence that fails is drawn again.
    Returns (sequences, charges, observed precursor m/z, which carry the
    library's ppm bias)."""
    lo, hi = cfg.precursor_mz_range[0] + 0.5, cfg.precursor_mz_range[1] - 0.5
    need = {98: (cfg.n_fragments + 1) // 2, 121: cfg.n_fragments // 2}
    n = len(charge)
    sequence = _random_sequences(rng, n).astype(object)
    charge = charge.copy()
    todo = np.arange(n)
    while len(todo):
        left = []
        for i in todo:
            sites = _fragment_sites(sequence[i], *cfg.fragment_mz_range)
            fits = [z for z in (int(charge[i]), 5 - int(charge[i])) if lo <= chem.precursor_mz(sequence[i], z) <= hi]
            if fits and all(len(sites[t]) >= need[t] for t in need):
                charge[i] = fits[0]
            else:
                left.append(i)
        todo = np.array(left, np.int64)
        if len(todo):
            sequence[todo] = _random_sequences(rng, len(todo))
    mz = np.array([chem.precursor_mz(s, int(z)) for s, z in zip(sequence, charge)])
    return sequence.astype(str), charge, mz * (1.0 + cfg.lib_ppm_bias * 1e-6)


def _sequence_fragments(rng: np.random.Generator, sequence, frag_type: np.ndarray, frag_charge: np.ndarray, mz_range):
    """The m/z, series numbers and charges of each peptide's fragments:
    numbers drawn without repeats, for each type, from those whose ion lies
    in ``mz_range``; a fragment keeps its drawn charge where its ion lies in
    the range there, else takes the other of 1 and 2."""
    n, F = frag_type.shape
    mz = np.zeros((n, F), np.float64)
    number = np.zeros((n, F), np.uint8)
    charge = frag_charge.copy()
    lo, hi = mz_range
    for i, seq in enumerate(sequence):
        ladders = chem.fragment_mz_arrays(seq)
        sites = _fragment_sites(seq, lo, hi)
        for t in (98, 121):
            cols = np.nonzero(frag_type[i] == t)[0]
            k = np.sort(rng.choice(sites[t], size=len(cols), replace=False))
            number[i, cols] = k
            for c, kk in zip(cols, k):
                ladder = lambda z: ladders[f"{chr(t)}_z{z}"][kk - 1 if t == 98 else len(seq) - 1 - kk]  # noqa: E731
                z = int(charge[i, c]) if lo <= ladder(int(charge[i, c])) <= hi else 3 - int(charge[i, c])
                charge[i, c] = z
                mz[i, c] = ladder(z)
    return mz, number, charge
