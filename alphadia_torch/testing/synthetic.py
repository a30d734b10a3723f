"""Synthetic DIA experiment generator with ground truth.

Produces ``(SpectrumData, precursor, fragment)`` where the library frames
are column dicts: a DIA acquisition of ``n_cycles`` cycles of [1 MS1 +
n_windows MS2 slots]; ``n_peptides`` target precursors with Gaussian
elution profiles, isotope envelopes in MS1 and b/y-like fragment peaks in
their quadrupole window, plus uniform noise peaks; and a flat library whose
coordinates carry a systematic m/z (ppm) and RT bias.

The numpy random calls are the JAX package's, in the same order, so one
seed gives identical arrays in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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
    return spectra, precursor, fragment


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
