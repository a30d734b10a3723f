# The model of alphadia_torch/testing/synthetic.py (make_synthetic_dia, lines
# 66-273, and add_synthetic_decoys, lines 396-446, at commit b5dd55e):
# Gaussian elution in RT (and mobility), isotope envelopes in MS1, b/y-like
# fragments in the precursor's window, ppm error on observed peaks, a library
# with an m/z bias and an RT error, uniform noise peaks, one decoy a target.
# Rewritten so that the peaks are drawn on the card from the seed in a few
# large calls; the draws are not those of the original. Exact counts (targets,
# detectable targets, noise peaks per spectrum) keep the work the same for
# every seed.
"""One synthetic DIA run and its library, made from a seed.

``make_world(cfg, seed, device)`` returns a :class:`World` of numpy arrays:
the spectra (sorted by spectrum, then m/z), the flat library (targets and
decoys interleaved, row ``2 i`` target ``i``, row ``2 i + 1`` its decoy)
and the planted truth of every library row. Nothing here imports the
program: the harness hands the spectra to the program, the reference builds
its own store from them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MASS_NEUTRON_AVG = 1.0033548378
_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


@dataclass
class World:
    rt: np.ndarray  # f32[n_spectra] spectrum RT (s)
    ms_level: np.ndarray  # u8[n_spectra]
    isolation_lower_mz: np.ndarray  # f32[n_spectra], -1 for MS1
    isolation_upper_mz: np.ndarray
    spec_start: np.ndarray  # i64[n_spectra + 1] first peak of each spectrum, then the total
    mz: np.ndarray  # f32[n_peaks]
    intensity: np.ndarray  # f32[n_peaks]
    mobility: np.ndarray | None  # f32[n_peaks] (4D) or None
    precursor: dict  # library columns, one row a precursor
    fragment: dict  # library fragment columns
    truth: dict  # per library row: detectable, apex_cycle, mobility
    n_slots: int
    n_cycles: int
    cycle_time: float
    window_edges: np.ndarray  # f64[n_windows + 1]

    @property
    def n_spectra(self) -> int:
        return len(self.rt)

    def slot_isolation(self) -> np.ndarray:
        """f64[n_slots, 2] isolation bounds of each slot (-1 for MS1)."""
        return np.stack([self.isolation_lower_mz[: self.n_slots], self.isolation_upper_mz[: self.n_slots]], 1).astype(
            np.float64
        )


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def _normal(g, shape, device):
    return torch.randn(shape, generator=g, device=device, dtype=torch.float64)


def _sequences(g, n: int, device) -> np.ndarray:
    """n random peptide sequences of 7 to 15 residues, as numpy str."""
    lens = torch.randint(7, 16, (n,), generator=g, device=device)
    codes = torch.randint(0, 20, (n, 15), generator=g, device=device)
    codes = torch.where(torch.arange(15, device=device)[None, :] < lens[:, None], codes, -1).cpu().numpy()
    letters = np.where(codes >= 0, _AA[codes.clip(0)], 0).astype(np.uint8)
    return np.ascontiguousarray(letters).view("S15").ravel().astype("U15")


def make_world(cfg: dict, seed: int, device) -> World:
    """The run and library of configuration ``cfg`` (the ``world`` group of
    a configuration file) from ``seed``, drawn on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2**63))

    n_windows = int(cfg["n_windows"])
    n_slots = n_windows + 1
    n_cycles = int(cfg["n_cycles"])
    cycle_time = float(cfg["cycle_time"])
    lo, hi = (float(v) for v in cfg["precursor_mz_range"])
    flo, fhi = (float(v) for v in cfg["fragment_mz_range"])
    F = int(cfg["n_fragments"])
    K = int(cfg["n_isotopes"])
    n_t = int(cfg["n_targets"])
    n_det = int(cfg["n_detectable"])
    mobility = bool(cfg.get("with_mobility", False))
    mlo, mhi = (float(v) for v in cfg.get("mobility_range", (0.6, 1.6)))
    base = float(cfg["base_intensity"])
    gradient = n_cycles * cycle_time
    edges = np.linspace(lo, hi, n_windows + 1)
    n_spectra = n_cycles * n_slots

    # ---- acquisition ---------------------------------------------------
    slot_off = np.arange(n_slots) * (cycle_time / n_slots)
    spec_rt = (np.repeat(np.arange(n_cycles) * cycle_time, n_slots) + np.tile(slot_off, n_cycles)).astype(np.float32)
    iso_lo = np.tile(np.concatenate([[-1.0], edges[:-1]]), n_cycles).astype(np.float32)
    iso_hi = np.tile(np.concatenate([[-1.0], edges[1:]]), n_cycles).astype(np.float32)
    ms_level = np.tile(np.concatenate([[1], np.full(n_windows, 2)]).astype(np.uint8), n_cycles)

    # ---- targets ---------------------------------------------------------
    pmz = _uniform(g, n_t, lo + 0.5, hi - 0.5, dev)
    rt_center = _uniform(g, n_t, 0.08, 0.92, dev) * gradient
    charge = 2 + torch.randint(0, 2, (n_t,), generator=g, device=dev)
    amplitude = base * 10 ** (0.5 * _normal(g, n_t, dev))
    detectable = torch.zeros(n_t, dtype=torch.bool, device=dev)
    detectable[torch.randperm(n_t, generator=g, device=dev)[:n_det]] = True
    window_of = ((pmz - lo) / ((hi - lo) / n_windows)).long().clamp(0, n_windows - 1)
    frag_mz = _uniform(g, (n_t, F), flo, fhi, dev).sort(dim=1).values
    e = -torch.log(_uniform(g, (n_t, F), 1e-12, 1.0, dev))
    frag_rel = (e / e.sum(1, keepdim=True)).float()
    iso_rel = torch.stack(
        [torch.ones(n_t, device=dev, dtype=torch.float64), _uniform(g, n_t, 0.3, 0.9, dev), _uniform(g, n_t, 0.1, 0.4, dev)],
        1,
    )[:, :K].float()
    frag_charge = 1 + torch.randint(0, 2, (n_t, F), generator=g, device=dev)
    mob_center = _uniform(g, n_t, mlo, mhi, dev)

    # ---- signal peaks: (detectable target, cycle, ion) grids -------------
    sigma = float(cfg["fwhm_rt"]) / 2.3548
    h = int(np.ceil(3 * sigma / cycle_time))
    det = torch.nonzero(detectable).squeeze(1)
    c_center = (rt_center[det] / cycle_time).long()
    cyc = c_center[:, None] + torch.arange(-h, h + 1, device=dev)[None, :]  # [n_det, 2h+1]
    in_run = (cyc >= 0) & (cyc < n_cycles)
    ppm = float(cfg["peak_ppm_sigma"]) * 1e-6
    mob_sigma = float(cfg.get("mobility_fwhm", 0.08)) / 2.3548

    def emit(slot, ion_mz, ion_rel, scale):
        """(spectrum, m/z, intensity, mobility) of the kept peaks of ions
        ``ion_mz`` [n_det, k] in ``slot`` [n_det]."""
        k = ion_mz.shape[1]
        srt = (cyc * cycle_time).double() + slot[:, None].double() * (cycle_time / n_slots)
        prof = torch.exp(-0.5 * ((srt - rt_center[det][:, None]) / sigma) ** 2)  # [n_det, C]
        inten = amplitude[det][:, None, None] * ion_rel[det][:, None, :].double() * prof[:, :, None] * scale
        noise = _normal(g, inten.shape, dev)
        mnoise = _normal(g, inten.shape, dev) if mobility else None
        keep = (inten > 1.0) & in_run[:, :, None]
        spec = (cyc * n_slots + slot[:, None])[:, :, None].expand(-1, -1, k)[keep]
        mz = (ion_mz[det][:, None, :] * (1.0 + ppm * noise))[keep]
        mob = (mob_center[det][:, None, None] + mob_sigma * mnoise)[keep] if mobility else None
        return spec, mz.float(), inten[keep].float(), None if mob is None else mob.float()

    parts = [emit(1 + window_of[det], frag_mz, frag_rel, 1.0)]
    iso_mz = pmz[:, None] + MASS_NEUTRON_AVG * torch.arange(K, device=dev)[None, :] / charge[:, None]
    parts.append(emit(torch.zeros_like(det), iso_mz, iso_rel, 2.0))

    # ---- noise: a fixed count a spectrum ---------------------------------
    for level, count in ((1, int(cfg["ms1_noise_peaks_per_spectrum"])), (2, int(cfg["noise_peaks_per_spectrum"]))):
        specs = torch.from_numpy(np.nonzero(ms_level == level)[0]).to(dev)
        spec = specs.repeat_interleave(count)
        n = len(spec)
        mz = _uniform(g, n, flo, fhi, dev).float()
        inten = (base * 0.05 * 10 ** (0.4 * _normal(g, n, dev))).float()
        mob = _uniform(g, n, mlo, mhi, dev).float() if mobility else None
        parts.append((spec, mz, inten, mob))

    spec = torch.cat([p[0] for p in parts])
    mz = torch.cat([p[1] for p in parts])
    inten = torch.cat([p[2] for p in parts])
    mob = torch.cat([p[3] for p in parts]).clamp(mlo, mhi) if mobility else None
    del parts
    order = torch.sort(mz, stable=True).indices
    order = order[torch.sort(spec[order], stable=True).indices]
    counts = torch.bincount(spec, minlength=n_spectra)
    spec_start = np.zeros(n_spectra + 1, np.int64)
    np.cumsum(counts.cpu().numpy(), out=spec_start[1:])
    mz_h = mz[order].cpu().numpy()
    inten_h = inten[order].cpu().numpy()
    mob_h = mob[order].cpu().numpy() if mobility else None
    del spec, mz, inten, mob, order

    # ---- library: targets and decoys interleaved ------------------------
    bias = float(cfg["lib_ppm_bias"]) * 1e-6
    lib_mz = pmz / (1.0 + bias)
    lib_frag = frag_mz / (1.0 + bias)
    lib_rt = rt_center + float(cfg["lib_rt_sigma"]) * _normal(g, n_t, dev)
    lib_mob = mob_center + float(cfg.get("lib_mobility_sigma", 0.01)) * _normal(g, n_t, dev)
    sign = torch.where(torch.rand(n_t, generator=g, device=dev) < 0.5, -1.0, 1.0).double()
    decoy_mz = lib_mz + _uniform(g, n_t, 0.15, 0.45, dev) * sign
    fsign = torch.where(torch.rand((n_t, F), generator=g, device=dev) < 0.5, -1.0, 1.0).double()
    decoy_frag = lib_frag + _uniform(g, (n_t, F), 3.0, 17.0, dev) * fsign

    def pair(t, d):  # rows 2i (target), 2i+1 (decoy)
        return torch.stack([t, d], 1).reshape(2 * n_t, *t.shape[1:]).cpu().numpy()

    def twice(t):
        return pair(t, t)

    n = 2 * n_t
    sequence = _sequences(g, n, dev)
    precursor = {
        "precursor_idx": np.arange(n, dtype=np.uint32),
        "elution_group_idx": np.repeat(np.arange(n_t, dtype=np.uint32), 2),
        "channel": np.zeros(n, np.uint32),
        "decoy": np.tile(np.array([0, 1], np.uint8), n_t),
        "charge": twice(charge).astype(np.uint8),
        "mz_library": pair(lib_mz, decoy_mz).astype(np.float32),
        "rt_library": twice(lib_rt).astype(np.float32),
        "mobility_library": (twice(lib_mob) if mobility else np.zeros(n)).astype(np.float32),
        "sequence": sequence,
        "nAA": np.char.str_len(sequence).astype(np.uint8),
        "flat_frag_start_idx": (np.arange(n, dtype=np.int64) * F).astype(np.uint32),
        "flat_frag_stop_idx": ((np.arange(n, dtype=np.int64) + 1) * F).astype(np.uint32),
    }
    for i in range(K):
        precursor[f"i_{i}"] = twice(iso_rel[:, i])
    number = np.tile(np.arange(1, F + 1, dtype=np.uint8), n)
    fragment = {
        "mz_library": pair(lib_frag, decoy_frag).astype(np.float32).ravel(),
        "intensity": twice(frag_rel).ravel(),
        "cardinality": np.ones(n * F, np.uint8),
        "type": np.tile(np.where(np.arange(F) % 2 == 0, 98, 121).astype(np.uint8), n),
        "loss_type": np.zeros(n * F, np.uint8),
        "charge": twice(frag_charge).astype(np.uint8).ravel(),
        "number": number,
        "position": (number - 1).astype(np.uint8),
    }
    truth = {
        "detectable": pair(detectable, torch.zeros_like(detectable)),
        "apex_cycle": twice((rt_center / cycle_time).round().long()).astype(np.int64),
        "mobility": twice(mob_center).astype(np.float32),
    }
    return World(
        rt=spec_rt, ms_level=ms_level, isolation_lower_mz=iso_lo, isolation_upper_mz=iso_hi, spec_start=spec_start,
        mz=mz_h, intensity=inten_h, mobility=mob_h, precursor=precursor, fragment=fragment, truth=truth,
        n_slots=n_slots, n_cycles=n_cycles, cycle_time=cycle_time, window_edges=edges,
    )
