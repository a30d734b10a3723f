"""The DIA peak store: one raw file, cycle-aligned and laid out for slab reads.

Peaks are sorted by (cycle slot, coarse m/z bin, cycle, m/z) with an offset
index ``cell_start[slot, bin, cycle]``, so one XIC query (slot, m/z +- ppm,
cycle window [c0, c0+W)) reads ONE contiguous slab of peaks. Peaks within
``ghost_width`` of a bin edge are duplicated into the neighbouring bin, so a
ppm window centred anywhere in a bin never needs a second slab.

``device_arrays`` returns torch tensors on the chosen device, among them
the :class:`PeakStore` that the CUDA XIC kernel reads: m/z and intensity as
one ``float2`` per peak, and two narrow planes beside them, the cycle
modulo 2**16 (u16) and the scan bin (i16), 2 B a peak each.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from alphadia_torch.constants.settings import NO_MOBILITY_VALUE
from alphadia_torch.rawdata.dia_cycle import determine_dia_cycle
from alphadia_torch.rawdata.peakstore import build_peak_store, build_peak_store_numpy
from alphadia_torch.rawdata.source import SpectrumData
from alphadia_torch.utils.device import bucket_count, resolve_device


class PeakStore(NamedTuple):
    """The peak store on one device, in the layout the XIC kernel reads.
    Every plane has one row per stored peak, N a multiple of 8 (padding
    matches no query), and starts 16-B aligned."""

    packed: torch.Tensor  # f32[N, 2] (m/z, intensity)
    cycle: torch.Tensor  # u16[N] each row's cycle mod 2**16
    scanbin: torch.Tensor  # i16[N] each row's scan bin (0 for 3D data)


@dataclass
class DiaData:
    """One raw file, cycle-aligned and tensorized."""

    cycle: np.ndarray  # f64 (1, n_slots, 1, 2) isolation bounds; -1 = MS1
    rt_values: np.ndarray  # f32[n_cycles * n_slots] seconds
    cycle_rt: np.ndarray  # f32[n_cycles] RT of each cycle (first spectrum)
    n_cycles: int
    n_slots: int
    has_ms1: bool
    has_mobility: bool = False
    mobility_values: np.ndarray = field(
        default_factory=lambda: np.array([NO_MOBILITY_VALUE, 0.0], dtype=np.float32)
    )
    n_scan_bins: int = 1
    peak_scanbin: np.ndarray = None  # i32[n_peaks + pad], 0 for 3D data
    mobility_min: float = 0.0
    mobility_max: float = 0.0

    # peak store sorted by (slot, coarse bin, cycle, mz)
    peak_mz: np.ndarray = None  # f32[n_peaks + pad]
    peak_intensity: np.ndarray = None  # f32[n_peaks + pad]
    # i32[n_slots, n_bins, n_cycles + 1]; i64 past 2**31 stored entries
    # (rawdata/peakstore.cell_index_dtype), so no offset wraps
    cell_start: np.ndarray = None
    n_bins: int = 1
    bin_mz_min: float = 0.0
    coarse_bin_width: float = 1.0
    ghost_width: float = 0.25  # must exceed the largest ppm half-window (Th)
    peak_is_ghost: np.ndarray = None
    _n_canonical: int = 0
    # the C++ builder (csrc/peakstore.cpp); False: its plain numpy version
    use_native: bool = True

    mz_min: float = 0.0
    mz_max: float = 0.0
    quad_min_mz: float = 0.0
    quad_max_mz: float = 0.0

    _device: dict = field(default_factory=dict)

    @classmethod
    def from_spectra(
        cls,
        spectra: SpectrumData,
        coarse_bin_width: float = 1.0,
        n_scan_bins: int = 8,
        mobility_range: tuple[float, float] | None = None,
        use_native: bool = True,
    ) -> "DiaData":
        """Cycle-align and tensorize a raw file: drop non-DIA MS1, detect the
        cycle, truncate to whole cycles, build the slab layout.

        Scan bins split ``mobility_range`` (default: the spectra's own
        mobility range); a part of a run binned with the whole run's range
        has the whole run's scan bins."""
        has_ms1 = True
        if not spectra.is_ms1_dia():
            spectra = spectra.drop_ms1()
            has_ms1 = False

        cycle, cycle_start, n_slots = determine_dia_cycle(
            spectra.rt, spectra.isolation_lower_mz, spectra.isolation_upper_mz
        )
        n_cycles = (spectra.n_spectra - cycle_start) // n_slots
        spectra = spectra.select(
            np.arange(cycle_start, cycle_start + n_cycles * n_slots)
        )

        rt_values = spectra.rt.astype(np.float32)
        quad_mask = cycle[0, :, 0, 0] >= 0
        quad_min = float(cycle[0, quad_mask, 0, 0].min()) if quad_mask.any() else 0.0
        quad_max = float(cycle[0, quad_mask, 0, 1].max()) if quad_mask.any() else 0.0

        if spectra.has_mobility:
            if mobility_range is None:
                mobility_range = (float(spectra.mobility.min()), float(spectra.mobility.max()))
            mob_min, mob_max = (float(v) for v in mobility_range)
            S = max(2, int(n_scan_bins))
            centers = mob_min + (np.arange(S, dtype=np.float32) + 0.5) * (
                (mob_max - mob_min) / S
            )
        else:
            mob_min = mob_max = 0.0
            S = 1
            centers = np.array([NO_MOBILITY_VALUE, 0.0], dtype=np.float32)

        obj = cls(
            cycle=cycle,
            rt_values=rt_values,
            cycle_rt=rt_values[::n_slots].copy(),
            n_cycles=n_cycles,
            n_slots=n_slots,
            has_ms1=has_ms1,
            has_mobility=spectra.has_mobility,
            mobility_values=centers,
            n_scan_bins=S,
            mobility_min=mob_min,
            mobility_max=mob_max,
            quad_min_mz=quad_min,
            quad_max_mz=quad_max,
            coarse_bin_width=coarse_bin_width,
            use_native=use_native,
        )
        obj._build_peak_store(spectra)
        return obj

    def _build_peak_store(self, spectra: SpectrumData) -> None:
        """Sort peaks by (slot, coarse m/z bin, cycle, m/z), duplicate
        bin-edge peaks as ghosts, and build ``cell_start``
        (``rawdata/peakstore``: the C++ builder, or with ``use_native=False``
        its plain numpy version; the same arrays).

        The order is that of the JAX package's default (native) builder:
        bins in float64, and within a cell the spectrum's own m/z order,
        ghosts among the canonical peaks. A query's slab is cut at ``slab``
        peaks and its per-cycle sums depend on the order, so another order
        within a cell changes the selection scores where slabs overflow."""
        if len(spectra.mz):
            self.mz_min = float(spectra.mz.min())
            self.mz_max = float(spectra.mz.max())
        bin_w = self.coarse_bin_width
        self.bin_mz_min = float(np.floor(self.mz_min / bin_w) * bin_w)
        self.n_bins = max(1, int(np.ceil((self.mz_max + bin_w - self.bin_mz_min) / bin_w)))

        spec_start = np.zeros(spectra.n_spectra + 1, np.int64)
        np.cumsum((spectra.peak_stop_idx - spectra.peak_start_idx).astype(np.int64), out=spec_start[1:])
        scanbin = None
        if self.has_mobility:
            S = self.n_scan_bins
            span = max(self.mobility_max - self.mobility_min, 1e-9)
            scanbin = np.clip(((spectra.mobility - self.mobility_min) / span * S).astype(np.int32), 0, S - 1)
        build = build_peak_store if self.use_native else build_peak_store_numpy
        (self.peak_mz, self.peak_intensity, self.peak_is_ghost, self.peak_scanbin, self.cell_start) = build(
            spectra.mz, spectra.intensity, spec_start, self.n_slots, self.n_cycles, self.bin_mz_min, bin_w,
            self.n_bins, self.ghost_width, scanbin=scanbin,
        )
        self._n_canonical = len(spectra.mz)

    @property
    def n_peaks(self) -> int:
        """Number of canonical (non-ghost) peaks."""
        return self._n_canonical

    @property
    def n_stored_peaks(self) -> int:
        """Stored entries (peaks and ghosts): the index's last offset."""
        return int(self.cell_start[-1, -1, -1]) if self.cell_start is not None else 0

    @property
    def rt_min(self) -> float:
        return float(self.cycle_rt[0]) if len(self.cycle_rt) else 0.0

    @property
    def rt_max(self) -> float:
        return float(self.cycle_rt[-1]) if len(self.cycle_rt) else 0.0

    @property
    def cycle_time(self) -> float:
        """Average seconds per DIA cycle."""
        if self.n_cycles < 2:
            return 1.0
        return float((self.cycle_rt[-1] - self.cycle_rt[0]) / (self.n_cycles - 1))

    @property
    def n_cycles_dev(self) -> int:
        """Bucketed cycle count of the device view."""
        return bucket_count(self.n_cycles, minimum=256)

    def packed_store(self) -> np.ndarray:
        """The packed per-peak store f32[N_p, 2]: m/z and intensity.

        Peaks are padded to a quarter-pow2 bucket with m/z +inf and
        intensity 0, so padding matches no query.
        """
        n = len(self.peak_mz)
        n_p = bucket_count(n)
        packed = np.empty((n_p, 2), np.float32)
        packed[:, 0] = np.concatenate([self.peak_mz, np.full(n_p - n, np.inf, np.float32)])
        packed[:, 1] = np.concatenate([self.peak_intensity, np.zeros(n_p - n, np.float32)])
        return packed

    def scanbin_plane(self) -> np.ndarray:
        """The scan bin of every row of :meth:`packed_store`, i16[N_p]
        (0 for 3D data and for padding)."""
        n = len(self.peak_mz)
        if self.n_scan_bins > np.iinfo(np.int16).max:
            raise ValueError(f"{self.n_scan_bins} scan bins do not fit the 16-bit scan-bin plane")
        scanbin = self.peak_scanbin if self.peak_scanbin is not None else np.zeros(n, np.int32)
        return np.concatenate([scanbin, np.zeros(bucket_count(n) - n, np.int32)]).astype(np.int16)

    def cycle_plane(self) -> np.ndarray:
        """The cycle of every row of :meth:`packed_store` modulo 2**16,
        u16[N_p]. A slab spans fewer than 2**16 cycles, so the kernel takes
        a peak's cell as (cycle - window start) mod 2**16."""
        cyc = self.peak_cycle().astype(np.uint16)
        return np.concatenate([cyc, np.zeros(bucket_count(len(self.peak_mz)) - len(cyc), np.uint16)])

    def peak_cycle(self) -> np.ndarray:
        """The cycle of every stored peak, i32[n_stored_peaks], read off the
        cell index (int32 or int64 offsets; the counts are int64)."""
        counts = np.diff(
            np.concatenate([self.cell_start[:, :, :-1].reshape(-1), [self.n_stored_peaks]])
        )
        n_rows = self.cell_start.shape[0] * self.cell_start.shape[1]
        return np.repeat(np.tile(np.arange(self.n_cycles, dtype=np.int32), n_rows), counts)

    def cell_index(self, stride: int = 1) -> tuple[np.ndarray, np.ndarray, int]:
        """``(cell_start, cycle_rt, n_cycles)`` of the device view.

        The cycle axis is padded to ``n_cycles_dev`` (empty cells, rising RT).
        ``stride > 1`` is a cycle-coarsened view of the same store: the peaks
        of ``stride`` adjacent cycles are contiguous per (slot, bin), so
        coarsening is only a strided ``cell_start``, over the same store.
        Both views keep the index's type (int32, or int64 past 2**31 stored
        entries).
        """
        Nc_p = self.n_cycles_dev
        crt = self._cycle_rt_padded()
        if stride > 1:
            n_k = -(-Nc_p // stride)
            # coarse boundary c' -> fine boundary min(stride * c', n_cycles)
            b_idx = np.minimum(np.arange(n_k + 1, dtype=np.int64) * stride, self.n_cycles)
            cs = self.cell_start[:, :, b_idx]
            return np.ascontiguousarray(cs), np.ascontiguousarray(crt[::stride][:n_k]), n_k
        cs = self.cell_start
        if Nc_p > self.n_cycles:
            cs = np.pad(cs, ((0, 0), (0, 0), (0, Nc_p - self.n_cycles)), mode="edge")
        return np.ascontiguousarray(cs), crt, Nc_p

    def device_arrays(self, stride: int = 1, device=None) -> dict:
        """Upload (once per device and stride) the arrays the kernels read.
        ``device=None`` is the CUDA card, as for every entry point of the
        port; without one it raises unless ``"cpu"`` is asked for.

        Returns ``peak_store`` (a :class:`PeakStore`), ``cell_start`` (i32,
        or i64 past 2**31 stored entries, never narrowed), ``cycle_rt`` f32
        and the static ``n_cycles``. The coarse view shares the fine view's
        peak store on the device.
        """
        device = resolve_device(device)
        key = (str(device), stride)
        if key not in self._device:
            if stride > 1:
                d = dict(self.device_arrays(1, device))
            else:
                store = PeakStore(*(
                    torch.from_numpy(a).to(device)
                    for a in (self.packed_store(), self.cycle_plane(), self.scanbin_plane())
                ))
                d = {"peak_store": store}
            cs, crt, n_cycles = self.cell_index(stride)
            d["cell_start"] = torch.from_numpy(cs).to(device)
            d["cycle_rt"] = torch.from_numpy(crt).to(device)
            d["n_cycles"] = n_cycles
            self._device[key] = d
        return self._device[key]

    def _cycle_rt_padded(self) -> np.ndarray:
        Nc_p = self.n_cycles_dev
        if Nc_p == self.n_cycles:
            return self.cycle_rt
        step = (
            float(self.cycle_time)
            if np.isfinite(self.cycle_time) and self.cycle_time > 0
            else 1.0
        )
        tail = self.cycle_rt[-1] + step * np.arange(
            1, Nc_p - self.n_cycles + 1, dtype=np.float32
        )
        return np.concatenate([self.cycle_rt, tail]).astype(np.float32)

    def free_device(self) -> None:
        self._device = {}
