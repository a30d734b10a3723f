# The byte and operation count of chip_smoke.py's ``work`` (lines 708-739 at
# commit b5dd55e), reworked to count the work of the XIC function from the
# traffic instead of a launch's arguments: the queries of each precursor or
# candidate, the cycles its RT tolerance or its candidate spans, and the peaks
# of the benchmark's own run that fall in each query's m/z tolerance there.
"""The least time of the XIC function on a stretch of traffic.

Bytes: each peak that some query's m/z tolerance takes in over its cycles,
read once (m/z and intensity, 8 B; 2 B more for the scan bin under a scan
window), each query's slot and m/z (8 B) and each row's window start (4 B,
and 8 B of scan window) read once, and each output value written once (4 B a
cell and plane). Operations: eight a (query, matched peak) pair. The least
time is the larger of bytes at the card's memory bandwidth and operations at
its float32 rate; the peaks are NVIDIA's published H100 SXM figures.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS_F32 = 67e12  # H100 SXM, float32 outside the tensor cores
OPS_PER_MATCH = 8
MAX_COARSE_CELLS = 512  # the drivers merge cycles while a window is longer (search/selection)
_KEY_SCALE = 4096.0  # m/z below this; key = spectrum * scale + m/z orders the store


@dataclass
class Queries:
    """XIC queries: one row per query."""

    slot: np.ndarray  # i64 cycle slot (0 = MS1)
    mz: np.ndarray  # f64 query centre
    tol_ppm: np.ndarray  # f64
    c0: np.ndarray  # i64 first cycle
    c1: np.ndarray  # i64 end cycle (exclusive)
    cells: np.ndarray  # i64 output cells a plane
    planes: int  # output planes (1: intensity, 2: intensity and m/z)
    rows: int  # launch rows (precursors or candidates)
    scan: bool  # a scan window is read


@dataclass
class Work:
    bytes: int = 0
    ops: int = 0

    def add(self, other: "Work"):
        self.bytes += other.bytes
        self.ops += other.ops

    def least_s(self) -> float:
        return max(self.bytes / PEAK_BYTES_PER_S, self.ops / PEAK_FLOPS_F32)


def coarse_stride(n_cycles: int) -> int:
    stride = 1
    while n_cycles / stride > MAX_COARSE_CELLS:
        stride *= 2
    return stride


def rt_cycles(rt: np.ndarray, tol: float, cycle_time: float, n_cycles: int):
    """[c0, c1) of the cycles whose RT lies within ``tol`` of ``rt``."""
    c0 = np.clip(np.ceil((rt - tol) / cycle_time), 0, n_cycles).astype(np.int64)
    c1 = np.clip(np.floor((rt + tol) / cycle_time) + 1, 0, n_cycles).astype(np.int64)
    return c0, np.maximum(c1, c0)


class PeakIndex:
    """The run's peaks on the card, ordered by (spectrum, m/z), for range
    counts of (spectrum, m/z window) cells."""

    def __init__(self, world, device):
        self.device = torch.device(device)
        self.n_slots = world.n_slots
        spec = np.repeat(np.arange(world.n_spectra, dtype=np.int64), np.diff(world.spec_start))
        self.key = torch.from_numpy(spec).to(self.device).double() * _KEY_SCALE + torch.from_numpy(world.mz).to(
            self.device
        ).double()
        self.n = len(world.mz)

    def count(self, q: Queries, chunk: int = 1 << 25) -> Work:
        """The work of the queries ``q`` on this run."""
        dev = self.device
        n_pairs = q.c1 - q.c0
        cover = torch.zeros(self.n + 1, dtype=torch.int32, device=dev)
        matches = 0
        # expand (query, cycle) pairs chunk by chunk
        ends = np.cumsum(n_pairs)
        starts = ends - n_pairs
        a = 0
        while a < len(n_pairs):
            b = int(np.searchsorted(ends, ends[a] - n_pairs[a] + chunk, side="right"))
            b = max(b, a + 1)
            sl = slice(a, b)
            reps = torch.from_numpy(n_pairs[sl]).to(dev)
            qi = torch.repeat_interleave(torch.arange(b - a, device=dev), reps)
            first = torch.from_numpy(starts[sl] - starts[a]).to(dev)
            cyc = torch.from_numpy(q.c0[sl]).to(dev)[qi] + (torch.arange(len(qi), device=dev) - first[qi])
            spec = cyc * self.n_slots + torch.from_numpy(q.slot[sl]).to(dev)[qi]
            mz = torch.from_numpy(q.mz[sl]).to(dev)
            tol = torch.from_numpy(q.tol_ppm[sl]).to(dev) * 1e-6
            base = spec.double() * _KEY_SCALE
            lo = torch.searchsorted(self.key, base + (mz * (1 - tol))[qi], side="left")
            hi = torch.searchsorted(self.key, base + (mz * (1 + tol))[qi], side="right")
            live = hi > lo
            matches += int((hi - lo).sum())
            cover.index_add_(0, lo[live], torch.ones(int(live.sum()), dtype=torch.int32, device=dev))
            cover.index_add_(0, hi[live], -torch.ones(int(live.sum()), dtype=torch.int32, device=dev))
            a = b
        unique = int((torch.cumsum(cover, 0)[:-1] > 0).sum())
        peak_bytes = 8 + (2 if q.scan else 0)
        row_bytes = 4 + (8 if q.scan else 0)
        nbytes = unique * peak_bytes + len(q.slot) * 8 + q.rows * row_bytes + q.planes * 4 * int(q.cells.sum())
        return Work(bytes=nbytes, ops=OPS_PER_MATCH * matches)


def _query_rows(world, rows: np.ndarray, top_k: int):
    """Each precursor's queries: its top fragments by library intensity in
    its window's slot, then its isotopes in the MS1 slot. Returns (owner
    row index, slot, m/z) a query; precursors outside every window have no
    fragment queries."""
    prec, frag = world.precursor, world.fragment
    mz = prec["mz_library"][rows].astype(np.float64)
    charge = prec["charge"][rows].astype(np.float64)
    n_iso = sum(1 for k in prec if k.startswith("i_"))
    win = np.searchsorted(world.window_edges, mz, side="right") - 1
    inside = (win >= 0) & (win < len(world.window_edges) - 1)
    fs = prec["flat_frag_start_idx"][rows].astype(np.int64)
    fe = prec["flat_frag_stop_idx"][rows].astype(np.int64)
    idx = fs[:, None] + np.arange(max(int((fe - fs).max()) if len(fs) else 0, 1))[None, :]
    valid = idx < fe[:, None]
    idx = np.minimum(idx, len(frag["intensity"]) - 1)
    order = np.argsort(np.where(valid, -frag["intensity"][idx], np.inf), axis=1, kind="stable")[:, :top_k]
    fmz = np.take_along_axis(frag["mz_library"][idx].astype(np.float64), order, axis=1)
    r, k = np.nonzero(np.take_along_axis(valid, order, axis=1) & inside[:, None])
    iso = mz[:, None] + 1.0033548378 * np.arange(n_iso)[None, :] / charge[:, None]
    ri = np.repeat(np.arange(len(rows)), n_iso)
    owner = np.concatenate([r, ri])
    slot = np.concatenate([1 + win[r], np.zeros(len(ri), np.int64)]).astype(np.int64)
    return owner, slot, np.concatenate([fmz[r, k], iso.ravel()]), len(r)


def precursor_queries(world, rows: np.ndarray, rt: np.ndarray, ms1_ppm: float, ms2_ppm: float, rt_tol: float,
                      top_k: int = 12) -> Queries:
    """Selection's queries over the cycles within ``rt_tol`` of each
    precursor's RT, in coarse cells where the window is long."""
    owner, slot, mz, n_frag = _query_rows(world, rows, top_k)
    c0, c1 = rt_cycles(rt, rt_tol, world.cycle_time, world.n_cycles)
    stride = coarse_stride(int(np.ceil(2 * rt_tol / world.cycle_time)))
    tol = np.where(np.arange(len(owner)) < n_frag, ms2_ppm, ms1_ppm).astype(np.float64)
    c0q, c1q = c0[owner], c1[owner]
    return Queries(slot=slot, mz=mz, tol_ppm=tol, c0=c0q, c1=c1q, cells=-(-(c1q - c0q) // stride), planes=1,
                   rows=len(rows), scan=False)


def candidate_queries(world, cand: dict, ms1_ppm: float, ms2_ppm: float, top_k: int = 12) -> Queries:
    """Scoring's queries: each candidate's precursor's top fragments and
    isotopes over the candidate's cycles, intensity and m/z planes."""
    rows = cand["precursor_idx"].astype(np.int64)  # precursor_idx is the library row
    owner, slot, mz, n_frag = _query_rows(world, rows, top_k)
    tol = np.where(np.arange(len(owner)) < n_frag, ms2_ppm, ms1_ppm).astype(np.float64)
    c0 = cand["frame_start"].astype(np.int64)[owner]
    c1 = np.maximum(cand["frame_stop"].astype(np.int64)[owner], c0)
    return Queries(slot=slot, mz=mz, tol_ppm=tol, c0=c0, c1=c1, cells=c1 - c0, planes=2, rows=len(rows),
                   scan=world.mobility is not None)
