"""XIC queries at the edges that the CUDA kernel's design depends on, built
with numpy on a port ``DiaData`` (no JAX, so the card's tests can use it
too). The CPU tests hold the plain version against JAX on them; the card's
tests hold the kernel against the plain version.

``edge_inputs(dia, dev, case)`` returns ``(slot, qmz, c0, kw, check)``:
B x Q queries whose row 0, query 0 sits on the edge (the other queries sit
on random stored peaks), extra keyword arguments, and ``check(run)``, which
asserts that the edge shows in the intensity plane ``run(**overrides)``.
"""

from __future__ import annotations

import numpy as np

EDGE_CASES = (
    "slab_clipped_mid_cell",
    "window_past_store_end",
    "empty_cells_in_window",
    "stride2_view",
    "exclusive_scan_edge",
)
B, Q, W, SLAB = 4, 5, 32, 16


def edge_world_config():
    """Keyword arguments of ``SyntheticConfig`` and ``from_spectra``: 10-Th
    coarse bins, so rows hold several peaks per cycle and slabs of ``SLAB``
    peaks end inside cells; with ion mobility for the scan window."""
    return (
        dict(n_peptides=60, n_windows=4, n_cycles=60, noise_peaks_per_spectrum=100, with_mobility=True, seed=8),
        dict(coarse_bin_width=10.0, n_scan_bins=8),
    )


def _random_queries(dia, cyc, rng, stride):
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    qmz = dia.peak_mz[pick].astype(np.float32)
    c0 = (cyc[pick[:, 0]] // stride - rng.integers(0, W, B)).astype(np.int32)
    return slot, qmz, c0


def _rows(dia, cs):
    return cs.reshape(dia.n_slots * dia.n_bins, cs.shape[2])


def _own_bin(dia, k):
    """Whether stored peak k lies in the bin of its own m/z (not a ghost)."""
    return not dia.peak_is_ghost[k]


def edge_inputs(dia, dev, case, seed=0):
    cs = dev["cell_start"].cpu().numpy()
    n_cyc = int(dev["n_cycles"])
    stride = 2 if case == "stride2_view" else 1
    cyc = dia.peak_cycle()
    rng = np.random.default_rng(seed)
    slot, qmz, c0 = _random_queries(dia, cyc, rng, stride)
    rows = _rows(dia, cs)
    kw = {"slab": 256}

    def put(row, k, start):
        slot[0, 0] = row // dia.n_bins
        qmz[0, 0] = dia.peak_mz[k]
        c0[0] = start

    if case == "slab_clipped_mid_cell":
        kw["slab"] = SLAB
        found = None
        for row in range(len(rows)):
            r = rows[row]
            for start in range(n_cyc - W):
                cut = int(r[start]) + SLAB
                cell = int(np.searchsorted(r, cut, side="right")) - 1
                if start <= cell < start + W - 1 and r[cell] < cut < r[cell + 1] and _own_bin(dia, cut):
                    found = row, cut, start, cell - start
                    break
            if found:
                break
        assert found, "no slab of this world ends inside a cell"
        row, cut, start, w = found
        put(row, cut, start)

        def check(run):
            cut_off, full = run()[0, 0], run(slab=4096)[0, 0]
            assert full[w] > cut_off[w]  # the first dropped peak sits in cell w
            assert (cut_off[w + 1 :] == 0).all()

    elif case == "window_past_store_end":
        last = dia.n_stored_peaks - 1
        while not _own_bin(dia, last):
            last -= 1
        row = int(np.searchsorted(rows[:, 0], last, side="right")) - 1
        start = int(cyc[last]) - W // 2
        assert rows[row, min(start + W, n_cyc)] == dia.n_stored_peaks  # the slab runs to the store's end
        put(row, last, start)
        w = int(cyc[last]) - start

        def check(run):
            out = run()[0, 0]
            assert out[w] > 0
            assert (out[dia.n_cycles - start :] == 0).all()

    elif case == "empty_cells_in_window":
        found = None
        for k in rng.permutation(dia.n_stored_peaks):
            row = int(np.searchsorted(rows[:, 0], k, side="right")) - 1
            start = int(cyc[k]) - W // 2
            if not _own_bin(dia, k) or start < 0 or start + W > dia.n_cycles:
                continue
            counts = np.diff(rows[row, start : start + W + 1])
            empty = np.nonzero(counts[: W // 2] == 0)[0]
            if len(empty) and counts[: empty[0]].any():
                found = row, int(k), start, int(empty[0])
                break
        assert found, "no window of this world has an empty cell between two full ones"
        row, k, start, w_empty = found
        put(row, k, start)

        def check(run):
            out = run()[0, 0]
            assert out[W // 2] > 0 and out[w_empty] == 0

    elif case == "stride2_view":

        def check(run):
            assert run().sum() > 0

    elif case == "exclusive_scan_edge":
        scanbin = dia.peak_scanbin
        k = next(int(k) for k in rng.permutation(dia.n_stored_peaks) if _own_bin(dia, k) and scanbin[k] > 0)
        row = int(np.searchsorted(rows[:, 0], k, side="right")) - 1
        put(row, k, int(cyc[k]) - W // 2)
        s, w = int(scanbin[k]), W // 2
        S = dia.n_scan_bins
        kw.update(scan_lo=np.full(B, s, np.int32), scan_hi=np.full(B, S, np.int32))

        def check(run):
            upper = run()[0, 0]  # [s, S): holds peak k
            lower = run(scan_lo=np.zeros(B, np.int32), scan_hi=np.full(B, s, np.int32))[0, 0]  # [0, s)
            both = run(scan_lo=np.zeros(B, np.int32), scan_hi=np.full(B, S, np.int32))[0, 0]
            assert upper[w] > 0
            # the exclusive edge neither drops nor doubles the bin-s peaks
            np.testing.assert_allclose(upper + lower, both, rtol=1e-6, atol=1e-3)

    else:
        raise ValueError(case)
    return slot, qmz, c0, kw, check
