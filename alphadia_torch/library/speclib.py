"""Spectral library containers.

- ``SpecLibBase``, the hierarchical library: a precursor column dict and
  fragment matrices, one row per cleavage site of each precursor
  (``frag_start_idx`` / ``frag_stop_idx`` delimit a precursor's rows) and
  one column per charged fragment type (``charged_frag_types``, e.g.
  ``b_z1`` / ``y_z2``). The matrices are 2-D float32 numpy arrays.
- ``SpecLibFlat``, the search's input: a precursor and a fragment column
  dict; ``flat_frag_start_idx`` / ``flat_frag_stop_idx`` of a precursor
  delimit its fragment rows (mz_library f32, intensity f32, cardinality u8,
  type u8 (ASCII of the series letter), loss_type u8, charge u8, number u8,
  position u8).

Both save to and load from HDF in the JAX package's layout (the root
attribute ``format``: ``BASE_FORMAT`` / ``FLAT_FORMAT``; a group per
frame with the attributes ``n_rows`` and ``columns`` and a dataset per
column, text columns as fixed-length strings; a fragment matrix as a frame
of one column per charged fragment type), through the port's HDF5 writer.

The JAX package's ``library/speclib.py`` with column dicts for its pandas
frames.
"""

from __future__ import annotations

import numpy as np

from alphadia_torch.library import chem
from alphadia_torch.utils import hdf5
from alphadia_torch.utils.frame import concat, copy_frame, n_rows
from alphadia_torch.utils.hashing import xxh64

_HASH_MASK = 0x7FFF_FFFF_FFFF_FFFF
BASE_FORMAT = "alphadia_tpu_speclib_base"
FLAT_FORMAT = "alphadia_tpu_speclib_flat"


def str_col(df: dict, name: str):
    """A column as an iterable of strings, or ``""`` a row where absent."""
    return df[name] if name in df else [""] * n_rows(df)


def mod_seq_hash(sequence, mods) -> np.ndarray:
    """63-bit xxHash64 of each modified sequence, ``"{seq}|{mods}"``."""
    return np.array([xxh64(f"{s}|{m or ''}".encode()) & _HASH_MASK for s, m in zip(sequence, mods)], dtype=np.int64)


def mod_seq_charge_hash(sequence, mods, charge) -> np.ndarray:
    """63-bit xxHash64 of each ``"{seq}|{mods}|{charge}"``."""
    return np.array(
        [xxh64(f"{s}|{m or ''}|{int(c)}".encode()) & _HASH_MASK for s, m, c in zip(sequence, mods, charge)],
        dtype=np.int64,
    )


def _seq_len(sequences) -> np.ndarray:
    return np.array([len(s) for s in sequences], dtype=np.int64)


class SpecLibBase:
    """Hierarchical spectral library: precursor columns + fragment matrices."""

    def __init__(
        self,
        precursor_df: dict,
        fragment_mz: np.ndarray | None = None,
        fragment_intensity: np.ndarray | None = None,
        charged_frag_types: list[str] | None = None,
    ):
        self.precursor_df = precursor_df
        self.fragment_mz = fragment_mz
        self.fragment_intensity = fragment_intensity
        self.charged_frag_types = list(charged_frag_types or [])

    def calc_precursor_mz(self) -> None:
        df = self.precursor_df
        df["precursor_mz"] = np.array(
            [
                chem.precursor_mz(s, int(z), m, ms)
                for s, z, m, ms in zip(df["sequence"], df["charge"], str_col(df, "mods"), str_col(df, "mod_sites"))
            ],
            dtype=np.float32,
        )

    def calc_fragment_mz(self, max_charge: int = 2, types: tuple = ("b", "y")) -> None:
        """(Re)compute the fragment m/z matrix from the sequences.

        An existing intensity matrix is first laid out anew in the same way:
        precursor rows may have been reordered or subset since it was
        written, and the old layout would pair a precursor with another
        one's intensities.
        """
        df = self.precursor_df
        naa = _seq_len(df["sequence"])
        rows = int((naa - 1).sum())
        cols = [f"{t}_z{z}" for t in types for z in range(1, max_charge + 1)]
        mz = np.zeros((rows, len(cols)), dtype=np.float32)
        start = np.zeros(len(naa), dtype=np.int64)
        np.cumsum(naa[:-1] - 1, out=start[1:])

        if self.fragment_intensity is not None and "frag_start_idx" in df:
            old_start = df["frag_start_idx"].astype(np.int64)
            if not np.array_equal(old_start, start):
                counts = naa - 1
                src = np.repeat(old_start, counts) + np.arange(rows, dtype=np.int64) - np.repeat(start, counts)
                self.fragment_intensity = self.fragment_intensity[src]

        for i, (s, m, ms) in enumerate(zip(df["sequence"], str_col(df, "mods"), str_col(df, "mod_sites"))):
            ladders = chem.fragment_mz_arrays(s, m, ms, max_charge=max_charge, types=types)
            a = start[i]
            for j, c in enumerate(cols):
                mz[a : a + len(s) - 1, j] = ladders[c]
        self.fragment_mz = mz
        self.charged_frag_types = cols
        df["frag_start_idx"] = start.astype(np.uint32)
        df["frag_stop_idx"] = (start + naa - 1).astype(np.uint32)
        df["nAA"] = naa.astype(np.uint8)

    def hash_precursors(self) -> None:
        df = self.precursor_df
        mods = str_col(df, "mods")
        df["mod_seq_hash"] = mod_seq_hash(df["sequence"], mods)
        df["mod_seq_charge_hash"] = mod_seq_charge_hash(df["sequence"], mods, df["charge"])

    def calc_isotopes(self, n_isotopes: int = 4) -> None:
        df = self.precursor_df
        comp = chem.peptide_compositions(list(df["sequence"]), list(df["mods"]) if "mods" in df else None)
        env = chem.isotope_envelopes(comp, k_max=n_isotopes)
        for k in range(n_isotopes):
            df[f"i_{k}"] = env[:, k]

    def append(self, other: "SpecLibBase") -> None:
        """Rows of ``other`` after this library's (fragment rows offset)."""
        offset = len(self.fragment_mz) if self.fragment_mz is not None else 0
        other_prec = copy_frame(other.precursor_df)
        other_prec["frag_start_idx"] = other_prec["frag_start_idx"] + offset
        other_prec["frag_stop_idx"] = other_prec["frag_stop_idx"] + offset
        self.precursor_df = concat([self.precursor_df, other_prec])
        self.fragment_mz = np.concatenate([self.fragment_mz, other.fragment_mz])
        if self.fragment_intensity is not None and other.fragment_intensity is not None:
            self.fragment_intensity = np.concatenate([self.fragment_intensity, other.fragment_intensity])

    def copy(self) -> "SpecLibBase":
        return SpecLibBase(
            copy_frame(self.precursor_df),
            None if self.fragment_mz is None else self.fragment_mz.copy(),
            None if self.fragment_intensity is None else self.fragment_intensity.copy(),
            self.charged_frag_types,
        )

    def save_hdf(self, path, thread_count: int = 1) -> None:
        root = hdf5.Group({"format": BASE_FORMAT})
        _df_to_hdf(root.create_group("precursor_df"), self.precursor_df)
        for name, matrix in (("fragment_mz_df", self.fragment_mz), ("fragment_intensity_df", self.fragment_intensity)):
            if matrix is not None:
                _df_to_hdf(root.create_group(name), _matrix_frame(matrix, self.charged_frag_types))
        hdf5.write(path, root, threads=thread_count)

    @classmethod
    def load_hdf(cls, path, thread_count: int = 1) -> "SpecLibBase":
        with hdf5.File(path, threads=thread_count) as f:
            prec = _df_from_hdf(f["precursor_df"])
            frames = [_df_from_hdf(f[k]) if k in f else None for k in ("fragment_mz_df", "fragment_intensity_df")]
        return cls.from_frames(prec, *frames)

    @classmethod
    def from_frames(cls, precursor_df: dict, mz_df: dict | None, intensity_df: dict | None) -> "SpecLibBase":
        """A library of fragment frames (a column per charged fragment type),
        the intensity frame's columns taken in the m/z frame's order."""
        types = list(mz_df if mz_df is not None else intensity_df or [])
        matrices = []
        for frame in (mz_df, intensity_df):
            if frame is not None and sorted(frame) != sorted(types):
                raise ValueError(f"fragment frames with different columns: {sorted(types)} and {sorted(frame)}")
            matrices.append(None if frame is None else _frame_matrix(frame, types))
        return cls(precursor_df, *matrices, types)


def _matrix_frame(matrix: np.ndarray, columns: list[str]) -> dict:
    """A fragment matrix as a frame of one column per fragment type."""
    return {c: np.ascontiguousarray(matrix[:, j]) for j, c in enumerate(columns)}


def _frame_matrix(frame: dict, columns: list[str]) -> np.ndarray:
    """A fragment frame's ``columns`` as a 2-D matrix (rows x columns)."""
    if not columns:
        return np.zeros((n_rows(frame), 0), dtype=np.float32)
    return np.stack([np.asarray(frame[c]) for c in columns], axis=1)


def _df_to_hdf(group: hdf5.Group, df: dict) -> None:
    group.attrs["n_rows"] = n_rows(df)
    group.attrs["columns"] = list(df)
    for col, vals in df.items():
        vals = np.asarray(vals)
        if vals.dtype.kind in "OU":
            vals = vals.astype("S")
        group.create_dataset(str(col), vals)


def _df_from_hdf(group) -> dict:
    """A frame of ``_df_to_hdf``: the ``columns`` attribute's order,
    fixed-length strings back as ``str``."""
    data = {}
    for col in list(group.attrs["columns"]):
        vals = group[str(col)][:]
        if vals.dtype.kind == "S":
            vals = vals.astype(str).astype(object)
        data[col] = vals
    return data


class SpecLibFlat:
    """Flat spectral library, the search's input."""

    def __init__(self, precursor_df: dict, fragment_df: dict):
        self.precursor_df = precursor_df
        self.fragment_df = fragment_df
        # set by the per-run library init: the frames before the run's
        # filter, which the multiplexing requant subsets again
        self.precursor_df_unfiltered: dict | None = None
        self.fragment_df_unfiltered: dict | None = None

    @property
    def n_precursors(self) -> int:
        return n_rows(self.precursor_df)

    def copy(self) -> "SpecLibFlat":
        return SpecLibFlat(copy_frame(self.precursor_df), copy_frame(self.fragment_df))

    def save_hdf(self, path, thread_count: int = 1) -> None:
        root = hdf5.Group({"format": FLAT_FORMAT})
        _df_to_hdf(root.create_group("precursor_df"), self.precursor_df)
        _df_to_hdf(root.create_group("fragment_df"), self.fragment_df)
        hdf5.write(path, root, threads=thread_count)

    @classmethod
    def load_hdf(cls, path, thread_count: int = 1) -> "SpecLibFlat":
        with hdf5.File(path, threads=thread_count) as f:
            return cls(_df_from_hdf(f["precursor_df"]), _df_from_hdf(f["fragment_df"]))
