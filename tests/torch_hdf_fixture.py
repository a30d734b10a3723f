"""Makes the committed HDF fixture of the port's HDF5 reader,
``alphadia_torch/testing/data/``: files that h5py wrote (which a machine
without h5py, the card's, cannot make itself), through the JAX package's
writers where it has them.

- ``hdf_spectra_3d.hdf`` / ``hdf_spectra_4d.hdf``: ``save_spectra_hdf`` of a
  small 3D world made from sequences (so that a TSV library of its targets
  builds) and of a small 4D world (per-peak mobility);
- ``hdf_speclib_base.hdf`` / ``hdf_speclib_flat.hdf``: ``SpecLibBase.save_hdf``
  of the 3D world's TSV library (with a ``bool`` column) and
  ``SpecLibFlat.save_hdf`` of it harmonized, with decoys, flattened (text
  columns, a ``bool`` column);
- ``hdf_alpharaw.hdf``: the 3D world in alphaRaw's layout,
  ``ms_data/{spectrum_df,peak_df}``, RT in minutes with the vlen attribute
  ``rt_unit``, a vlen-string column, ``mz`` under shuffle+deflate and
  ``intensity`` under LZF;
- ``hdf_alpharaw_latest.hdf``: a smaller 3D world in alphaRaw's layout with
  ``libver="latest"`` (version-3 superblock, version-2 object headers,
  dense attributes, the fixed-array chunk index with data-block pages
  (``mz`` in chunks of two peaks), the extensible-array one with secondary
  blocks for ``maxshape=(None,)`` columns);
- ``hdf_speclib_track_order.hdf``: ``SpecLibBase.save_hdf`` of the 3D
  world's TSV library with h5py's ``track_order`` on (groups with link
  creation order: dense links in a fractal heap, version-2 B-trees);
- ``hdf_fixture.json``: the worlds, and per file the sha256 of every
  dataset (``array_sha256`` of h5py's reading, variable-length strings as
  ``str``) and every attribute's value.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_hdf_fixture.py

``array_sha256``, ``file_record`` and ``rewritten`` need neither h5py nor
JAX: ``chip_smoke.py`` phase [12a] and the card tests use them.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parents[1] / "alphadia_torch" / "testing" / "data"
WORLD_3D = dict(n_peptides=120, n_windows=3, n_cycles=60, noise_peaks_per_spectrum=20, seed=5, from_sequence=True)
WORLD_4D = dict(n_peptides=40, n_windows=2, n_cycles=30, noise_peaks_per_spectrum=10, seed=6, with_mobility=True)
WORLD_LATEST = dict(n_peptides=20, n_windows=3, n_cycles=12, noise_peaks_per_spectrum=5, seed=7)
FILES = ("hdf_spectra_3d.hdf", "hdf_spectra_4d.hdf", "hdf_speclib_base.hdf", "hdf_speclib_flat.hdf", "hdf_alpharaw.hdf",
         "hdf_alpharaw_latest.hdf", "hdf_speclib_track_order.hdf")


def array_sha256(a) -> str:
    """sha256 of an array's dtype and bytes; an object (text) array as its
    values in UTF-8, each ended by a NUL."""
    a = np.asarray(a)
    if a.dtype == object:
        text = [x.decode() if isinstance(x, bytes) else str(x) for x in a.reshape(-1)]
        return hashlib.sha256(b"O" + "".join(t + "\0" for t in text).encode()).hexdigest()
    return hashlib.sha256(a.dtype.str.encode() + np.ascontiguousarray(a).tobytes()).hexdigest()


def _jsonable(v):
    v = np.asarray(v) if not isinstance(v, str) else v
    if isinstance(v, str):
        return v
    if v.dtype == object:
        return [x.decode() if isinstance(x, bytes) else str(x) for x in v.reshape(-1)]
    return v.tolist()


def file_record(path, reader: str = "port") -> dict:
    """{"datasets": {path: sha256}, "attrs": {path: {name: value}}} of a
    file, read by the port's reader (or by h5py: ``reader="h5py"``)."""
    datasets, attrs = {}, {}
    if reader == "h5py":
        import h5py

        with h5py.File(path, "r") as f:
            attrs[""] = {k: _jsonable(v) for k, v in f.attrs.items()}

            def visit(name, node):
                attrs[name] = {k: _jsonable(v) for k, v in node.attrs.items()}
                if isinstance(node, h5py.Dataset):
                    datasets[name] = array_sha256(node[()])

            f.visititems(visit)
    else:
        from alphadia_torch.utils import hdf5

        with hdf5.File(path) as f:
            def walk(g, prefix):
                attrs[prefix.rstrip("/")] = {k: _jsonable(v) for k, v in g.attrs.items()}
                for k in g:
                    node = g[k]
                    if isinstance(node, hdf5.Group):
                        walk(node, f"{prefix}{k}/")
                    else:
                        attrs[f"{prefix}{k}"] = {a: _jsonable(v) for a, v in node.attrs.items()}
                        datasets[f"{prefix}{k}"] = array_sha256(node[()])

            walk(f, "")
    return {"datasets": dict(sorted(datasets.items())), "attrs": dict(sorted(attrs.items()))}


def rewritten(src, dst, threads: int = 1) -> None:
    """``src`` written again by the port's writer: every group, dataset and
    attribute as the port's reader gives them."""
    from alphadia_torch.utils import hdf5

    def copy(g, out):
        out.attrs.update(g.attrs)
        for k in g:
            node = g[k]
            if isinstance(node, hdf5.Group):
                copy(node, out.create_group(k))
            else:
                out.create_dataset(k, node[()], attrs=dict(node.attrs))

    root = hdf5.Group()
    with hdf5.File(src) as f:
        copy(f, root)
    hdf5.write(dst, root, threads=threads)


def main():
    import h5py
    import pandas as pd

    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
    from alphadia_torch.testing.tsv_library import write_transition_list
    from alphadia_tpu.library import decoy, flatten, harmonize
    from alphadia_tpu.library.loader import load_speclib_tsv
    from alphadia_tpu.rawdata.hdf import save_spectra_hdf

    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**WORLD_3D))
    spectra_4d, _, _ = make_synthetic_dia(SyntheticConfig(**WORLD_4D))
    save_spectra_hdf(DATA / "hdf_spectra_3d.hdf", spectra)
    save_spectra_hdf(DATA / "hdf_spectra_4d.hdf", spectra_4d)

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tsv = Path(tmp) / "lib.tsv"
        write_transition_list(tsv, prec, frag)
        base = load_speclib_tsv(tsv)
    base.precursor_df["is_shared"] = (np.arange(len(base.precursor_df)) % 3 == 0)
    base.save_hdf(DATA / "hdf_speclib_base.hdf")
    lib = harmonize.PrecursorInitializer()(base.copy())
    lib = harmonize.RTNormalization()(harmonize.IsotopeGenerator()(lib))
    flat = flatten.InitFlatColumns()(flatten.FlattenLibrary(12, 0.01)(decoy.DecoyGenerator("diann")(lib)))
    flat.fragment_df["is_top"] = pd.Series(flat.fragment_df["intensity"].to_numpy() >= 0.5)
    flat.save_hdf(DATA / "hdf_speclib_flat.hdf")

    write_alpharaw(DATA / "hdf_alpharaw.hdf", spectra)
    spectra_latest, _, _ = make_synthetic_dia(SyntheticConfig(**WORLD_LATEST))
    write_alpharaw(DATA / "hdf_alpharaw_latest.hdf", spectra_latest, libver="latest", chunks={"mz": 2, "intensity": 4},
                   unlimited=("peak_start_idx", "peak_stop_idx", "intensity"),
                   attrs={f"creation_info_{i}": i for i in range(10)})
    h5py.get_config().track_order = True
    try:
        base.save_hdf(DATA / "hdf_speclib_track_order.hdf")
    finally:
        h5py.get_config().track_order = False

    record = {
        "world_3d": WORLD_3D, "world_4d": WORLD_4D, "world_latest": WORLD_LATEST, "h5py": h5py.__version__,
        "hdf5": h5py.version.hdf5_version, "files": {name: file_record(DATA / name, reader="h5py") for name in FILES},
    }
    (DATA / "hdf_fixture.json").write_text(json.dumps(record, indent=1) + "\n")
    sizes = {name: (DATA / name).stat().st_size for name in FILES}
    print(f"{len(spectra.mz)} / {len(spectra_4d.mz)} peaks, {len(flat.precursor_df)} flat precursors; bytes {sizes}, "
          f"{sum(sizes.values())} in all")


def write_alpharaw(path, spectra, libver=None, chunks=None, unlimited=(), attrs=None) -> None:
    """``spectra`` in alphaRaw's layout through h5py; ``chunks`` the chunk
    length of some columns (more than 1,024 chunks: a paged fixed array),
    ``unlimited`` the columns of ``maxshape=(None,)``."""
    import h5py

    def column(g, name, data, **kw):
        opts = dict(kw)
        if name in (chunks or {}):
            opts["chunks"] = (chunks[name],)
        if name in unlimited:
            opts["maxshape"] = (None,)
        g.create_dataset(name, data=data, **opts)

    with h5py.File(path, "w", **({"libver": libver} if libver else {})) as f:
        f.attrs.update(attrs or {})
        g = f.create_group("ms_data")
        spec, peak = g.create_group("spectrum_df"), g.create_group("peak_df")
        spec.attrs["rt_unit"] = "minute"
        column(spec, "rt", spectra.rt.astype(np.float64) / 60.0, compression="gzip")
        column(spec, "ms_level", spectra.ms_level.astype(np.int8), compression="gzip")
        column(spec, "isolation_lower_mz", spectra.isolation_lower_mz.astype(np.float64), compression="gzip")
        column(spec, "isolation_upper_mz", spectra.isolation_upper_mz.astype(np.float64), compression="gzip")
        column(spec, "peak_start_idx", spectra.peak_start_idx, compression="gzip")
        column(spec, "peak_stop_idx", spectra.peak_stop_idx, compression="gzip")
        column(spec, "scan_id", np.array([f"controllerType=0 scan={i + 1}" for i in range(spectra.n_spectra)],
                                         dtype=object), dtype=h5py.string_dtype(), compression="gzip")
        column(peak, "mz", spectra.mz.astype(np.float64), compression="gzip", shuffle=True)
        column(peak, "intensity", spectra.intensity, compression="lzf")


if __name__ == "__main__":
    main()
