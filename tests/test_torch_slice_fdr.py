"""The slice end to end on the CPU: library + peak store ->
``PipelinedExtraction`` -> ``FDRManager.fit_predict`` (the packaged
classifier warm-started, ``precursor`` strategy, competitive, fragment
competition) in the port and in the JAX package, on the same synthetic
world with decoys.

Both fits start from the same packaged weights and draw the same batches;
they differ by dropout masks and by the features' float32 tolerance
(``test_torch_slice.py``). Held: the same estimator (``nn``), target IDs
at 1% FDR within 3% of JAX's count with a Jaccard overlap >= 0.9, and the
share of detectable targets identified at 1% FDR within 0.02 of JAX's.

Run as a script it prints, for the JAX drivers and the port on a larger
world, the identified share and the realised false share (accepted
targets whose best candidate lies more than 3 cycles from the true apex)
that ``chip_smoke.py`` phase [6] gates against:

    PYTHONPATH=. python tests/test_torch_slice_fdr.py --peptides 1500 --windows 3
    PYTHONPATH=. python tests/test_torch_slice_fdr.py --peptides 6250 --windows 3 --mobility
"""

import argparse
import time

import numpy as np

from alphadia_torch.convert import diadata_from_jax, frame_from_pandas
from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_torch.search.pipelined import PipelinedExtraction
from alphadia_torch.search.scoring import ScoringConfig
from alphadia_torch.search.selection import SelectionConfig
from alphadia_torch.workflow.managers.fdr_manager import FDRManager
from alphadia_torch.workflow.peptidecentric.peptidecentric import FDR_FEATURE_COLUMNS
from alphadia_tpu.models.classifier import BinaryClassifier as JaxBinaryClassifier
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.search.pipelined import PipelinedExtraction as JaxPipelined
from alphadia_tpu.search.scoring import ScoringConfig as JaxScoringConfig
from alphadia_tpu.search.selection import SelectionConfig as JaxSelectionConfig
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_tpu.workflow.managers.fdr_manager import FDRManager as JaxFDRManager

pytest_plugins = ("torch_port_plugin",)

SEL = dict(rt_tolerance=60.0, candidate_count=3)
SCORE = dict(batch_size=8192, collect_fragments=True)


def id_shares(cycle_rt, prec: dict, out: dict) -> tuple[float, float, int, int]:
    """(identified share, realised false share, targets, decoys at 1% FDR):
    the share of detectable targets with a target PSM at q <= 0.01, and the
    share of those accepted targets whose PSM lies more than 3 cycles from
    the generator's true apex."""
    accepted = out["qval"] <= 0.01
    target = out["_decoy"] == 0
    pidx = out["precursor_idx"][accepted & target]
    det = prec["_truth_detectable"] & (prec["decoy"] == 0)
    identified = np.isin(prec["precursor_idx"][det], pidx).mean() if det.any() else 0.0
    truth_cycle = np.abs(cycle_rt[None, :] - prec["_truth_rt"][:, None]).argmin(1)
    row = {int(p): i for i, p in enumerate(prec["precursor_idx"])}
    rows = np.array([row[int(p)] for p in pidx], np.int64)
    off = np.abs(out["frame_center"][accepted & target] - truth_cycle[rows]) > 3
    return float(identified), float(off.mean()) if len(off) else 0.0, int(len(pidx)), int((accepted & ~target).sum())


def run_jax(spectra, prec, frag, n_scan_bins=8):
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=n_scan_bins, use_native=False)
    _, psm, frags = JaxPipelined(jd, prec, frag, JaxSelectionConfig(**SEL), JaxScoringConfig(**SCORE))()
    mgr = JaxFDRManager(FDR_FEATURE_COLUMNS, JaxBinaryClassifier(random_state=0), dia_cycle=jd.cycle, random_state=0)
    out = mgr.fit_predict(psm, decoy_strategy="precursor", competitive=True, df_fragments=frags)
    return jd, {c: out[c].to_numpy() for c in out.columns}, out.attrs["fdr_estimator"]


def run_port(jd, prec, frag):
    dia = diadata_from_jax(jd)
    prec, frag = frame_from_pandas(prec), frame_from_pandas(frag)
    _, psm, frags = PipelinedExtraction(dia, prec, frag, SelectionConfig(**SEL), ScoringConfig(**SCORE), device="cpu")()
    mgr = FDRManager(
        FDR_FEATURE_COLUMNS, BinaryClassifier(random_state=0, device="cpu"), dia_cycle=dia.cycle, random_state=0
    )
    out = mgr.fit_predict(psm, decoy_strategy="precursor", competitive=True, df_fragments=frags)
    return out, out.attrs["fdr_estimator"]


def _world(n_peptides, n_windows, n_cycles=600, with_mobility=False, seed=5, noise=80):
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(
            n_peptides=n_peptides, n_windows=n_windows, n_cycles=n_cycles,
            noise_peaks_per_spectrum=noise, seed=seed, with_mobility=with_mobility,
        )
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    return spectra, prec, frag


def test_ids_at_1pct_fdr_match_jax():
    # one isolation window and dense noise: enough decoy PSMs for the network
    spectra, prec, frag = _world(300, 1, n_cycles=400, noise=200)
    jd, theirs, est_j = run_jax(spectra, prec, frag)
    ours, est = run_port(jd, prec, frag)
    assert est == est_j == "nn"
    tprec = frame_from_pandas(prec)

    def ids(out):
        return set(out["precursor_idx"][(out["qval"] <= 0.01) & (out["_decoy"] == 0)].tolist())

    a, b = ids(ours), ids(theirs)
    assert len(b) > 100
    assert abs(len(a) - len(b)) <= 0.03 * len(b)
    assert len(a & b) / len(a | b) >= 0.9
    share, _, _, _ = id_shares(jd.cycle_rt, tprec, ours)
    share_j, _, _, _ = id_shares(jd.cycle_rt, tprec, theirs)
    assert abs(share - share_j) <= 0.02


def main():
    ap = argparse.ArgumentParser(description="identified and false shares at 1% FDR, JAX drivers and the port")
    ap.add_argument("--peptides", type=int, default=1500)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--mobility", action="store_true")
    opt = ap.parse_args()
    spectra, prec, frag = _world(opt.peptides, opt.windows, with_mobility=opt.mobility)
    tprec = frame_from_pandas(prec)
    t0 = time.perf_counter()
    jd, theirs, est_j = run_jax(spectra, prec, frag)
    print(f"JAX:  estimator {est_j}, identified/false/targets/decoys {id_shares(jd.cycle_rt, tprec, theirs)}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ours, est = run_port(jd, prec, frag)
    print(f"port: estimator {est}, identified/false/targets/decoys {id_shares(jd.cycle_rt, tprec, ours)}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
