"""Train and package the default peptide property models (RT, charge, MS2,
CCS).

    python -m alphadia_torch.scripts.train_property_models [--out DIR] [--device cpu] [--revalidate | --retrain-charge]

The models power library-free search. The corpus comes from seeded
peptide-physics worlds (``testing/physics.py``): sequence-determined RT,
charge states, fragmentation and mobility from published chemistry rules,
plus a random interaction table per world that the models must learn
rather than recall. The corpus mixes three world seeds, so the models can
profit only from the chemistry the worlds share. Packaging is gated on
three legs:

1. within-world held-out sequences;
2. cross-world: fresh sequences in a world seed never trained on, where
   the models must beat the RT heuristic;
3. published constants: predicted RT order against the Krokhin 2004
   coefficient sums, the mass-CCS trend per charge (Meier et al. 2021),
   and tryptic charge priors.

The models train on the device (``FinetuneManager``: 80 epochs, batches of
1,024, ``max_lr`` 1e-4, random state 0) at the shipped widths, from flax's
initialisation drawn without JAX. When every bar passes, ``models.pkl``
goes to ``--out`` (default: the port's
``constants/weights/peptdeep_default``); otherwise nothing is written and
the exit code is 1. ``--revalidate`` runs the published-constants gates on
the packaged models and writes them with the refreshed metrics;
``--retrain-charge`` retrains the charge model alone on the packaged ones.

The corpora, fits and gates are those of the JAX package's
``scripts/train_property_models.py``, on column dicts: pandas' average
``rank`` is ``scipy.stats.rankdata`` here. The charge fit groups
sequences by ``mod_seq_hash``, Python's ``hash`` of the sequence (as in
JAX), whose order differs between processes unless ``PYTHONHASHSEED`` is
set.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
from scipy.stats import rankdata

from alphadia_torch.models.finetune import FinetuneManager, _r2, _spectral_angle
from alphadia_torch.models.prediction import PACKAGED_MODELS, predict_rt_norm
from alphadia_torch.models.property_models import MAX_LEN
from alphadia_torch.testing.physics import _MASS, _RC, FRAG_COLS, PeptidePhysics
from alphadia_torch.utils.frame import concat, take

_AA = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
_AA_NO_KR = np.array(list("ACDEFGHILMNPQSTVWY"))
OUT_DIR = PACKAGED_MODELS
CONFIG = {"epochs": 80, "batch_size": 1024, "max_lr": 1e-4}
TRAIN_WORLD_SEEDS = (2026, 3571, 9110)  # the "measured datasets" the models see
EVAL_WORLD_SEED = 4053  # never trained on — fresh interaction tables
SEQUENCES_PER_WORLD = 12000
MS2_SUBSET = 21000  # MS2 and CCS train on a stratified subset (dense targets are heavy)
EVAL_SEQUENCES = 3000

_FRAG_TYPE = np.array([ord(c.split("_z")[0]) for c in FRAG_COLS], np.int64)
_FRAG_CHARGE = np.array([int(c.split("_z")[1]) for c in FRAG_COLS], np.int64)
_FRAG_KEY = _FRAG_TYPE * 16 + _FRAG_CHARGE  # ascending: FRAG_COLS is b_z1, b_z2, y_z1, y_z2


def _tryptic_sequences(rng: np.random.Generator, n: int) -> list[str]:
    lens = rng.integers(7, 31, n)
    seqs = []
    for ln in lens:
        body = "".join(rng.choice(_AA, size=ln - 1))
        tail = rng.choice(["K", "R"]) if rng.random() < 0.9 else rng.choice(_AA)
        seqs.append(body + tail)
    return seqs


def _frame(seqs, physics: PeptidePhysics, rng, with_frags: bool = True) -> tuple[dict, dict]:
    """(psm, frag) column dicts shaped for the ``FinetuneManager`` fits."""
    n = len(seqs)
    charge_p = physics.charge_probs(seqs)
    charges = (2 + np.argmax(charge_p[:, 1:4], axis=1)).astype(np.int32)
    psm = {
        "precursor_idx": np.arange(n, dtype=np.int64),
        "sequence": np.array(seqs, dtype=object),
        "mods": np.full(n, "", dtype=object),
        "mod_sites": np.full(n, "", dtype=object),
        "charge": charges,
        "rt_norm": physics.rt_norm(seqs),
        "mobility_observed": physics.mobility(seqs, charges),
        "mod_seq_hash": np.array([hash(s) for s in seqs], dtype=np.int64),
    }
    pidx, cols, sites, inten = [], [], [], []
    if with_frags:
        for i, (s, z) in enumerate(zip(seqs, charges)):
            mat = physics.ms2_matrix(s, int(z))
            site, col = np.nonzero(mat > 0.01)
            pidx.append(np.full(len(site), i, np.int64))
            sites.append(site.astype(np.int64))
            cols.append(col)
            inten.append(mat[site, col].astype(np.float64))
    col = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    frag = {
        "precursor_idx": np.concatenate(pidx) if pidx else np.zeros(0, np.int64),
        "type": _FRAG_TYPE[col],
        "charge": _FRAG_CHARGE[col],
        "position": np.concatenate(sites) if sites else np.zeros(0, np.int64),
        "intensity": np.concatenate(inten) if inten else np.zeros(0, np.float64),
    }
    return psm, frag


def _multi_world_frame(seqs_per_world, physics_list, rng, with_frags=True) -> tuple[dict, dict]:
    """Per-world (psm, frag) frames one after another, precursor_idx disjoint."""
    psms, frags, offset = [], [], 0
    for seqs, physics in zip(seqs_per_world, physics_list):
        psm, frag = _frame(seqs, physics, rng, with_frags=with_frags)
        psm["precursor_idx"] = psm["precursor_idx"] + offset
        frag["precursor_idx"] = frag["precursor_idx"] + offset
        offset += len(psm["precursor_idx"])
        psms.append(psm)
        frags.append(frag)
    return concat(psms), concat(frags)


def _eval_world(mgr, seqs, physics, rng, tag) -> dict:
    """RT R^2 (model vs heuristic) + MS2 spectral angle on one world."""
    ho_psm, ho_frag = _frame(seqs, physics, rng)
    rt_true = ho_psm["rt_norm"]
    r2_model = _r2(rt_true, mgr.predict_rt(seqs))
    r2_heur = _r2(rt_true, predict_rt_norm(seqs))

    n = len(seqs)
    pred = mgr.predict_ms2(seqs, [""] * n, [""] * n, ho_psm["charge"])
    target = np.zeros((n, MAX_LEN - 1, len(FRAG_COLS)), np.float32)
    pos = ho_frag["position"]
    keep = pos < MAX_LEN - 1
    col = np.searchsorted(_FRAG_KEY, ho_frag["type"] * 16 + ho_frag["charge"])
    target[ho_frag["precursor_idx"][keep], pos[keep], col[keep]] = ho_frag["intensity"][keep]
    sa = float(np.nanmean(_spectral_angle(pred.reshape(n, -1), target.reshape(n, -1))))
    print(f"[{tag}] RT R^2: model {r2_model:.3f} vs heuristic {r2_heur:.3f}; MS2 spectral angle {sa:.3f}", flush=True)
    return {"rt_r2": r2_model, "rt_r2_heuristic": r2_heur, "ms2_sa": sa}


def _spearman(a, b) -> float:
    """pandas' ``corr`` of average ranks."""
    return float(np.corrcoef(rankdata(a), rankdata(b))[0, 1])


def _ccs_trend_check(mgr, seqs) -> dict:
    """Predicted mobility against the published mass-CCS trend (Meier et
    al., Nat. Commun. 2021): within a charge state 1/K0 follows peptide mass
    closely (r about 0.95), and at a fixed mass a higher charge means a
    lower 1/K0. Gates: Pearson r(pred 1/K0, mass) >= 0.9 at z = 2 and 3;
    median 1/K0 at z=2 above that at z=3 on the same peptides."""
    mass = np.array([sum(_MASS.get(a, 110.0) for a in s) + 18.01056 for s in seqs])
    out, per_z = {}, {}
    for z in (2, 3):
        charges = np.full(len(seqs), z, np.int32)
        mob = mgr.predict_mobility(seqs, [""] * len(seqs), [""] * len(seqs), charges)
        per_z[z] = mob
        r = float(np.corrcoef(mass, mob)[0, 1])
        out[f"mass_corr_z{z}"] = r
        print(f"[ccs] Pearson r(pred 1/K0, mass) at z={z}: {r:.3f}", flush=True)
    out["charge_ordering_ok"] = bool(np.median(per_z[2]) > np.median(per_z[3]))
    print(f"[ccs] median 1/K0 z=2 {np.median(per_z[2]):.3f} > z=3 {np.median(per_z[3]):.3f}: "
          f"{out['charge_ordering_ok']}", flush=True)
    return out


def _trypsin_faithful_sequences(rng: np.random.Generator, n: int) -> list[str]:
    """Fully tryptic peptides: one C-terminal K/R, no internal K/R."""
    return [
        "".join(rng.choice(_AA_NO_KR, size=ln - 1)) + rng.choice(["K", "R"])
        for ln in rng.integers(7, 31, n)
    ]


def _charge_prior_check(mgr, seqs) -> dict:
    """Predicted charge priors against tryptic expectations: on 2,000
    trypsin-faithful sequences argmax charge 2 or 3 for >= 80% and 1 for
    < 5%; on ``seqs`` Spearman rho(expected charge, #KRH) >= 0.6."""
    tryptic = _trypsin_faithful_sequences(np.random.default_rng(773), 2000)
    probs = mgr.predict_charge(tryptic)  # (n, max_charge), z = 1..max
    zs = np.arange(1, probs.shape[1] + 1)
    top = zs[np.argmax(probs, axis=1)]
    frac23 = float(np.mean((top == 2) | (top == 3)))
    frac1 = float(np.mean(top == 1))

    probs_mixed = mgr.predict_charge(seqs)
    p = probs_mixed / np.clip(probs_mixed.sum(axis=1, keepdims=True), 1e-9, None)
    ez = p @ zs
    basic = np.array([sum(s.count(a) for a in "KRH") for s in seqs])
    rho = _spearman(ez, basic)
    print(f"[charge] tryptic argmax in {{2,3}}: {frac23:.3f} (z=1: {frac1:.3f}); "
          f"Spearman rho(E[z], #KRH) = {rho:.3f}", flush=True)
    return {"frac_top_2_or_3": frac23, "frac_top_1": frac1, "basic_residue_spearman": rho}


def _krokhin_order_check(mgr, seqs) -> float:
    """Spearman rho of predicted RT against the raw Krokhin 2004 coefficient
    sums: on unmodified peptides the additive hydrophobicity is the
    dominant transferable RT signal."""
    krokhin = np.array([sum(_RC.get(a, 0.0) for a in s) for s in seqs])
    rho = _spearman(krokhin, mgr.predict_rt(seqs))
    print(f"[krokhin] Spearman rho(model RT, raw Krokhin sum) = {rho:.3f}", flush=True)
    return rho


def _published_constants_gates(mgr, seqs) -> dict:
    """All three published-constants gates on one sequence set; ``ok`` is
    the packaging condition."""
    rho = _krokhin_order_check(mgr, seqs)
    ccs = _ccs_trend_check(mgr, seqs)
    charge = _charge_prior_check(mgr, seqs)
    pub = {"krokhin_spearman": rho, "ccs": ccs, "charge": charge, "eval_n": len(seqs)}
    pub["ok"] = bool(
        rho >= 0.9
        and ccs["mass_corr_z2"] >= 0.9
        and ccs["mass_corr_z3"] >= 0.9
        and ccs["charge_ordering_ok"]
        and charge["frac_top_2_or_3"] >= 0.8
        and charge["frac_top_1"] < 0.05
        and charge["basic_residue_spearman"] >= 0.6
    )
    return pub


def _training_sequences(per_world: int) -> tuple[list[list[str]], set, np.random.Generator]:
    """Each training world's sequences, none repeated across worlds; the
    set of them; the generator that drew them."""
    rng = np.random.default_rng(11)
    seqs, seen = [], set()
    for _ in TRAIN_WORLD_SEEDS:
        world = [s for s in dict.fromkeys(_tryptic_sequences(rng, per_world)) if s not in seen]
        seen.update(world)
        seqs.append(world)
    return seqs, seen, rng


def _unseen(seed: int, n: int, seen: set) -> list[str]:
    return [s for s in dict.fromkeys(_tryptic_sequences(np.random.default_rng(seed), n)) if s not in seen]


def passes_bars(within: dict, cross: dict, pub: dict) -> bool:
    """The packaging bars: each world's RT R^2 at least 0.9 and 0.1 above
    the heuristic's, MS2 angle 0.65 within and 0.6 across worlds, and the
    published-constants gates."""
    return bool(
        within["rt_r2"] >= max(within["rt_r2_heuristic"] + 0.1, 0.9)
        and within["ms2_sa"] >= 0.65
        and cross["rt_r2"] >= max(cross["rt_r2_heuristic"] + 0.1, 0.9)
        and cross["ms2_sa"] >= 0.6
        and pub["ok"]
    )


def summary(metrics: dict, within: dict, cross: dict, pub: dict) -> dict:
    """The readings a run is held to: each fit's own metric and epochs, the
    held-out legs and the published-constants gates."""
    return {
        "rt_r2": float(metrics["rt"]["r2"]), "charge_accuracy": float(metrics["charge"]["accuracy"]),
        "ms2_sa": float(metrics["ms2"]["spectral_angle"]), "ccs_r2": float(metrics["ccs"]["r2"]),
        "epochs": [len(metrics[m]["history"]) for m in ("rt", "charge", "ms2", "ccs")],
        "holdout_rt_r2": float(within["rt_r2"]), "holdout_ms2_sa": float(within["ms2_sa"]),
        "cross_rt_r2": float(cross["rt_r2"]), "cross_ms2_sa": float(cross["ms2_sa"]),
        "krokhin_spearman": float(pub["krokhin_spearman"]), "ccs_mass_corr_z2": float(pub["ccs"]["mass_corr_z2"]),
        "ccs_mass_corr_z3": float(pub["ccs"]["mass_corr_z3"]),
        "charge_frac_top_2_or_3": float(pub["charge"]["frac_top_2_or_3"]),
        "charge_basic_spearman": float(pub["charge"]["basic_residue_spearman"]),
    }


def train(out_dir=None, device=None, sequences_per_world: int = SEQUENCES_PER_WORLD, ms2_subset: int = MS2_SUBSET,
          eval_sequences: int = EVAL_SEQUENCES, epochs: int = CONFIG["epochs"], write: bool = True) -> dict:
    """Train the four models, gate them and (when every bar passes and
    ``write``) save them to ``out_dir``. Returns ``within``, ``cross``,
    ``pub``, ``passed``, ``fits`` (each model's epochs, steps and seconds)
    and the manager ``mgr``. The sizes and ``epochs`` cut the run where it must be
    short; their defaults are the packaged run's."""
    train_worlds = [PeptidePhysics(seed=s) for s in TRAIN_WORLD_SEEDS]
    per_world, seen, rng = _training_sequences(sequences_per_world)
    n_train = sum(len(s) for s in per_world)
    holdout = _unseen(99, eval_sequences, seen)  # unseen sequences, a trained world
    xworld = _unseen(101, eval_sequences, seen)  # unseen sequences and an unseen world
    print(f"{n_train} training sequences over {len(TRAIN_WORLD_SEEDS)} worlds / "
          f"{len(holdout)} within-world held-out / {len(xworld)} cross-world", flush=True)

    psm, frag = _multi_world_frame(per_world, train_worlds, rng)
    mgr = FinetuneManager(config={**CONFIG, "epochs": epochs}, random_state=0, device=device)
    fits = {}

    def fit(name, *frames):
        # each fit ends with its predictions copied to the host: the wall is the device's too
        t0 = time.perf_counter()
        getattr(mgr, f"finetune_{name}")(*frames)
        f = fits[name] = {**mgr.trainer.last_fit, "seconds": time.perf_counter() - t0}
        print(f"[{name}] {f['epochs']} epochs, {f['steps']} steps, {f['seconds']:.2f} s "
              f"({f['seconds'] / max(f['steps'], 1) * 1e3:.2f} ms a step)", flush=True)

    fit("rt", psm)
    fit("charge", psm)
    # stratified across the worlds: precursor_idx is the concatenation's
    # order, so the first rows would be one world's alone
    n = len(psm["precursor_idx"])
    sub_idx = np.sort(np.random.default_rng(7).choice(n, min(ms2_subset, n), replace=False))
    sub = take(psm, sub_idx)
    keep = np.zeros(n, bool)
    keep[sub_idx] = True
    sub_frag = take(frag, keep[frag["precursor_idx"]])
    print(f"MS2/CCS subset per world: {np.histogram(sub_idx, bins=len(TRAIN_WORLD_SEEDS))[0].tolist()}", flush=True)
    fit("ms2", sub, sub_frag)
    fit("ccs", sub)

    within = _eval_world(mgr, holdout, train_worlds[0], rng, "within-world")
    cross = _eval_world(mgr, xworld, PeptidePhysics(seed=EVAL_WORLD_SEED), rng, "cross-world")
    pub = _published_constants_gates(mgr, xworld)
    passed = passes_bars(within, cross, pub)
    print(f"summary {json.dumps(summary(mgr.metrics, within, cross, pub))}", flush=True)
    if not passed:
        print("models do not beat the bar — NOT packaging", flush=True)
    elif write:
        mgr.metrics["holdout"] = within
        mgr.metrics["cross_world"] = {**cross, "eval_seed": EVAL_WORLD_SEED, "train_seeds": list(TRAIN_WORLD_SEEDS),
                                      "krokhin_spearman": pub["krokhin_spearman"]}
        mgr.metrics["published_constants"] = pub
        out = Path(out_dir if out_dir is not None else OUT_DIR)
        mgr.save(out)
        print(f"saved {out / 'models.pkl'}", flush=True)
    return dict(within=within, cross=cross, pub=pub, passed=passed, fits=fits, mgr=mgr)


def retrain_charge(out_dir=None, device=None, source=OUT_DIR) -> bool:
    """Retrain only the charge model of ``source``'s models on the worlds'
    charge corpus, from a fresh initialisation, and re-gate; the RT, MS2 and
    CCS models are kept. Saves to ``out_dir`` when the gates pass."""
    mgr = FinetuneManager.load(source, config=CONFIG, device=device)
    train_worlds = [PeptidePhysics(seed=s) for s in TRAIN_WORLD_SEEDS]
    per_world, seen, rng = _training_sequences(SEQUENCES_PER_WORLD)
    psm, _ = _multi_world_frame(per_world, train_worlds, rng, with_frags=False)
    mgr.variables.pop("charge", None)  # a fresh init, not a warm start
    mgr.models.pop("charge", None)
    mgr.finetune_charge(psm)
    pub = _published_constants_gates(mgr, _unseen(101, EVAL_SEQUENCES, seen))
    if not pub["ok"]:
        print("retrained charge head FAILS the published-constants gates", flush=True)
        return False
    mgr.metrics["published_constants"] = pub
    out = Path(out_dir if out_dir is not None else OUT_DIR)
    mgr.save(out)
    print(f"re-saved {out / 'models.pkl'} with retrained charge head", flush=True)
    return True


def revalidate(out_dir=None, device=None, source=OUT_DIR) -> bool:
    """The published-constants gates on ``source``'s models, saved with the
    refreshed metrics to ``out_dir`` (no training) when they pass."""
    mgr = FinetuneManager.load(source, device=device)
    pub = _published_constants_gates(mgr, _unseen(101, EVAL_SEQUENCES, set()))
    if not pub["ok"]:
        print("packaged models FAIL the published-constants gates", flush=True)
        return False
    mgr.metrics["published_constants"] = pub
    if "cross_world" in mgr.metrics:
        mgr.metrics["cross_world"]["krokhin_spearman"] = pub["krokhin_spearman"]
    out = Path(out_dir if out_dir is not None else OUT_DIR)
    mgr.save(out)
    print(f"re-saved {out / 'models.pkl'} with published-constants gates", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT_DIR, help="directory of models.pkl")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--revalidate", action="store_true", help="re-gate the packaged models, no training")
    mode.add_argument("--retrain-charge", action="store_true", help="retrain the packaged charge model alone")
    opt = ap.parse_args(argv)
    if opt.revalidate:
        ok = revalidate(opt.out, opt.device)
    elif opt.retrain_charge:
        ok = retrain_charge(opt.out, opt.device)
    else:
        ok = train(opt.out, opt.device)["passed"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
