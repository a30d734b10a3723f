"""One process of the port's multi-process tests (``tests/test_torch_distributed_spawn.py``).

    python tests/torch_distributed_worker.py scoring <rank> <n> <port>
    python tests/torch_distributed_worker.py search <out> <library> <raw> [<raw> ...]

``scoring`` joins a ``gloo`` group at ``127.0.0.1:<port>``, takes its share
of a file list, scores its rows of a batch of candidates on the CPU and
brings the features of every process together (the counterpart of the JAX
package's ``tests/distributed_worker.py``). ``search`` runs one
``SearchStep`` on the CPU, the group (if any) given by the environment as
a user's launcher gives it; ``general.fail_fast`` is set. Each prints one
JSON line last.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
torch.set_num_threads(2)

FILES = [f"run{i}.mzML" for i in range(5)]


def scoring_world():
    """(DiaData, precursors, fragments, candidates) of a small seeded world."""
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
    from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia

    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(n_peptides=200, n_windows=4, n_cycles=200, seed=13))
    prec, frag = add_synthetic_decoys(prec, frag)
    dia = DiaData.from_spectra(spectra)
    cands = CandidateSelection(dia, prec, frag, SelectionConfig(batch_size=256), device="cpu")()
    return dia, prec, frag, cands


def feature_matrix(dia, prec, frag, cands) -> torch.Tensor:
    """The scoring features of ``cands``' PSMs, NaN and inf as 0, float64."""
    from alphadia_torch.search.scoring import FEATURE_COLUMNS, CandidateScoring, ScoringConfig

    psm, _ = CandidateScoring(dia, prec, frag, ScoringConfig(batch_size=256), device="cpu")(cands)
    feats = np.stack([psm[c] for c in FEATURE_COLUMNS], axis=1).astype(np.float64)
    return torch.from_numpy(np.nan_to_num(feats, posinf=0.0, neginf=0.0))


def scoring(rank: int, n: int, port: str) -> dict:
    from alphadia_torch.parallel import distributed
    from alphadia_torch.utils.frame import take

    assert distributed.initialize_distributed(f"127.0.0.1:{port}", n, rank)
    assert (distributed.process_index(), distributed.process_count()) == (rank, n)
    dia, prec, frag, cands = scoring_world()
    rows = distributed.process_rows(len(cands["precursor_idx"]))
    feats = feature_matrix(dia, prec, frag, take(cands, np.arange(rows.start, rows.stop)))
    gathered = distributed.all_gather_rows(feats)
    total = distributed.all_sum(torch.tensor([feats.sum().item(), float(feats.numel())], dtype=torch.float64))
    distributed.barrier("scoring_done")
    return {
        "pid": rank,
        "files": distributed.shard_files_for_host(FILES),
        "rows": [rows.start, rows.stop],
        "gmean": float(gathered.mean()),
        "smean": float(total[0] / total[1]),
        "n_psm": int(gathered.shape[0]),
    }


def search(out: str, library: str, raws: list[str]) -> dict:
    from torch_workflow_worlds import E2E_OVERRIDES

    from alphadia_torch.parallel import distributed
    from alphadia_torch.search_step import SearchStep

    out = Path(out)
    config = {
        **E2E_OVERRIDES,
        "general": {**E2E_OVERRIDES["general"], "fail_fast": True},
        "library_path": library,
        "raw_paths": raws,
    }
    step = SearchStep(str(out), config=config, device="cpu")
    result = {"pid": distributed.process_index(), "error": None}
    try:
        step.run()
    except Exception as e:  # reported, then raised again: the process exits non-zero
        result["error"] = type(e).__name__
        raise
    finally:
        result.update(
            process_count=distributed.process_count(),
            rank=distributed.process_index(),
            runs_with_psm=sorted(p.parent.name for p in (out / "quant").glob("*/psm.parquet")),
            built_at_return=(out / "stat.tsv").exists() and (out / "precursors.parquet").exists(),
        )
        print(json.dumps(result), flush=True)
    return result


def main() -> None:
    case = sys.argv[1]
    if case == "scoring":
        print(json.dumps(scoring(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])), flush=True)
    elif case == "search":
        search(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        raise SystemExit(f"unknown case {case!r}")


if __name__ == "__main__":
    main()
