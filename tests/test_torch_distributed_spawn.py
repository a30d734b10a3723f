"""The port on several processes, on the CPU: two processes join one
``gloo`` group over TCP on localhost (``tests/torch_distributed_worker.py``).

- Batch-parallel: the file split partitions the list; each process scores
  its rows of a batch, and the features gathered from the group give the
  same mean on both processes, equal to one process's within 1e-6 (the
  counterpart of the JAX package's ``test_two_process_batch_parallel_scoring``).
- File-parallel: one ``SearchStep`` over two runs on two processes
  (``torchrun``'s environment): each process searches one run, process 0
  builds the cross-run outputs over both, process 1 returns after they
  exist, and each run's ``psm.parquet`` equals that of the same step on one
  process (each file keeps its seed on whichever process searches it).
- ``fail_fast`` on one process (the JAX package's environment contract):
  both processes end within their timeout, the failing one with its error
  after process 0 has built the outputs.

Every process has its own timeout; when one fails or hangs, every process
of the case is killed.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from alphadia_torch.utils.parquet import read_parquet
from alphadia_torch.utils.tsv import read_tsv
from torch_workflow_worlds import E2E_WORLD, write_cli_inputs

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_distributed_worker.py"
TIMEOUT_S = 240
_CLEARED = (
    "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
    "ALPHADIA_TPU_COORDINATOR", "ALPHADIA_TPU_NUM_PROCESSES", "ALPHADIA_TPU_PROCESS_ID",
    "SLURM_JOB_ID", "SLURM_PROCID", "SLURM_NTASKS", "KUBERNETES_SERVICE_HOST",
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _CLEARED}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_all(commands: list[tuple[list, dict]]) -> list[tuple[int, dict | None, str]]:
    """Start every command at once; ``(exit code, its last JSON line, stderr)``
    for each. Kills them all when one outlives ``TIMEOUT_S``."""
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=env)
        for args, env in commands
    ]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            out.append((p.returncode, json.loads(lines[-1]) if lines else None, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_two_process_batch_parallel_scoring():
    import torch

    import torch_distributed_worker as worker

    port = free_port()
    results = run_all([(["scoring", str(rank), "2", str(port)], clean_env()) for rank in range(2)])
    for code, _, err in results:
        assert code == 0, err[-3000:]
    by_pid = {r["pid"]: r for _, r, _ in results}
    assert set(by_pid) == {0, 1}
    files = by_pid[0]["files"] + by_pid[1]["files"]
    assert sorted(files) == sorted(worker.FILES) and not set(by_pid[0]["files"]) & set(by_pid[1]["files"])
    assert by_pid[0]["rows"][1] == by_pid[1]["rows"][0] and by_pid[0]["rows"][0] == 0
    # the collectives gave each process the same value
    assert by_pid[0]["gmean"] == by_pid[1]["gmean"] and by_pid[0]["smean"] == by_pid[1]["smean"]
    assert abs(by_pid[0]["gmean"]) > 0

    torch.set_num_threads(2)
    dia, prec, frag, cands = worker.scoring_world()
    one = worker.feature_matrix(dia, prec, frag, cands)
    assert by_pid[0]["n_psm"] == one.shape[0]
    assert abs(by_pid[0]["gmean"] - float(one.mean())) <= 1e-6 * max(1.0, abs(float(one.mean())))
    assert abs(by_pid[0]["smean"] - float(one.mean())) <= 1e-6 * max(1.0, abs(float(one.mean())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spawn")
    raws, lib, _, _ = write_cli_inputs(tmp, E2E_WORLD)
    return tmp, [str(r) for r in raws], str(lib)


def test_two_process_search_step_builds_the_outputs_once_on_process_zero(runs):
    tmp, raws, lib = runs
    port = free_port()
    group = [
        (["search", str(tmp / "two"), lib, *raws],
         clean_env(WORLD_SIZE=2, RANK=rank, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=2, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port))
        for rank in range(2)
    ]
    alone = (["search", str(tmp / "one"), lib, *raws], clean_env())
    results = run_all(group + [alone])
    for code, result, err in results:
        assert code == 0 and result["error"] is None, err[-3000:]
    (_, r0, _), (_, r1, _), (_, r_one, _) = results
    assert (r0["rank"], r1["rank"], r0["process_count"], r_one["process_count"]) == (0, 1, 2, 1)
    assert r0["runs_with_psm"] == r1["runs_with_psm"] == ["run_0", "run_1"]
    # process 1 returned after process 0 had written the outputs
    assert r1["built_at_return"] and r0["built_at_return"]
    precursors = read_parquet(tmp / "two" / "precursors.parquet")
    assert sorted(set(precursors["raw.name"].tolist())) == ["run_0", "run_1"] and len(precursors["raw.name"]) > 100
    assert len(read_tsv(tmp / "two" / "stat.tsv")["run"]) == 2
    # each file searched on either process keeps its seed: the same PSMs
    for run in ("run_0", "run_1"):
        two = read_parquet(tmp / "two" / "quant" / run / "psm.parquet")
        one = read_parquet(tmp / "one" / "quant" / run / "psm.parquet")
        assert list(two) == list(one) and len(two["precursor_idx"]) > 100
        for c in one:
            np.testing.assert_array_equal(two[c], one[c], err_msg=f"{run} {c}")


def test_fail_fast_on_one_process_raises_after_the_barriers(runs, tmp_path):
    tmp, raws, lib = runs
    bad = tmp_path / "run_bad.mzML"
    bad.write_text("<mzML>not a run</mzML>")
    port = free_port()
    results = run_all([
        (["search", str(tmp_path / "out"), lib, raws[0], str(bad)],
         clean_env(ALPHADIA_TPU_COORDINATOR=f"127.0.0.1:{port}", ALPHADIA_TPU_NUM_PROCESSES=2,
                   ALPHADIA_TPU_PROCESS_ID=rank))
        for rank in range(2)
    ])
    (code0, r0, err0), (code1, r1, err1) = results
    assert code0 == 0 and r0["error"] is None, err0[-3000:]
    assert code1 != 0 and r1["error"] is not None and r1["rank"] == 1, err1[-3000:]
    assert "fail_fast" in err1
    # raised after process 0 had built the outputs of the run that was searched
    assert r1["built_at_return"] and r0["runs_with_psm"] == ["run_0"]
