"""The port's ``parallel`` helpers against the JAX package's, on the CPU.

- ``shard_files_for_host`` gives each process the files JAX gives it;
- ``initialize_distributed`` joins nothing outside a job, nor where only
  ``KUBERNETES_SERVICE_HOST`` or ``SLURM_JOB_ID`` is set;
- the three forms of the environment contract (the JAX package's,
  ``torchrun``'s, Slurm's with a coordinator) read as one (address, n, rank);
- ``data_parallel_devices`` splits where JAX's ``data_parallel_mesh`` does,
  over as many devices (JAX on the suite's virtual 8-device CPU mesh);
- ``pad_to_multiple`` equals JAX's; the cards split among a host's
  processes with more, as many and fewer cards than processes, and a
  ``SearchStep`` makes its process's first card the current device.
"""

import jax
import numpy as np
import pytest
import torch

from alphadia_torch.parallel import distributed, mesh
from alphadia_torch.search.common import data_parallel_devices
from alphadia_tpu.parallel import distributed as jax_distributed
from alphadia_tpu.parallel import mesh as jax_mesh
from alphadia_tpu.search.common import data_parallel_mesh

pytest_plugins = ("torch_port_plugin",)

_CONTRACT_VARS = (
    "ALPHADIA_TPU_COORDINATOR", "ALPHADIA_TPU_NUM_PROCESSES", "ALPHADIA_TPU_PROCESS_ID",
    "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
    "SLURM_JOB_ID", "SLURM_PROCID", "SLURM_NTASKS", "KUBERNETES_SERVICE_HOST",
)


@pytest.fixture()
def no_job(monkeypatch):
    for var in _CONTRACT_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n_files", [0, 1, 4, 12])
def test_file_split_is_jax(n_proc, n_files):
    files = [f"run{i}.mzML" for i in range(n_files)]
    parts = []
    for pid in range(n_proc):
        ours = distributed.shard_files_for_host(files, process_id=pid, num_processes=n_proc)
        assert ours == jax_distributed.shard_files_for_host(files, process_id=pid, num_processes=n_proc)
        parts += ours
    assert sorted(parts) == sorted(files)


@pytest.mark.parametrize("env", [{}, {"KUBERNETES_SERVICE_HOST": "10.0.0.1"}, {"SLURM_JOB_ID": "4711"}],
                         ids=["no_job", "kubernetes", "slurm_job"])
def test_no_group_outside_a_job(no_job, env):
    for k, v in env.items():
        no_job.setenv(k, v)
    assert distributed.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    distributed.barrier("nothing to wait for")
    assert distributed.process_rows(7) == slice(0, 7)


@pytest.mark.parametrize(
    "env",
    [
        {"ALPHADIA_TPU_COORDINATOR": "node0:5555", "ALPHADIA_TPU_NUM_PROCESSES": "4", "ALPHADIA_TPU_PROCESS_ID": "3"},
        {"MASTER_ADDR": "node0", "MASTER_PORT": "5555", "WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1"},
        {"MASTER_ADDR": "node0", "MASTER_PORT": "5555", "SLURM_NTASKS": "4", "SLURM_PROCID": "3",
         "SLURM_JOB_ID": "4711"},
    ],
    ids=["jax", "torchrun", "slurm"],
)
def test_the_three_contracts_read_alike(no_job, env):
    for k, v in env.items():
        no_job.setenv(k, v)
    assert distributed.environment_contract() == ("node0:5555", 4, 3)


def test_a_group_without_a_coordinator_raises(no_job):
    no_job.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no coordinator"):
        distributed.initialize_distributed()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh_devices", [None, 1, 2, 3, 4, 8])
def test_data_parallel_devices_follow_jax(mesh_devices):
    assert len(jax.devices()) == 8  # the suite's virtual CPU mesh
    for batch_size in (256, 1000, 1024, 3):
        theirs = data_parallel_mesh(mesh_devices, batch_size)
        ours = data_parallel_devices(mesh_devices, batch_size, devices=["cpu"] * 8)
        assert (ours is None) == (theirs is None), (mesh_devices, batch_size)
        if ours is not None:
            assert len(ours) == theirs.devices.size and all(d == torch.device("cpu") for d in ours)


@pytest.mark.parametrize("multiple", [1, 2, 3, 8])
def test_pad_to_multiple_is_jax(multiple):
    rng = np.random.default_rng(multiple)
    for shape, axis in (((7, 3), 0), ((8, 5), 0), ((4, 5), 1), ((0, 2), 0)):
        a = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(mesh.pad_to_multiple(a, multiple, axis), jax_mesh.pad_to_multiple(a, multiple, axis))


@pytest.mark.parametrize(
    "n_cards, local_world, expected",
    [
        (8, 2, [[0, 2, 4, 6], [1, 3, 5, 7]]),  # more cards than processes
        (4, 4, [[0], [1], [2], [3]]),  # as many
        (1, 2, [[0], [0]]),  # fewer: the processes share the card
        (3, 5, [[0], [1], [2], [0], [1]]),
    ],
    ids=["more_cards", "as_many", "one_card_two_processes", "fewer_cards"],
)
def test_cards_split_among_local_processes(n_cards, local_world, expected):
    assert [distributed.split_cards(n_cards, r, local_world) for r in range(local_world)] == expected


def test_rows_shard_and_gather_in_order():
    devices = mesh.make_mesh(devices=["cpu", "cpu", "cpu"])
    assert devices == [torch.device("cpu")] * 3 and mesh.make_mesh(2, devices=devices) == devices[:2]
    q = torch.arange(12).reshape(6, 2)
    bounds = mesh.shard_bounds(len(q), len(devices))
    assert bounds == [(0, 2), (2, 4), (4, 6)]
    assert torch.equal(mesh.gather_rows([q[lo:hi].to(d) for d, (lo, hi) in zip(devices, bounds)]), q)
    with pytest.raises(ValueError, match="equal shards"):
        mesh.shard_bounds(7, 2)


@pytest.mark.parametrize("local_rank, device, expected", [(0, None, 0), (1, None, 1), (1, "cuda", None)],
                         ids=["rank0", "rank1", "explicit_cuda"])
def test_a_step_makes_its_first_card_the_current_device(no_job, tmp_path, local_rank, device, expected):
    """Under ``torchrun`` on a 4-card node with 2 processes per node, process
    ``LOCAL_RANK`` takes cards ``LOCAL_RANK::2`` and makes the first of them
    its current device, so that what launches on the current device (the
    classifier's CUDA graph) runs on its own card; an explicit ``"cuda"``
    (the current card) changes nothing (the cards are simulated: this
    sandbox has none)."""
    from alphadia_torch.search_step import SearchStep

    current = []
    no_job.setattr(torch.cuda, "is_available", lambda: True)
    no_job.setattr(torch.cuda, "device_count", lambda: 4)
    no_job.setattr(torch.cuda, "set_device", current.append)
    no_job.setenv("LOCAL_RANK", str(local_rank))
    no_job.setenv("LOCAL_WORLD_SIZE", "2")
    s = SearchStep(str(tmp_path), device=device)
    if expected is None:
        assert s.devices == [torch.device("cuda")] and current == []
    else:
        assert s.devices == [torch.device("cuda", expected), torch.device("cuda", expected + 2)]
        assert current == [torch.device("cuda", expected)]
