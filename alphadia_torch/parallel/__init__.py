"""Several cards and several processes: device lists and row shards
(``mesh``), the process group and the file split (``distributed``), and the
XIC kernel run on each device's shard (``shard_ops``)."""

from alphadia_torch.parallel.mesh import gather_rows, make_mesh, shard_bounds

__all__ = ["gather_rows", "make_mesh", "shard_bounds"]
