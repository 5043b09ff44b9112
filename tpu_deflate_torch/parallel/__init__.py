"""Data parallelism over devices and processes: ``shard`` (the mesh, the
sharded encode and decode) and ``multihost`` (process start-up and
per-process batches) on ``torch.distributed``."""
