"""dbeel_tpu_torch — the storage engine of dbeel_tpu on PyTorch + CUDA.

A port of ``dbeel_tpu`` (the JAX package, kept beside it as the
reference) to an NVIDIA H100.  The serving stack of dbeel runs no
device code; the device does one job, the storage engine's bulk
sorted-data compute.  This package holds that storage engine —
write → WAL → memtable → flush → SSTable → compaction → read → filtered
scan — with the compaction merge, the hash memtable's flush sort and
the coalesced merges on the card through hand-written CUDA bitonic
kernels (``csrc/bitonic.cu``), the distributed merge as a sample sort
over a mesh of partitions (``parallel/``, ``csrc/dist.cu``), and the
filtered scan's numeric leaves through CUDA filter kernels
(``csrc/query.cu``), all built and bound in ``ops/_cuda.py``.

It imports ``torch`` and ``numpy`` and nothing of ``dbeel_tpu``; the
on-disk formats are byte-identical, so a directory written by one
package opens in the other (``storage.import_tree``).

Layer map:
  query spec  dbeel_tpu_torch.query (golden evaluator, aggregates)
  L3 storage  dbeel_tpu_torch.storage.lsm_tree
  scan        dbeel_tpu_torch.storage.{scan_stage,query_vec,range_digest}
  L2 io/cache dbeel_tpu_torch.storage.{page_cache,file_io,entry_writer,
              sstable,wal,native}
  merge seam  dbeel_tpu_torch.storage.compaction.get_strategy
  device ops  dbeel_tpu_torch.ops.{device_compaction,pipeline,bitonic,
              merge,sort,query_kernels}
  mesh        dbeel_tpu_torch.parallel.{mesh,dist_merge}
  kernels     dbeel_tpu_torch/csrc/{bitonic,query,dist}.cu (ops/_cuda.py
              builds them)
  codec       dbeel_tpu_torch.utils.msgpack_codec (no msgpack package)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which selects the kernels' plain PyTorch versions (the CPU tests).
"""

__version__ = "0.1.0"
