"""Device ops: the compaction merge and the query filters on the card.

``bitonic`` holds the merge kernels' wrappers, ``merge`` K7's sort +
dedup and ``query_kernels`` the filter and aggregate kernels' (CUDA
kernels in ``csrc/``, built and
bound by ``_cuda``, which also keeps every wrapper's launch count),
each with its plain PyTorch version; ``device_compaction`` is the merge
strategy over them, ``pipeline`` the partitioned, overlapped path for
big merges and ``sort`` the hash memtable's flush sort.
"""
