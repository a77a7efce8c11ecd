"""Tombstone GC grace in dbeel_tpu_torch's compaction strategies.

Every strategy is held to the tree-level contract of
tests/test_gc_grace.py (its tests at :44, :70 and :131): a tombstone
younger than ``gc_grace_s`` survives a bottom-level compaction, and a
tombstone older than the grace, or any tombstone with no grace, is
dropped.  The strategies run on the CPU (``device="cpu"``, the kernels'
plain versions): heap, cpu, device, device_full, coalesced and
distributed (a mesh of repeated CPU devices).  device, coalesced and
distributed run once on their single-shot branch and once on their
pipeline branch (``PIPELINE_MIN_BYTES`` set to 0, the pipeline checked
to have written the output).  heap, cpu and device_full have no
pipeline branch.

The distributed pipeline branch passes the cutoff on, where dbeel_tpu's
drops it (dbeel_tpu/parallel/dist_merge.py:243-251).  These tests hold
the port to the contract, not to dbeel_tpu: dropping a young tombstone
would let a stale replica resurrect the deleted value.
"""

import asyncio

import pytest
import torch

from conftest import run

from dbeel_tpu_torch.ops import pipeline as tpipe
from dbeel_tpu_torch.ops.device_compaction import DeviceMergeStrategy
from dbeel_tpu_torch.parallel.dist_merge import DistributedMergeStrategy
from dbeel_tpu_torch.parallel.mesh import shard_mesh
from dbeel_tpu_torch.server.coalescer import (
    CoalescedDeviceMergeStrategy,
    CompactionCoalescer,
)
from dbeel_tpu_torch.storage import TOMBSTONE, LSMTree
from dbeel_tpu_torch.storage.compaction import get_strategy
from dbeel_tpu_torch.storage.native import load as native_load
from dbeel_tpu_torch.utils.timestamps import now_nanos

CPU = torch.device("cpu")


def _strategy(name):
    if name == "coalesced":
        return CoalescedDeviceMergeStrategy(CompactionCoalescer(device=CPU))
    if name == "distributed":
        return DistributedMergeStrategy(shard_mesh(4, devices=[CPU] * 4))
    if name in ("device", "device_full"):
        return get_strategy(name, device=CPU)
    return get_strategy(name)


# (strategy, branch): every strategy's single-shot merge, and the
# pipeline of the three that have one.
CASES = [
    (name, "single")
    for name in ("heap", "cpu", "device", "device_full", "coalesced",
                 "distributed")
] + [(name, "pipeline") for name in ("device", "coalesced", "distributed")]
IDS = [f"{name}-{branch}" for name, branch in CASES]


@pytest.fixture
def branch_of(monkeypatch):
    """Sets the branch a case runs on; returns a list that the pipeline
    branch fills with one entry per pipeline merge that wrote output."""
    wrote = []

    def set_branch(name, branch):
        if branch == "single":
            return wrote
        if native_load() is None:
            pytest.skip("the pipeline needs the native host runtime")
        cls = (DistributedMergeStrategy if name == "distributed"
               else DeviceMergeStrategy)
        monkeypatch.setattr(cls, "PIPELINE_MIN_BYTES", 0)
        real = tpipe._pipeline_merge_impl

        def spy(*a, **kw):
            res = real(*a, **kw)
            wrote.append(res is not None)
            return res

        monkeypatch.setattr(tpipe, "_pipeline_merge_impl", spy)
        return wrote

    return set_branch


async def _seed_tombstone(dir_path, strategy, gc_grace_s):
    """Two tables: k=v1 and other=x, then a newer one holding k's
    tombstone; returns the tree and its table indices, ready for a
    bottom-level compaction (keep_tombstones=False)."""
    tree = LSMTree.open_or_create(
        dir_path, capacity=8, strategy=strategy, gc_grace_s=gc_grace_s
    )
    old_ts = now_nanos()
    await tree.set_with_timestamp(b"k", b"v1", old_ts)
    await tree.set_with_timestamp(b"other", b"x", old_ts)
    await tree.flush()
    del_ts = now_nanos()
    await tree.set_with_timestamp(b"k", TOMBSTONE, del_ts)
    await tree.flush()
    indices = [i for i, _s in tree.sstable_indices_and_sizes()]
    assert len(indices) == 2, indices
    return tree, indices, del_ts


async def _compact_bottom(tree, indices):
    await tree.compact(indices, max(indices) + 1, keep_tombstones=False)


def _check_branch(branch, wrote):
    if branch == "pipeline":
        assert wrote == [True], f"the pipeline did not write: {wrote}"
    else:
        assert not wrote


@pytest.mark.parametrize("name,branch", CASES, ids=IDS)
def test_tombstone_survives_bottom_compaction_within_grace(
    tmp_dir, branch_of, name, branch
):
    wrote = branch_of(name, branch)

    async def main():
        tree, indices, del_ts = await _seed_tombstone(
            f"{tmp_dir}/t", _strategy(name), gc_grace_s=3600.0
        )
        await _compact_bottom(tree, indices)
        entry = await tree.get_entry(b"k")
        assert entry is not None, (
            "gc_grace must keep a fresh tombstone through the "
            "bottom-level merge"
        )
        assert bytes(entry[0]) == TOMBSTONE
        assert entry[1] == del_ts
        other = await tree.get_entry(b"other")
        assert bytes(other[0]) == b"x"
        tree.close()

    run(main(), timeout=60)
    _check_branch(branch, wrote)


@pytest.mark.parametrize("name,branch", CASES, ids=IDS)
def test_tombstone_dropped_without_grace(tmp_dir, branch_of, name, branch):
    wrote = branch_of(name, branch)

    async def main():
        tree, indices, _del = await _seed_tombstone(
            f"{tmp_dir}/t", _strategy(name), gc_grace_s=0.0
        )
        await _compact_bottom(tree, indices)
        assert await tree.get_entry(b"k") is None
        other = await tree.get_entry(b"other")
        assert bytes(other[0]) == b"x"
        tree.close()

    run(main(), timeout=60)
    _check_branch(branch, wrote)


@pytest.mark.parametrize("name,branch", CASES, ids=IDS)
def test_old_tombstones_still_gc_past_grace(tmp_dir, branch_of, name, branch):
    """A grace of 1 ms is past by the time the merge runs: the grace
    must not become keep-forever."""
    wrote = branch_of(name, branch)

    async def main():
        tree, indices, _del = await _seed_tombstone(
            f"{tmp_dir}/t", _strategy(name), gc_grace_s=0.001
        )
        await asyncio.sleep(0.01)
        await _compact_bottom(tree, indices)
        assert await tree.get_entry(b"k") is None
        tree.close()

    run(main(), timeout=60)
    _check_branch(branch, wrote)
