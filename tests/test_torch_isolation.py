"""dbeel_tpu_torch stands alone: it imports neither JAX nor anything of
dbeel_tpu (nor msgpack, which the GPU machine need not have), and its
device entry points refuse to run without a card unless told "cpu"."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax_nor_reference():
    code = r"""
import importlib, os, pkgutil, sys
import dbeel_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    dbeel_tpu_torch.__path__, "dbeel_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("dbeel_tpu_torch.server.coalescer",
             "dbeel_tpu_torch.server.tasks", "dbeel_tpu_torch.ops.sort",
             "dbeel_tpu_torch.query", "dbeel_tpu_torch.storage.scan_stage",
             "dbeel_tpu_torch.storage.query_vec",
             "dbeel_tpu_torch.storage.range_digest",
             "dbeel_tpu_torch.ops.query_kernels",
             "dbeel_tpu_torch.utils.msgpack_codec",
             "dbeel_tpu_torch.parallel.mesh",
             "dbeel_tpu_torch.parallel.dist_merge",
             "dbeel_tpu_torch.ops.merge",
             "dbeel_tpu_torch.storage.native",
             "dbeel_tpu_torch.storage.wal",
             "dbeel_tpu_torch.storage.secondary_index",
             "dbeel_tpu_torch.storage.uring",
             "dbeel_tpu_torch.client",
             "dbeel_tpu_torch.client.native_client"):
    assert name in names, name
import chip_smoke  # noqa: F401  (its top-level imports)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "dbeel_tpu" or m.startswith("dbeel_tpu.")
             or m == "msgpack" or m.startswith("msgpack."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=100,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_device_strategies_need_a_card_or_cpu(monkeypatch):
    from dbeel_tpu_torch.storage.compaction import get_strategy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("device", "device_full", "auto", "coalesced", "distributed"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_strategy(name)
        assert get_strategy(name, device="cpu").device.type == "cpu"
    # The C++ merge runs on the host: it needs the native library only.
    from dbeel_tpu_torch.storage import native

    assert isinstance(get_strategy("native"), native.NativeMergeStrategy)
    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="make -C native"):
        get_strategy("native")
    with pytest.raises(ValueError):
        get_strategy("nonsense")


def test_lsm_tree_compacts_on_the_card_by_default(tmp_path, monkeypatch):
    """An LSMTree opened without a strategy takes get_strategy("auto"):
    with no card it refuses to open rather than merging on the host;
    asked for the CPU, it gets the plain versions of the same strategy."""
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.storage.compaction import get_strategy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSMTree.open_or_create(str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSMTree.open_or_create(
            str(tmp_path / "t"), memtable_kind="hash",
            strategy=get_strategy("heap"),
        )
    hashed = LSMTree.open_or_create(
        str(tmp_path / "h"), memtable_kind="hash", device="cpu"
    )
    assert hashed._active.device.type == "cpu"
    assert hashed.strategy.device.type == "cpu"
    hashed.close()
    tree = LSMTree.open_or_create(
        str(tmp_path / "t"), strategy=get_strategy("auto", device="cpu")
    )
    assert tree.strategy.name == "device"
    assert tree.strategy.device.type == "cpu"
    tree.close()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card (this CPU machine), and a directory holding chip_smoke.py
    alone: both exit non-zero and print no result line."""
    import shutil

    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(lone), str(tmp_path))):
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True,
            text=True, timeout=100,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
