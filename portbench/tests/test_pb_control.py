"""Each cell's control (the reference in the program's place with a
guarantee broken) comes out as not correct, and each fault planted
under a run's timed path turns its ``correct`` false."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from .conftest import ROOT


def control(workload, seeds="1,2,3"):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "control.py"),
         "--workload", workload, "--seeds", seeds, "--rehearse"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return [json.loads(line)["control"]
            for line in proc.stdout.strip().splitlines()]


def test_control_is_not_correct():
    for readings in control("shard1-kv16x64.major"):
        # Every limit is 0: the control fails at least one number.
        assert any(v > 0 for v in readings.values()), readings


# Faults, planted through a sitecustomize in the run's process.
FAULTS = {
    # Major: the merge hands back its state unchanged (the first run as
    # the output), leaves out half of its batch, or alters a byte of
    # what it wrote.
    "major_state_unchanged": """
        from dbeel_tpu_torch.ops.device_compaction import DeviceMergeStrategy
        real = DeviceMergeStrategy.merge
        def merge(self, sources, *a, **k):
            return real(self, sources[:1], *a, **k)
        DeviceMergeStrategy.merge = merge
    """,
    "major_half_batch": """
        from dbeel_tpu_torch.ops.device_compaction import DeviceMergeStrategy
        real = DeviceMergeStrategy.merge
        def merge(self, sources, *a, **k):
            return real(self, sources[:len(sources) // 2], *a, **k)
        DeviceMergeStrategy.merge = merge
    """,
    "major_altered": """
        import os
        from dbeel_tpu_torch.ops.device_compaction import DeviceMergeStrategy
        from dbeel_tpu_torch.storage.entry import file_name
        real = DeviceMergeStrategy.merge
        def merge(self, sources, dir_path, out, *a, **k):
            r = real(self, sources, dir_path, out, *a, **k)
            p = os.path.join(dir_path, file_name(out, "compact_data"))
            with open(p, "r+b") as f:
                f.seek(os.path.getsize(p) // 2)
                b = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([b[0] ^ 1]))
            return r
        DeviceMergeStrategy.merge = merge
    """,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_turns_correct_false(fault, tmp_path, cell_runner):
    (tmp_path / "sitecustomize.py").write_text(
        textwrap.dedent(FAULTS[fault]))
    env = {"PYTHONPATH": os.pathsep.join([str(tmp_path), ROOT])}
    rc, line, err = cell_runner("shard1-kv16x64.major", 77, env=env)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
