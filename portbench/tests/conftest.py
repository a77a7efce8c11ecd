"""The harness's own tests: ``python -m pytest portbench/tests`` from
the root of a checkout.  They run on the CPU; a test that needs a card
carries the ``cuda`` marker and skips without one."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def run_cell(workload, seed, seconds=1.0, trace=0, env=None, root=ROOT,
             timeout=240):
    """One rehearsal run of ``portbench/run.py`` under ``root``: its
    exit code, last stdout line (parsed, or None) and stderr."""
    import json

    full = dict(os.environ, **(env or {}))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "portbench", "run.py"),
         "--workload", workload, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace), "--rehearse"],
        cwd=root, env=full, capture_output=True, text=True,
        timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except ValueError:
            pass
    return proc.returncode, line, proc.stderr


@pytest.fixture
def cell_runner():
    return run_cell
