"""The isolation check: a planted import of JAX fails the run, and the
port's own package, whose name begins with the JAX package's, does
not."""

import os

from portbench import isolation


def test_top_level_names_compared_whole():
    assert isolation.forbidden_modules(
        ["dbeel_tpu_torch", "dbeel_tpu_torch.server.run", "dbeel_tpux",
         "jaxtyping", "msgpack_codec", "numpy"]) == []
    assert isolation.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "dbeel_tpu",
         "dbeel_tpu.ops", "msgpack", "flax.linen"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "dbeel_tpu",
         "dbeel_tpu.ops", "msgpack", "flax.linen"])


def test_planted_import_fails_the_run(tmp_path, cell_runner):
    from .conftest import ROOT

    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\n"
        "try:\n    import jax  # noqa: F401\n"
        "except ImportError:\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n")
    env = {"PYTHONPATH": os.pathsep.join([str(tmp_path), ROOT])}
    rc, line, err = cell_runner("shard1-kv16x64.major", 5, env=env)
    assert rc != 0
    assert line is None
    assert "forbidden modules" in err and "jax" in err


def test_clean_run_holds_none(cell_runner):
    rc, line, err = cell_runner("shard1-kv16x64.major", 6)
    assert rc == 0 and line is not None, err[-2000:]
