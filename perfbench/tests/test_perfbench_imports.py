"""What a run loads: never JAX or the JAX package; the references nothing
of the port.  Each check runs in a fresh process."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell, sizes", [
    ("flagship_int8.stream_b256", {"window": 2, "pool_windows": 2, "ref_block": 2,
                                   "img_size": [48, 64]}),
    ("flagship_float.train_b64", {"batch": 2, "split_frames": 8, "img_size": [48, 64]}),
])
def test_a_run_loads_no_jax(cell, sizes):
    """After a cell's CPU run, set-up, window and check included, the
    top-level module names hold none of jax, jaxlib, flax or spef_tpu
    (compared whole: spef_tpu_torch is the port)."""
    names = json.loads(_python(
        "import json, sys\n"
        "from perfbench.harness import run_cell, loaded_forbidden\n"
        f"run_cell({ROOT!r}, {cell!r}, 2**32 + 9, 1.0, False, 'cpu', backend='plain',\n"
        f"         sizes={sizes!r})\n"
        "print(json.dumps([loaded_forbidden(), sorted({m.split('.')[0] for m in sys.modules})]))"))
    forbidden, top = names
    assert forbidden == []
    assert "spef_tpu_torch" in top and not {"jax", "jaxlib", "flax", "spef_tpu"} & set(top)


def test_the_guard_compares_whole_names(monkeypatch):
    import types

    from perfbench.harness import loaded_forbidden

    before = set(loaded_forbidden())
    for name in ("spef_tpu_torch_probe", "spef_tpu_torch_probe.sub", "jaxtyping_probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(loaded_forbidden()) == before
    monkeypatch.setitem(sys.modules, "flax.probe", types.ModuleType("flax.probe"))
    assert "flax" in loaded_forbidden()


def test_references_import_nothing_of_the_port():
    top = json.loads(_python(
        "import json, sys\n"
        "import perfbench.reference.model, perfbench.reference.int8_graph\n"
        "import perfbench.reference.softclass, perfbench.reference.train\n"
        "import perfbench.reference.weights, perfbench.roofline, perfbench.frames\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"))
    assert not {"spef_tpu_torch", "spef_tpu", "jax", "flax"} & set(top)
