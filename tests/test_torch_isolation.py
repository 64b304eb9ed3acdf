"""The port stands alone: importing every ``spef_tpu_torch`` module pulls in
neither JAX, flax nor any module of the JAX package, and none of the host
libraries the card's machine does not promise (PIL, OpenCV, pandas, PyYAML,
msgpack): the port decodes PNGs, draws frames, reads configs and writes
checkpoints and scores itself."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import spef_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(spef_tpu_torch.__path__, "spef_tpu_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "spef_tpu"))
print(len(names))
assert not bad, bad
assert "triton" not in sys.modules
host = sorted(m for m in sys.modules
              if m.split(".")[0] in ("PIL", "cv2", "pandas", "yaml", "msgpack"))
assert not host, host
"""


def test_port_imports_no_jax_and_no_jax_package():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 20  # every module was imported


def test_package_sources_name_no_jax_import():
    """No source line of the port imports JAX, flax, the JAX package, PIL,
    OpenCV or pandas, even behind a branch the probe above does not take."""
    offenders = []
    for root, _, files in os.walk(os.path.join(REPO, "spef_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        mod = s.split()[1].split(".")[0]
                        if mod in ("jax", "jaxlib", "flax", "spef_tpu", "PIL", "cv2",
                                   "pandas"):
                            offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders
