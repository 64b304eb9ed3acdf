"""Build the CUDA sources under ``spef_tpu_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/lib<name>-<hash>.so`` at the repo root, built by
``nvcc`` for ``sm_90a`` on first use.  The hash is of the source and the
flags, so an edited source never loads a stale library.  ``build_all``
starts one ``nvcc`` per source, all at once.

Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["SOURCES", "build_all", "load_library", "nvcc_path", "check", "traced",
           "refuse_tracing", "count_launch", "KernelTraceError"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("int8_matmul_requant", "int8_depthwise3x3", "fused_stem", "fused_mbconv",
           "bf16_conv1x1_bn", "bf16_depthwise3x3_bn")
# --split-compile 0: the kernels of one source are optimised on as many
# threads as the host has cores (K4's four instantiations are most of the
# build).
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
         "--split-compile", "0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each source built by this process.
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed (PATH or CUDA_HOME)")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str) -> Tuple[str, str, subprocess.Popen]:
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file; returns
    (temporary path, final path, process)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return tmp, _target(name), proc


def _finish(name: str, tmp: str, target: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees old or new, never half
    build_logs[name] = out


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Build every missing library, one nvcc per source, all in parallel.

    Returns the names that were compiled (already built ones are skipped).
    """
    with _lock:
        todo = [n for n in names if not os.path.isfile(_target(n))]
        started = [(n, *_start(n)) for n in todo]
        errors = []
        for n, tmp, target, proc in started:
            try:
                _finish(n, tmp, target, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return todo


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(_target(name))
                lib.spef_error_string.argtypes = [ctypes.c_int]
                lib.spef_error_string.restype = ctypes.c_char_p
                _loaded[name] = lib
    return lib


class KernelTraceError(RuntimeError):
    """A hand kernel was reached while ``torch.export`` (or ``torch.compile``)
    traced a function."""


def traced(x) -> bool:
    """Whether a tracer (``torch.export``, ``torch.compile``) is recording
    the call that holds ``x``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor

    return torch.compiler.is_compiling() or isinstance(x, FakeTensor)


def refuse_tracing(what: str, x) -> None:
    """Raise before a launch that a tracer is recording: a traced tensor has
    no memory (its ``data_ptr`` is not an address), so the launch would
    read and write nothing real and the trace would record no kernel."""
    if traced(x):
        raise KernelTraceError(
            f"{what}: a hand-written CUDA kernel cannot be traced by torch.export (a ctypes "
            f"launch on a tensor with no memory); export a forward without hand kernels "
            f"(float, qat, int8 = build_int8_forward, weight_only), or register K1-K4 as "
            f"torch.library custom ops with fake implementations (ROADMAP §A, item 10)")


def count_launch(wrapper, device) -> None:
    """One launch of ``wrapper``'s kernel on the card ``device``: one more
    in its ``launches`` and in its ``launches_by_card[device.index]``."""
    wrapper.launches += 1
    wrapper.launches_by_card[device.index] = wrapper.launches_by_card.get(device.index, 0) + 1


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError after it)."""
    if code != 0:
        msg = lib.spef_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
