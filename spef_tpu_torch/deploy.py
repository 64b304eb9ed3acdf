"""Deployment artifacts: the whole predict pipeline as one exported program.

Counterpart of ``spef_tpu.deploy``.  JAX serializes StableHLO
(``jax.export``); the port traces the same pipeline (uint8 preprocess ->
network or int8 executor -> last activation -> on-card decode) with
``torch.export.export`` into an ``ExportedProgram`` whose weights are
embedded, and :func:`load_exported` runs it without the port's model code,
weight files or re-tracing: this module imports only ``torch``, ``numpy``,
``json`` and ``zipfile`` (with ``io``, ``contextlib`` and ``time`` of the
standard library).

Artifact layout (a single ``.spef`` zip):

    program.pt2   torch.export.save of the program (weights embedded)
    meta.json     format, batch, img_size, dtype, platforms, outputs, tf32,
                  torch version, created (+ the caller's extra keys)

Shapes are static, ``(batch, H, W, 3)``: :class:`ExportedEngine` pads a
smaller request to the window and trims the outputs back, the contract of
``PoseServer``.  Devices are baked into the trace (a constant made with
``device=images.device`` is fixed when traced): an artifact serves on the
device it was exported for, and ``load_exported(path, device=...)`` moves
it to another through ``torch.export.passes.move_to_device_pass``.

``torch.export`` records no global flag, so the TF32 switches that the live
decode and the QAT / int8 executors turn off (``codec/softclass.py``,
``quant/int8_model.py::f32_convs``) are turned off by the engine around
each call (``"tf32": false`` in ``meta.json``) and restored after.

A forward that launches a hand-written kernel (``fused``, ``carry``,
``layer`` on ``cuda``) cannot be traced: the kernels are ctypes launches,
and a traced tensor has no memory.  The wrappers refuse such a trace
(``ops/_build.py::refuse_tracing``); registering K1-K4 as
``torch.library`` custom ops with fake implementations is ROADMAP §A,
item 10.  A JAX artifact (``spef-export-v1``, ``program.stablehlo``) is
refused by name.
"""

from __future__ import annotations

import contextlib
import io
import json
import time
import zipfile
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["FORMAT", "export_predict", "load_exported", "ExportedEngine"]

FORMAT = "spef-torch-export-v1"
_PROGRAM = "program.pt2"
_META = "meta.json"
_JAX_FORMAT, _JAX_PROGRAM = "spef-export-v1", "program.stablehlo"


class _Predict(torch.nn.Module):
    """``torch.export`` traces modules: the predict function as one."""

    def __init__(self, predict_fn: Callable):
        super().__init__()
        self.predict_fn = predict_fn

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.predict_fn(images)


@contextlib.contextmanager
def _tf32_off():
    """Full float32 in cuDNN's convolutions and in matmuls, as the live
    engine runs them; the caller's switches restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def export_predict(
    predict_fn: Callable,
    batch: int,
    img_size: Tuple[int, int],
    out_path: str,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.uint8,
    extra_meta: Optional[Dict] = None,
) -> Dict:
    """Export ``predict_fn(images) -> pose dict`` to a ``.spef`` artifact.

    ``predict_fn`` is ``engine.build_predict_fn``'s output (float, QAT, or
    an int8 executor that launches no hand kernel: ``build_int8_forward``,
    ``build_weight_only_forward``), traced on a ``(batch, *img_size, 3)``
    ``dtype`` example on ``device``.  Returns the written ``meta.json``.
    """
    device = torch.device(device)
    example = torch.zeros((batch, *img_size, 3), dtype=dtype, device=device)
    with _tf32_off():
        program = torch.export.export(_Predict(predict_fn), (example,))
        probe = program.module()(example)
    blob = io.BytesIO()
    torch.export.save(program, blob)
    meta = {
        "format": FORMAT,
        "batch": int(batch),
        "img_size": [int(img_size[0]), int(img_size[1])],
        "dtype": str(dtype).replace("torch.", ""),
        "platforms": [device.type],
        "outputs": {k: [int(d) for d in v.shape] for k, v in probe.items()},
        "tf32": False,
        "torch_version": torch.__version__,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if extra_meta:
        meta.update(extra_meta)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_PROGRAM, blob.getvalue())
        zf.writestr(_META, json.dumps(meta, indent=2))
    return meta


class ExportedEngine:
    """``SPETorch.predict``'s contract over a loaded ``.spef`` artifact.

    ``predict(images) -> (pose dict of device tensors, latency ms)`` for any
    request of ``n <= batch`` frames: zero-padded to the exported window and
    trimmed back, as ``spef_tpu.deploy.ExportedEngine``.  The engine is also
    a ``predict_fn`` (``engine(images on the device) -> pose dict``), so a
    ``PoseServer`` can serve it.
    """

    def __init__(self, program, meta: Dict, device: torch.device):
        self.meta = meta
        self.device = device
        self._module = program.module()

    @property
    def batch(self) -> int:
        return self.meta["batch"]

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), _tf32_off():
            return self._module(images)

    def predict(self, images) -> Tuple[Dict[str, torch.Tensor], float]:
        x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        n, b = x.shape[0], self.batch
        if n > b:
            raise ValueError(f"request batch {n} > exported window {b}")
        if n < b:
            x = torch.cat([x, x.new_zeros((b - n, *x.shape[1:]))])
        start = time.perf_counter()
        pose = self(x.to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        latency_ms = (time.perf_counter() - start) * 1000.0
        if n < b:
            pose = {k: v[:n] for k, v in pose.items()}
        return pose, latency_ms


def load_exported(path: str, device: Union[str, torch.device, None] = None) -> ExportedEngine:
    """Load a ``.spef`` artifact into a runnable engine, on the device it
    was exported for, or moved to ``device``."""
    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            meta = json.loads(zf.read(_META)) if _META in names else {}
            if meta.get("format") == _JAX_FORMAT or _JAX_PROGRAM in names:
                raise ValueError(
                    f"{path} is a JAX artifact ({_JAX_FORMAT}, {_JAX_PROGRAM}): load it with "
                    f"spef_tpu.deploy.load_exported; this loader reads {FORMAT}")
            if meta.get("format") != FORMAT or _PROGRAM not in names:
                raise ValueError(f"{path} is not a {FORMAT} artifact (format "
                                 f"{meta.get('format')!r}, members {sorted(names)})")
            blob = zf.read(_PROGRAM)
    except zipfile.BadZipFile as e:
        raise ValueError(f"{path} is not a .spef artifact: {e}") from e
    program = torch.export.load(io.BytesIO(blob))
    exported_on = torch.device(meta["platforms"][0])
    target = exported_on if device is None else torch.device(device)
    if target.type != exported_on.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, target)
    return ExportedEngine(program, meta, target)
