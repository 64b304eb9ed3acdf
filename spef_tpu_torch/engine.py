"""SPETorch — the inference engine of the port.

Counterpart of ``spef_tpu.engine`` (``build_predict_fn`` and ``SPEJax``):

    uint8 image -> /255 -> CNN -> last activation -> decode -> pose

PyTorch runs eagerly, so the predict function is a plain function under
``torch.inference_mode``.  The int8 path passes its own ``forward_fn``
(``spef_tpu_torch.quant.int8_cuda.build_cuda_forward``, or
``quant.int8_fused.build_fused_forward`` / ``quant.int8_carry.
build_int8_carry_forward``, which take the raw uint8 frames).

``SPECropRefine`` is the two-pass keypoints engine (coarse keypoints, a
crop box, the crop resampled on the card, the fine pass, the keypoints
mapped back, the PnP decode: ``codec/crop.py``), with the same ``predict``
contract.

With ``mesh=`` (``parallel.mesh.make_local_mesh``) an engine runs over
every device of a local mesh, as ``SPEJax(mesh=)`` shards its batch;
without one, over the one-device mesh of ``device``.
:class:`ShardedPredict` holds one replica a device (its own model and
packed int8 weights) and splits each batch's rows over them.  A decode
syncs the host (``eigh``; the keypoint decode 8-16 times), so the predict
functions come in two stages (:class:`StagedPredict`): every device's
forward is queued, the pre-decode parts are gathered in row order to the
mesh's first device, and the decode runs there once, on the whole batch,
as on one device.

``discover_engine_variants`` / ``build_engine_variant`` serve an
experiment's artifacts: the float (or QAT) model, the ``weight-only``
and ``int8-carry`` executors of its ``int8_graph.pkl``, its exported
``model.spef`` (``deploy.load_exported``), and the two-pass
``crop-refine`` / ``crop-refine-w8`` variants its ``crop_refine.json``
points at.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.parallel.mesh import (LocalMesh, data_sharding, mesh_or_device, on_device,
                                          replicated)
from spef_tpu_torch.utils import profiling

__all__ = ["SPETorch", "SPECropRefine", "ShardedPredict", "StagedPredict", "per_device",
           "build_predict_fn", "build_crop_refine_fn", "discover_engine_variants",
           "build_engine_variant"]

Pose = Dict[str, torch.Tensor]


def _raw_to_pose(spe_utils: SPEUtils, pred) -> Dict[str, torch.Tensor]:
    """Map the raw outputs to the pose dict keys used everywhere: the two
    outputs of the URSONet head, or the keypoint logits."""
    if spe_utils.keypoints_mode:
        return {"keypoints": pred[0] if isinstance(pred, tuple) else pred}
    ori_key = "ori" if spe_utils.ori_mode == "regression" else "ori_soft"
    pos_key = "pos" if spe_utils.pos_mode == "regression" else "pos_soft"
    return {ori_key: pred[0], pos_key: pred[1]}


class StagedPredict:
    """A predict function in two stages, so that a mesh can queue every
    device's work before it waits on any: ``launch(images)`` queues what
    comes before the predict's first host synchronization (the
    normalization and the forward; the crop-refine pipeline up to its
    keypoints), ``finish(pose)`` runs the rest (the last activation and the
    decode: ``eigh`` or the PnP solve, which sync the host) on a batch of
    launched parts.  Calling it runs both."""

    def __init__(self, launch: Callable[[torch.Tensor], Pose], finish: Callable[[Pose], Pose]):
        self.launch = launch
        self.finish = finish

    def __call__(self, images: torch.Tensor) -> Pose:
        return self.finish(self.launch(images))


def build_predict_fn(
    model: Optional[torch.nn.Module],
    spe_utils: SPEUtils,
    decode: bool = True,
    forward_fn: Optional[Callable] = None,
) -> StagedPredict:
    """Build the (preprocess -> forward -> activ -> decode) function.

    ``forward_fn(images) -> raw outputs`` defaults to ``model``.  Images are
    NHWC on the model's device, uint8 [0, 255] or float [0, 1].  A
    ``forward_fn`` whose ``takes_uint8`` attribute is true folds the
    normalization itself and gets uint8 frames as they are.  The last
    activation and the decode are the second stage.  While a profiler
    runs, the stages are spans ``spef.predict.launch`` and
    ``spef.predict.finish``.
    """
    fwd = forward_fn or model
    normalize = not getattr(fwd, "takes_uint8", False)

    @torch.inference_mode()
    def launch(images: torch.Tensor) -> Pose:
        with profiling.span("predict.launch"):
            if normalize and images.dtype == torch.uint8:
                # An IEEE division, as JAX's: a CUDA tensor divided by a
                # Python scalar becomes a multiply by the reciprocal.
                images = images.float() / torch.tensor(255.0, device=images.device)
            return _raw_to_pose(spe_utils, fwd(images))

    @torch.inference_mode()
    def finish(pose: Pose) -> Pose:
        with profiling.span("predict.finish"):
            pose = spe_utils.last_activ(pose)
            return spe_utils.decode(pose) if decode else pose

    return StagedPredict(launch, finish)


def _keypoint_logits(model: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    def fwd(images: torch.Tensor) -> torch.Tensor:
        out = model(images)
        return out[0] if isinstance(out, tuple) else out
    return fwd


def build_crop_refine_fn(
    coarse: torch.nn.Module,
    fine: torch.nn.Module,
    spe_utils: SPEUtils,
    crop_hw: Optional[Tuple[int, int]] = None,
    margin: float = 1.5,
    gate: Optional[float] = 0.02,
    decode: bool = True,
) -> StagedPredict:
    """The two-pass predict function: uint8 [0, 255] or float [0, 1] NHWC
    images -> the pipeline's keypoints (``keypoints``, ``keypoints_coarse``,
    ``crop_box`` and, with ``gate``, ``keypoints_fine`` / ``gate_keep``)
    and, with ``decode``, ``ori`` / ``pos`` by ``spe_utils``'s keypoint
    decode (the second stage).  ``crop_hw`` is the fine model's input size
    (the images' size when None); ``margin`` and ``gate`` as in
    ``codec.crop``."""
    from spef_tpu_torch.codec.crop import CropRefinePipeline

    if not spe_utils.keypoints_mode:
        raise ValueError("crop-refine is a keypoints-mode pipeline")
    pipe = CropRefinePipeline(_keypoint_logits(coarse), _keypoint_logits(fine),
                              margin=margin, gate=gate)

    @torch.inference_mode()
    def launch(images: torch.Tensor) -> Pose:
        with profiling.span("predict.launch"):
            if images.dtype == torch.uint8:
                images = images.float() / torch.full((), 255.0, device=images.device)
            pipe.crop_hw = tuple(crop_hw) if crop_hw is not None else tuple(images.shape[1:3])
            return pipe(images)

    @torch.inference_mode()
    def finish(pose: Pose) -> Pose:
        with profiling.span("predict.finish"):
            if decode:
                pose.update(spe_utils.keypoints.decode_batch(
                    pose["keypoints"], ransac=spe_utils.keypoints_ransac,
                    border_gate=spe_utils.keypoints_border_gate))
            return pose

    return StagedPredict(launch, finish)


def _run_on(device: torch.device, stage: Callable, x):
    with on_device(device):
        return stage(x)


def _stages(predict: Callable[[torch.Tensor], Pose]):
    """(launch, finish) of a predict function: a function that is not a
    :class:`StagedPredict` runs whole at launch."""
    if isinstance(predict, StagedPredict):
        return predict.launch, predict.finish
    return predict, lambda pose: pose


def per_device(fn: Optional[Callable], mesh: Optional[LocalMesh]) -> Optional[Callable]:
    """``fn`` as ``build(device)``: over a mesh it is one already (a
    function closes over one device's weights, so a mesh takes a builder);
    without a mesh it is the function of the one device, given as is."""
    if fn is None or mesh is not None:
        return fn
    return lambda device: fn


class ShardedPredict:
    """A predict function over a local mesh, one replica a device: each
    batch's rows are split over the devices
    (:func:`parallel.mesh.data_sharding`: the rows must divide), every
    device's launch stage is queued on its rows, the parts are gathered in
    row order to the mesh's first device, and the first replica's finish
    stage (the decode and its host syncs) runs there once, on the whole
    batch: what one device gives on the same launched parts.  Callable like
    a predict function on a batch anywhere (the host, or a device); the pose
    lies on the mesh's first device.  A failure on any device raises;
    nothing runs on fewer devices."""

    def __init__(self, mesh: LocalMesh, replicas: Sequence[Callable[[torch.Tensor], Pose]]):
        if len(replicas) != mesh.size:
            raise ValueError(f"{len(replicas)} replicas for a {mesh.size}-device mesh")
        self.mesh = mesh
        self.replicas = list(replicas)

    @classmethod
    def build(cls, mesh: LocalMesh,
              build: Callable[[torch.device], Callable[[torch.Tensor], Pose]]) -> "ShardedPredict":
        """``build(device)`` once a device (:func:`parallel.mesh.replicated`)."""
        return cls(mesh, replicated(mesh, build))

    def scatter(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Each device's rows of ``images`` on it, copied with
        ``non_blocking`` (asynchronous from pinned host memory)."""
        return [images[rows].to(device, non_blocking=True) for rows, device in
                zip(data_sharding(self.mesh, images.shape[0]), self.mesh.devices)]

    def launch(self, shards: Sequence[torch.Tensor]) -> Pose:
        """Every replica's launch stage on its device's shard, in the
        caller's thread (each queues its forward and returns), and the parts
        gathered in row order on the first device; nothing is waited on."""
        parts = [_run_on(device, _stages(predict)[0], x)
                 for device, predict, x in zip(self.mesh.devices, self.replicas, shards)]
        return self.gather(parts, self.mesh.devices[0])

    def finish(self, pose: Pose) -> Pose:
        """The first replica's finish stage on the gathered batch."""
        return _run_on(self.mesh.devices[0], _stages(self.replicas[0])[1], pose)

    def run(self, shards: Sequence[torch.Tensor]) -> Pose:
        """The pose of the batch whose rows ``shards`` are (its work may
        still be queued on the devices)."""
        return self.finish(self.launch(shards))

    def staged(self) -> StagedPredict:
        """This predict function in two stages on a whole batch, as
        ``serving.serve_stream`` serves a stream over the mesh: ``launch``
        scatters the rows and queues every device's forward, ``finish``
        decodes the gathered batch on the first device."""
        return StagedPredict(lambda images: self.launch(self.scatter(images)), self.finish)

    @staticmethod
    def gather(parts: Sequence[Pose], device: torch.device) -> Pose:
        """The parts as one pose of the whole batch on ``device``."""
        if len(parts) == 1:
            return dict(parts[0])
        return {k: torch.cat([p[k].to(device) for p in parts]) for k in parts[0]}

    def synchronize(self) -> None:
        """Wait for every device of the mesh."""
        for device in dict.fromkeys(self.mesh.devices):
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def __call__(self, images: torch.Tensor) -> Pose:
        return self.run(self.scatter(images))


def _replica(model: Optional[torch.nn.Module], device: torch.device):
    """``model`` on ``device``: itself where it lies there already (or holds
    no tensor), else a copy moved there, so replicas on two devices share
    no tensor."""
    if model is None:
        return None
    tensor = next(iter(model.state_dict().values()), None)
    if tensor is None or tensor.device == device:
        return model
    return copy.deepcopy(model).to(device)


class _Engine:
    """The reference's ``predict`` contract over ``self._predict``, a
    :class:`ShardedPredict`."""

    _predict: ShardedPredict
    device: torch.device

    def predict(self, images) -> Tuple[Pose, float]:
        """Run inference; returns (pose dict of device tensors, wall ms).

        As in ``SPEJax.predict``, the input is on the device (over a mesh:
        each device's rows on it) before the clock starts; the clock is read
        after every device is synchronized.  The pose lies on ``device``
        (the mesh's first device).
        """
        x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        shards = self._predict.scatter(x)
        self._predict.synchronize()
        start = time.perf_counter()
        pose = self._predict.run(shards)
        self._predict.synchronize()
        latency_ms = (time.perf_counter() - start) * 1000.0
        return pose, latency_ms


class SPETorch(_Engine):
    """Stateful engine wrapper with the reference's ``predict`` contract.

    ``mesh``: a local mesh (``parallel.mesh.make_local_mesh``) whose
    devices each run a replica's forward on their rows of every batch, as
    ``SPEJax(mesh=)`` shards it; ``device`` then is the mesh's first, where
    the decode runs (``spe_utils``'s tables lie there).  A replica holds
    ``model`` on its device and its own forward: over a mesh ``forward_fn``
    is ``build(device) -> forward`` (an executor's builder with its
    ``device=``), since a forward closes over weights on one device.
    """

    def __init__(
        self,
        model: Optional[torch.nn.Module],
        spe_utils: SPEUtils,
        decode: bool = True,
        forward_fn: Optional[Callable] = None,
        device: str = "cuda",
        mesh: Optional[LocalMesh] = None,
    ):
        self.model = model
        self.spe_utils = spe_utils
        self.mesh = mesh
        self._mesh = mesh_or_device(mesh, device)
        self.device = self._mesh.devices[0]
        self._decode = decode
        self._build_forward = per_device(forward_fn, mesh)
        self._predict = self._replicate()

    def _replicate(self) -> ShardedPredict:
        build = self._build_forward
        return ShardedPredict.build(self._mesh, lambda device: build_predict_fn(
            _replica(self.model, device), self.spe_utils, self._decode,
            None if build is None else build(device)))

    def update_model(self, model: Optional[torch.nn.Module],
                     forward_fn: Optional[Callable] = None) -> None:
        """Swap the model (``SPEJax.update_model``): ``decode``, the mesh and,
        unless a new ``forward_fn`` is given (as the constructor takes it),
        the forward path are kept, so an engine on an int8 forward stays on
        it (a forward closes over its own weights: pass the rebuilt one for
        the swap to reach it).  The replica on every device is rebuilt."""
        self.model = model
        if forward_fn is not None:
            self._build_forward = per_device(forward_fn, self.mesh)
        self._predict = self._replicate()


class SPECropRefine(_Engine):
    """The two-pass crop-refine keypoints engine (:func:`build_crop_refine_fn`),
    with ``SPETorch``'s ``predict`` contract: ``coarse`` is the full-frame
    keypoints model, ``fine`` the crop-trained one; over a ``mesh`` each
    device holds both and runs the pipeline up to the keypoints on its rows,
    and the keypoint decode runs on the mesh's first device."""

    def __init__(
        self,
        coarse: torch.nn.Module,
        fine: torch.nn.Module,
        spe_utils: SPEUtils,
        crop_hw: Optional[Tuple[int, int]] = None,
        margin: float = 1.5,
        gate: Optional[float] = 0.02,
        decode: bool = True,
        device: str = "cuda",
        mesh: Optional[LocalMesh] = None,
    ):
        self.model = coarse
        self.fine = fine
        self.spe_utils = spe_utils
        self.mesh = mesh
        mesh = mesh_or_device(mesh, device)
        self.device = mesh.devices[0]
        self._predict = ShardedPredict.build(mesh, lambda device: build_crop_refine_fn(
            _replica(coarse, device), _replica(fine, device), spe_utils, crop_hw, margin, gate,
            decode))


# ---------------------------------------------------------------------------
# Engine variants from experiment artifacts
# ---------------------------------------------------------------------------


def discover_engine_variants(exp_dir: str):
    """Engine variants an experiment directory offers, as the JAX engine
    lists them: the float model; ``weight-only`` and ``int8-carry`` where it
    holds an ``int8_graph.pkl``; ``exported`` where it holds a ``model.spef``;
    the two crop-refine variants where its ``crop_refine.json`` points at a
    fine model."""
    import json
    import os

    variants = ["float"]
    if os.path.isfile(os.path.join(exp_dir, "int8_graph.pkl")):
        variants += ["weight-only", "int8-carry"]
    if os.path.isfile(os.path.join(exp_dir, "model.spef")):
        variants.append("exported")
    ptr = os.path.join(exp_dir, "crop_refine.json")
    if os.path.isfile(ptr):
        try:
            with open(ptr) as f:
                fine = json.load(f).get("fine_exp", "")
            if os.path.isfile(os.path.join(fine, "model", "parameters.msgpack")):
                variants += ["crop-refine", "crop-refine-w8"]
        except (OSError, ValueError):
            pass
    return variants


def load_experiment_model(exp_dir: str, device: str = "cuda", **kw) -> torch.nn.Module:
    """The float model of an experiment directory (its ``config.yaml`` and
    ``model/parameters.msgpack``), as the crop-refine pair loads its fine
    pass; ``kw`` goes to ``import_model``."""
    import os

    from spef_tpu_torch.config.train_config import load_config
    from spef_tpu_torch.models.wrapper import import_model

    cfg = load_config(os.path.join(exp_dir, "config.yaml"))
    return import_model(
        backbone_name=cfg.MODEL.BACKBONE.NAME, head_name=cfg.MODEL.HEAD.NAME,
        img_size=tuple(cfg.DATA.IMG_SIZE),
        params_path=os.path.join(exp_dir, "model", "parameters.msgpack"),
        residual=cfg.MODEL.BACKBONE.RESIDUAL, quantization=cfg.MODEL.QUANTIZATION,
        ori_mode=cfg.MODEL.HEAD.ORI, pos_mode=cfg.MODEL.HEAD.POS, device=device, **kw)


def build_engine_variant(exp_dir: str, model: Optional[torch.nn.Module], spe_utils: SPEUtils,
                         variant: str = "float", device: str = "cuda",
                         mesh: Optional[LocalMesh] = None):
    """A ``predict``-contract engine for one variant of an experiment.

    ``float`` runs ``model`` (the float or the QAT model); ``weight-only``
    and ``int8-carry`` run the experiment's ``int8_graph.pkl``
    (``quant.int8_model.build_weight_only_forward``,
    ``quant.int8_carry.build_int8_carry_forward`` on K1/K2);
    ``crop-refine`` runs ``model`` as the coarse pass of
    :class:`SPECropRefine` and the experiment its ``crop_refine.json``
    names (``fine_exp``) as the fine pass, at the fine config's image size,
    with the registry's ``gate`` (0.02 where it has none);
    ``crop-refine-w8`` the same on copies of both models whose kernels are
    snapped to per-channel int8 grids (``quant.weight_only``); ``exported``
    loads the experiment's ``model.spef`` (``apps.export``) onto ``device``
    as a ``deploy.ExportedEngine`` and ignores ``model``.

    ``mesh``: every variant but ``exported`` runs over the local mesh, one
    replica a device (``SPEJax(mesh=)``), over the one-device mesh of
    ``device`` without one; the exported program is one device's, as JAX's,
    and refuses a mesh.
    """
    import os

    if variant == "exported":
        if mesh is not None:
            raise ValueError("the exported variant runs on one device: it takes no mesh")
        from spef_tpu_torch.deploy import load_exported

        return load_exported(os.path.join(exp_dir, "model.spef"), device=device)
    mesh = mesh_or_device(mesh, device)
    device = mesh.devices[0]
    if variant in ("crop-refine", "crop-refine-w8"):
        import json

        from spef_tpu_torch.config.train_config import load_config

        with open(os.path.join(exp_dir, "crop_refine.json")) as f:
            reg = json.load(f)
        fine_exp = reg["fine_exp"]
        gate = reg.get("gate", 0.02)
        crop_hw = tuple(load_config(os.path.join(fine_exp, "config.yaml")).DATA.IMG_SIZE)
        fine = load_experiment_model(fine_exp, device=device)
        if variant == "crop-refine-w8":
            from spef_tpu_torch.quant.weight_only import quantize_model_weights

            # Copies: the caller's float model is shared with the float variant.
            model = quantize_model_weights(model, 8)[0]
            fine = quantize_model_weights(fine, 8)[0]
        return SPECropRefine(model, fine, spe_utils, crop_hw=crop_hw, gate=gate, device=device,
                             mesh=mesh)
    build = None
    if variant in ("weight-only", "int8-carry"):
        from spef_tpu_torch.quant.int8_graph import load_int8_graph

        graph = load_int8_graph(os.path.join(exp_dir, "int8_graph.pkl"))
        if variant == "weight-only":
            from spef_tpu_torch.quant.int8_model import build_weight_only_forward as build_fwd
        else:
            from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward as build_fwd

        def build(dev):
            return build_fwd(graph, device=dev)
    elif variant != "float":
        raise KeyError(f"unknown engine variant {variant!r}")
    return SPETorch(model, spe_utils, forward_fn=build, mesh=mesh)
