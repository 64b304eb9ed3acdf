"""Training and evaluation engines.

Counterparts of ``spef_tpu.train.trainer`` (``Trainer`` and
``evaluation``).  ``Trainer.fit`` is the epoch x phase x batch loop:

  * a train batch is moved to the device, augmented there (yaw warp with
    its pose update, blur, color jitter: ``data/augment.py``) before the
    step, as JAX runs its augment outside the step; then targets encoded,
    one optimizer step (``train/step.py``), metrics weighted by the mask
    (``_masked_metrics``, exact over a padded last batch);
  * the per-step metrics stay on the device and are read back every
    ``_FLUSH_EVERY`` steps in one copy, when a non-finite loss raises;
  * the scheduler steps after the train phase; the best model is selected
    on the valid ``loss`` or ``esa`` and written at each improvement
    (``CheckpointManager.save_best``); every epoch is checkpointed;
  * ``resume`` restarts from the latest checkpoint with the generator
    reseeded from ``seed + start_epoch * 7919`` and the best model
    reloaded from ``best_model.msgpack``.

Every random draw (augmentation, dropout) comes from one ``torch.Generator``
on the training device.

With a data-parallel ``mesh`` of more than one rank (``parallel/mesh.py``,
JAX's ``mesh``) every rank reads the global batch and computes on its rows:
its loaders decode and warp only those rows (``BatchLoader.mesh``), the
augmentation and dropout draw for the global batch, BatchNorm takes the
global batch's statistics, the outputs are gathered before the loss and the
metrics, and the gradients summed, so each step is the single-device step
on the global batch.  Rank 0 alone prints, logs and checkpoints.

The train phase is timed per batch (CUDA events on
the card, the host clock on the CPU): ``Trainer.epoch_stats`` holds, per
epoch, the step ms p50, the augmentation ms a batch, frames/s, the share of
the phase's wall time spent in steps and the peak device memory;
``Trainer.start_epoch`` is the first epoch of the last ``fit``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.augment import train_augment
from spef_tpu_torch.data.camera import Camera
from spef_tpu_torch.models.layers import set_data_parallel
from spef_tpu_torch.parallel.mesh import Mesh, all_gather_rows, replicate, shard_batch
from spef_tpu_torch.pose.score import pose_errors
from spef_tpu_torch.train.loss import SPELoss
from spef_tpu_torch.train.optimizer import set_learning_rate
from spef_tpu_torch.train.step import TrainState, _apply_last_activation, train_update
from spef_tpu_torch.utils.metrics import RunningAverage, mad

__all__ = ["Trainer", "evaluation"]

_METRIC_KEYS = ("loss", "esa_score", "ori_score", "pos_score", "ori_error", "pos_error")
# Steps whose device metrics are buffered before one read-back: a
# divergence is caught within this many batches of where it happened.
_FLUSH_EVERY = 50


def _shard_loaders(data: Dict[str, Iterable[Dict]], mesh: Optional[Mesh]) -> None:
    """Keep each loader's host work (decode, warp) to the rank's rows of
    ``mesh`` (``BatchLoader.mesh``), or, with None, to none of them."""
    for loader in data.values():
        if hasattr(loader, "mesh"):
            loader.mesh = mesh


def _masked_metrics(spe_utils: SPEUtils, pose, targets, mask) -> Dict[str, torch.Tensor]:
    """Mask-weighted ESA metrics (exact over padded batches).  A diverged
    step's non-finite PDFs are decoded as uniform ones (the decode's
    ``eigh`` raises on NaN): the loss carries the NaN to the
    trainer's guard."""
    decoded = spe_utils.decode({
        k: torch.where(torch.isfinite(v), v, 1.0 / v.shape[-1]) if k.endswith("_soft") else v
        for k, v in pose.items()})
    e = pose_errors(targets["ori"], targets["pos"], decoded["ori"], decoded["pos"])
    n = torch.clamp(torch.sum(mask), min=1.0)
    mean_ori = torch.sum(e["ori_error"] * mask) / n
    mean_norm_pos = torch.sum(e["norm_pos_error"] * mask) / n
    return {
        "esa_score": mean_ori + mean_norm_pos,
        "ori_score": mean_ori,
        "pos_score": mean_norm_pos,
        "ori_error": torch.rad2deg(mean_ori),
        "pos_error": torch.sum(e["pos_error"] * mask) / n,
    }


def _fmt(running: RunningAverage, key: str, spec: str) -> str:
    """A running metric, or ``n/a`` where no batch gave it."""
    meter = running.meters[key]
    return format(meter.avg, spec) if meter.count else "n/a"


class _BatchClock:
    """Marks on the device's timeline: CUDA events on the card (read after
    a synchronize), the host clock on the CPU, where every op is
    synchronous."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Trainer:
    """End-to-end trainer for a (model, codec, loss) configuration."""

    def __init__(
        self,
        spe_utils: SPEUtils,
        spe_loss: SPELoss,
        camera: Optional[Camera] = None,
        rot_augment: bool = False,
        other_augment: bool = False,
        clip_batchnorm: bool = False,
        seed: int = 1001,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.spe_utils = spe_utils
        self.spe_loss = spe_loss
        self.camera = camera or spe_utils.camera
        self.rot_augment = rot_augment
        self.other_augment = other_augment
        self.clip_batchnorm = clip_batchnorm
        self.seed = seed
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._lead = self.mesh is None or self.mesh.rank == 0
        self.epoch_stats: List[Dict[str, float]] = []
        self.start_epoch = 1
        self._255 = torch.tensor(255.0, device=self.device)

    # ------------------------------------------------------------------
    def _encode_targets(self, ori: torch.Tensor, pos: torch.Tensor,
                        crop: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The pose, its soft-class PDFs and, in the keypoints mode, the
        keypoint label vector, in the crop-local coordinates of the batch's
        ``crop`` windows where it has them (crop-refine datasets)."""
        utils = self.spe_utils
        t = {"ori": ori, "pos": pos}
        if utils.ori_mode == "classification":
            t["ori_soft"] = utils.orientation.encode(ori)
        if utils.pos_mode == "classification":
            t["pos_soft"] = utils.position.encode(pos)
        if "keypoints" in (utils.ori_mode, utils.pos_mode):
            kp = utils.keypoints.create_keypoints2d(ori, pos)
            if crop is not None:
                from spef_tpu_torch.codec.crop import map_keypoints_to_crop

                kp = map_keypoints_to_crop(kp, crop)
            t["keypoints"] = kp
        return t

    def _crop(self, batch) -> Optional[torch.Tensor]:
        return self._put(batch["crop"]) if "crop" in batch else None

    def _put(self, x) -> torch.Tensor:
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x.to(self.device)

    def _images(self, x) -> torch.Tensor:
        # An IEEE division, as JAX's (a CUDA tensor divided by a Python
        # scalar is multiplied by the reciprocal).
        return self._put(x).float() / self._255

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _eval_metrics(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        state.model.eval()
        ori, pos, mask = (self._put(batch[k]) for k in ("ori", "pos", "mask"))
        crop = self._crop(batch)
        targets = self._encode_targets(ori, pos, crop)
        with torch.no_grad():
            pred = state.model(self._images(shard_batch(self.mesh, batch)["images"]))
            pose = {k: all_gather_rows(self.mesh, v)
                    for k, v in _apply_last_activation(self.spe_utils, pred).items()}
            metrics = {"loss": self.spe_loss.compute_loss(pose, targets)}
            if crop is not None and "keypoints" in pose:
                # The loss compares crop-local coordinates; the pose metrics
                # decode the keypoints mapped back to the full frame.
                from spef_tpu_torch.codec.crop import map_keypoints_from_crop

                pose = dict(pose, keypoints=map_keypoints_from_crop(pose["keypoints"], crop))
            metrics.update(_masked_metrics(self.spe_utils, pose, targets, mask))
        return metrics

    # ------------------------------------------------------------------
    def fit(
        self,
        state: TrainState,
        data: Dict[str, Iterable[Dict]],
        n_epochs: int,
        scheduler=None,
        split: Tuple[str, ...] = ("train", "valid"),
        writer=None,
        verbose: bool = True,
        checkpoint_manager=None,
        resume: bool = False,
        best_metric: str = "loss",
    ):
        """Epochs ``start..n_epochs`` of ``split``'s phases; returns (state
        with the best model's weights, rec_loss, rec_score, rec_error).

        ``scheduler`` defaults to ``state.scheduler``.  ``best_metric``: the
        valid quantity the best model is selected on, ``"loss"`` or
        ``"esa"``.  With ``checkpoint_manager`` every epoch is saved and
        ``resume=True`` restarts from the latest one.
        """
        if best_metric not in ("loss", "esa"):
            raise ValueError(f"best_metric must be loss or esa, got {best_metric!r}")
        if "train" not in split or "valid" not in split:
            raise ValueError(f"split must hold train and valid, got {split}")
        from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
        from spef_tpu_torch.models.wrapper import flax_variables, load_flax_variables

        scheduler = scheduler if scheduler is not None else state.scheduler
        verbose = verbose and self._lead
        if self.mesh is not None:
            replicate(self.mesh, state.model)
            set_data_parallel(state.model, self.mesh)
            _shard_loaders(data, self.mesh)
        best_loss = 1e6
        best_vars = None
        best_epoch = 1
        start_epoch = 1
        rec_loss = {x: [] for x in split}
        rec_score = {x: {"ori": [], "pos": [], "esa": []} for x in split}
        rec_error = {x: {"ori": [], "pos": []} for x in split}
        gen = self._generator(self.seed)
        self.epoch_stats = []

        if resume and checkpoint_manager is not None and checkpoint_manager.latest_epoch():
            state, meta = checkpoint_manager.restore(state)
            start_epoch = int(meta.get("epoch", 0)) + 1
            best_loss = float(meta.get("best_loss", best_loss))
            best_epoch = int(meta.get("best_epoch", best_epoch))
            gen = self._generator(self.seed + start_epoch * 7919)
            best_path = os.path.join(checkpoint_manager.directory, "best_model.msgpack")
            if os.path.isfile(best_path):
                best_vars = read_flax_msgpack(best_path)
            if verbose:
                print(f"Resumed from epoch {start_epoch - 1} (best_loss={best_loss:.4f})")

        self.start_epoch = start_epoch
        augment = self.rot_augment or self.other_augment
        clock = _BatchClock(self.device)
        for epoch in range(start_epoch, n_epochs + 1):
            for phase in split:
                running = RunningAverage(keys=_METRIC_KEYS)
                pending = []
                marks = []  # train: (start, augmented, stepped) a batch

                def _flush():
                    if not pending:
                        return
                    keys = [k for k in _METRIC_KEYS if k in pending[0][2]]
                    values = torch.stack([torch.stack([m[k].float() for k in keys])
                                          for _, _, m in pending]).cpu().numpy()
                    for (b_idx, n_v, _), row in zip(pending, values):
                        if not np.isfinite(row[0]):
                            raise ValueError(f"Non-finite loss at epoch {epoch} ({phase}), "
                                             f"batch {b_idx}")
                        running.update(dict(zip(keys, row)), n_v)
                    pending.clear()

                if phase == "train" and self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                t_phase = time.perf_counter()
                n_frames = 0
                for b_idx, batch in enumerate(data[phase]):
                    n_valid = int(batch["mask"].sum())
                    n_frames += n_valid
                    if "crop" in batch and self.rot_augment:
                        raise ValueError(
                            "crop-refine batches are incompatible with the yaw rotation "
                            "augment (the stored crop window cannot follow the warped pose); "
                            "set ROT_AUGMENT: false")
                    if phase == "train":
                        t0 = clock.mark()
                        local = shard_batch(self.mesh, batch)
                        images = self._images(local["images"])
                        ori, pos = (self._put(local[k]) for k in ("ori", "pos"))
                        mask = self._put(batch["mask"])
                        if augment:
                            images, ori, pos = train_augment(
                                gen, images, ori, pos, self.camera, self.rot_augment,
                                self.other_augment,
                                None if self.mesh is None else (self.mesh.rank, self.mesh.size))
                        t1 = clock.mark()
                        ori, pos = all_gather_rows(self.mesh, ori), all_gather_rows(self.mesh, pos)
                        targets = self._encode_targets(ori, pos, self._crop(batch))
                        loss, pose = train_update(state, images, targets, self.spe_utils,
                                                  self.spe_loss, gen, self.clip_batchnorm,
                                                  self.mesh)
                        marks.append((t0, t1, clock.mark()))
                        metrics = {"loss": loss}
                        if not self.spe_utils.keypoints_mode:  # as JAX's train step
                            with torch.no_grad():
                                metrics.update(_masked_metrics(self.spe_utils, pose, targets,
                                                               mask))
                    else:
                        metrics = self._eval_metrics(state, batch)
                    pending.append((b_idx, n_valid, metrics))
                    if len(pending) >= _FLUSH_EVERY:
                        _flush()
                _flush()
                if phase == "train":
                    self._record_epoch(epoch, clock, marks, n_frames,
                                       time.perf_counter() - t_phase, verbose)

                running_loss = running.get("loss")
                rec_loss[phase].append(running_loss)
                rec_score[phase]["ori"].append(running.get("ori_score"))
                rec_score[phase]["pos"].append(running.get("pos_score"))
                rec_score[phase]["esa"].append(running.get("esa_score"))
                rec_error[phase]["ori"].append(running.get("ori_error"))
                rec_error[phase]["pos"].append(running.get("pos_error"))
                if verbose:
                    print(f"epoch {epoch:3d} [{phase:6s}] loss={running_loss:.4f} "
                          f"esa={_fmt(running, 'esa_score', '.4f')} "
                          f"ori_err={_fmt(running, 'ori_error', '.2f')}deg "
                          f"pos_err={_fmt(running, 'pos_error', '.3f')}m", file=sys.stdout,
                          flush=True)

                if phase == "train" and scheduler is not None:
                    set_learning_rate(state.optimizer, scheduler.step(epoch, running_loss))
                elif phase == "valid":
                    sel = running_loss if best_metric == "loss" else running.get("esa_score")
                    if sel < best_loss:
                        best_vars = flax_variables(state.model)
                        best_loss = sel
                        best_epoch = epoch
                        if checkpoint_manager is not None and self._lead:
                            checkpoint_manager.save_best(
                                best_vars, meta={"epoch": epoch, "valid_loss": running_loss,
                                                 "best_metric": best_metric, "best_value": sel})

                if writer is not None and self._lead:
                    for key in _METRIC_KEYS:
                        writer.add_scalar(f"{key}/{phase}", running.get(key), epoch)

            if checkpoint_manager is not None and self._lead:
                checkpoint_manager.save(epoch, state, meta={
                    "epoch": epoch, "best_loss": best_loss, "best_epoch": best_epoch})

        if self.mesh is not None:
            set_data_parallel(state.model, None)
            _shard_loaders(data, None)
        if best_vars is not None:
            load_flax_variables(state.model, best_vars)
        if verbose:
            print(f"Best epoch: {best_epoch}")
        return state, rec_loss, rec_score, rec_error

    def _record_epoch(self, epoch: int, clock: _BatchClock, marks, n_frames: int, wall_s: float,
                      verbose: bool) -> None:
        """The train phase's timing: step ms p50, augmentation ms a batch,
        frames/s, the share of the wall time inside steps, peak memory."""
        if clock.cuda:
            torch.cuda.synchronize(self.device)
        step_ms = [clock.ms(t1, t2) for _, t1, t2 in marks]
        aug_ms = [clock.ms(t0, t1) for t0, t1, _ in marks]
        peak = (torch.cuda.max_memory_allocated(self.device) if clock.cuda else None)
        stats = {
            "epoch": epoch,
            "batches": len(marks),
            "frames": n_frames,
            "wall_s": wall_s,
            "step_ms_p50": float(np.percentile(step_ms, 50)) if step_ms else float("nan"),
            "augment_ms": float(np.mean(aug_ms)) if aug_ms else float("nan"),
            "frames_per_s": n_frames / wall_s if wall_s > 0 else float("nan"),
            "step_share": sum(step_ms) / 1e3 / wall_s if wall_s > 0 else float("nan"),
            "peak_memory_bytes": peak,
        }
        self.epoch_stats.append(stats)
        if verbose:
            source = "CUDA events" if clock.cuda else "host clock"
            mem = f"{peak / 2**30:.3f} GiB" if peak is not None else "n/a (CPU)"
            print(f"epoch {epoch:3d} [timing] {stats['batches']} steps: step p50 "
                  f"{stats['step_ms_p50']:.3f} ms, augmentation {stats['augment_ms']:.3f} ms a "
                  f"batch ({source}); {stats['frames_per_s']:.1f} frames/s, steps "
                  f"{100 * stats['step_share']:.1f}% of the phase's {wall_s:.2f} s; peak "
                  f"memory {mem}", flush=True)


def evaluation(
    engine,
    data: Dict[str, Iterable[Dict[str, np.ndarray]]],
    spe_utils: SPEUtils,
    split: Tuple[str, ...] = ("valid",),
) -> Tuple[Dict, Dict]:
    """Engine-agnostic evaluation: ``engine.predict(images) -> (pose,
    latency_ms)``, duck-typed; ``data[phase]`` yields the loader's padded
    batches (``mask`` marks the real rows).  Returns ``(rec_score,
    rec_error)``: the running averages weighted by the valid rows of each
    batch, with the std and the MAD of the per-frame errors."""
    rec_score = {x: {"ori": [], "pos": [], "esa": []} for x in split}
    rec_error = {
        x: {"ori": [], "pos": [], "ori_std": [], "pos_std": [], "ori_mad": [], "pos_mad": []}
        for x in split
    }
    for phase in split:
        errors = {"ori": [], "pos": []}
        running = RunningAverage(keys=("esa_score", "ori_score", "pos_score", "ori_error",
                                       "pos_error"))
        for batch in data[phase]:
            pose, _ = engine.predict(batch["images"])
            n_valid = int(batch["mask"].sum())
            # The engine's pose lives on its device; scoring is on the host.
            ori_p = torch.as_tensor(pose["ori"]).cpu()[:n_valid]
            pos_p = torch.as_tensor(pose["pos"]).cpu()[:n_valid]
            e = pose_errors(batch["ori"][:n_valid], batch["pos"][:n_valid], ori_p, pos_p)
            if int(e["invalid"]) > 0:
                raise ValueError("Intermediate sum issue due to error in model prediction")
            ori_err = e["ori_error"].numpy()
            pos_err = e["pos_error"].numpy()
            norm_pos = e["norm_pos_error"].numpy()
            metrics = {
                "esa_score": float(np.mean(ori_err) + np.mean(norm_pos)),
                "ori_score": float(np.mean(ori_err)),
                "pos_score": float(np.mean(norm_pos)),
                "ori_error": float(np.rad2deg(np.mean(ori_err))),
                "pos_error": float(np.mean(pos_err)),
            }
            running.update(metrics, n_valid)
            errors["ori"].extend(np.rad2deg(ori_err).tolist())
            errors["pos"].extend(pos_err.tolist())

        rec_score[phase]["ori"].append(running.get("ori_score"))
        rec_score[phase]["pos"].append(running.get("pos_score"))
        rec_score[phase]["esa"].append(running.get("esa_score"))
        rec_error[phase]["ori"].append(running.get("ori_error"))
        rec_error[phase]["pos"].append(running.get("pos_error"))
        rec_error[phase]["ori_std"].append(float(np.std(errors["ori"])))
        rec_error[phase]["pos_std"].append(float(np.std(errors["pos"])))
        rec_error[phase]["ori_mad"].append(mad(errors["ori"]))
        rec_error[phase]["pos_mad"].append(mad(errors["pos"]))

    return rec_score, rec_error
