"""Training CLI — trains one experiment or a folder of them, on one GPU.

Counterpart of ``spef_tpu.apps.train``: takes one experiment config
(``--config``) or a folder of ``exp_*`` configs (``--experiments``: a plain
YAML is a float model; a directory holding a YAML and ``bit_width.json`` a
quantized one), trains each, evaluates it through ``SPETorch`` and writes
``config.yaml``, the scores and ``model/parameters.msgpack`` (flax's
format) into ``<out>/<experiment>``.  An experiment that fails writes its
traceback to ``error.log`` and the others go on.

Usage:
    python -m spef_tpu_torch.apps.train --config path/to/exp.yaml --out experiments/train \\
        [--epochs N] [--checkpoint] [--device-augment] [--cache-dataset | --device-data] \\
        [--warm-start parameters.msgpack] [--pretrained-backbone mobilenet_v2.npz] \\
        [--device cuda]

It runs on the card; ``--device cpu`` runs it on the CPU.  The yaw-rotation
augmentation (``DATA.ROT_AUGMENT``) warps the frames on the host, in the
loader (``data/augment_host.py``), as JAX's does, or on the device with
``--device-augment``; ``--device-data`` needs the latter.  The loader's
decoder (``data/dataset.py``: native where the host can build it, else the
PNG reader) is printed.

``--data-parallel`` trains over a ``torch.distributed`` process group, one
process a card (``parallel/mesh.py``): run it under
``python -m torch.distributed.run --nproc_per_node N -m spef_tpu_torch.apps.train
... --data-parallel``.  Each step is the single-device step on the global
batch; rank 0 writes the experiment.  Without ``torch.distributed.run``, or
with one process, the flag changes nothing.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import traceback
from typing import Dict, List, Optional

import torch

__all__ = ["main", "run_experiment"]


def run_experiment(name: str, cfg, bit_width_path, out_root: str, seed: int = 1001,
                   mesh=None, cache_dataset=False, checkpoint: bool = False,
                   epochs: int = 0, device_augment: bool = False, warm_start: str = "",
                   device: str = "cuda") -> dict:
    """Train, evaluate and save one experiment; returns its records and the
    trainer's per-epoch timing (``epochs``) and first epoch (``start_epoch``).
    ``mesh``: a data-parallel ``parallel.mesh.Mesh`` of more than one rank
    (it then sets the device), or None."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.config.train_config import save_config
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.dataset import load_dataset
    from spef_tpu_torch.engine import SPETorch
    from spef_tpu_torch.models.wrapper import import_model, save_model
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state
    from spef_tpu_torch.train.trainer import Trainer, evaluation
    from spef_tpu_torch.utils.experiment import prepare_directories, save_score_error, set_seed

    host_warp = bool(cfg.DATA.ROT_AUGMENT and not device_augment)
    if cache_dataset == "device" and host_warp:
        raise SystemExit("--device-data requires --device-augment "
                         "(the host warp cannot touch device-resident images)")
    if mesh is not None:
        device = str(mesh.device)
    lead = mesh is None or mesh.rank == 0
    set_seed(seed)
    # With checkpointing an existing directory is resumed in place.
    save_folder = (prepare_directories(os.path.join(out_root, name),
                                       on_collision="reuse" if checkpoint else "version")
                   if lead else None)
    if mesh is not None:  # every rank writes to (and resumes from) rank 0's folder
        import torch.distributed as dist

        shared = [save_folder]
        dist.broadcast_object_list(shared, src=0)
        save_folder = shared[0]
        if lead:
            print(f"Data-parallel training over {mesh.size} ranks ({mesh.device.type})")
    if lead:
        print(f"\nResults will be saved to {save_folder}\n")

    camera = load_camera(cfg.DATA.PATH)
    spe_utils = SPEUtils.from_config(cfg, camera, device=device)
    rot_augment = None
    if host_warp:
        from spef_tpu_torch.data.augment_host import HostRotationAugment

        rot_augment = HostRotationAugment(camera, seed=seed)
    data, split = load_dataset(cfg.DATA.PATH, cfg.DATA.BATCH_SIZE, tuple(cfg.DATA.IMG_SIZE),
                               shuffle=cfg.DATA.SHUFFLE, seed=seed, rot_augment=rot_augment,
                               cache=cache_dataset, device=device)
    if lead:
        print(f"Decoder: {next(iter(data.values())).decoder}; yaw-rotation warp: "
              + (f"host ({rot_augment.warp})" if host_warp else
                 "device" if cfg.DATA.ROT_AUGMENT else "off"))

    bit_width = None
    if bit_width_path:
        from spef_tpu_torch.quant.bitwidth import load_bit_width

        bit_width = load_bit_width(bit_width_path)

    model = import_model(
        backbone_name=cfg.MODEL.BACKBONE.NAME,
        head_name=cfg.MODEL.HEAD.NAME,
        params_path=cfg.MODEL.PRETRAINED_PATH or None,
        pretrained_path=cfg.MODEL.PRETRAINED_BACKBONE or None,
        bit_width=bit_width,
        residual=cfg.MODEL.BACKBONE.RESIDUAL,
        quantization=cfg.MODEL.QUANTIZATION,
        ori_mode=cfg.MODEL.HEAD.ORI,
        n_ori_bins=spe_utils.orientation.n_bins,
        pos_mode=cfg.MODEL.HEAD.POS,
        n_pos_bins=spe_utils.position.n_bins,
        img_size=tuple(cfg.DATA.IMG_SIZE),
        seed=seed,
        device=device,
    )
    if warm_start:
        # Category-ordered copy from any trained checkpoint of the same
        # backbone; leaves whose shapes differ (another head) keep their init.
        from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
        from spef_tpu_torch.models.wrapper import flax_variables, load_flax_variables
        from spef_tpu_torch.quant.warmstart import copy_params

        load_flax_variables(model, copy_params(read_flax_msgpack(warm_start),
                                               flax_variables(model), strict_shapes=False))
        print(f"Warm-started matching parameters from {warm_start}")

    n_params = sum(p.numel() for p in model.parameters())
    if lead:
        print(f"Number of trainable parameters in the model: {n_params:,}\n")

    spe_loss = SPELoss(cfg.MODEL.HEAD.ORI, cfg.MODEL.HEAD.POS, beta=1, norm_distance=True)
    optimizer, scheduler = import_optimizer(
        model.parameters(), cfg.TRAIN.LR, cfg.TRAIN.OPTIM, cfg.TRAIN.MOMENTUM, cfg.TRAIN.DECAY,
        cfg.TRAIN.SCHEDULER, tuple(cfg.TRAIN.MILESTONES), cfg.TRAIN.GAMMA)
    state = create_train_state(model, optimizer, scheduler)
    writer = None
    if lead:
        save_config(cfg, os.path.join(save_folder, "config.yaml"))
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(save_folder, "tensorboard"))
        except ImportError:  # the tensorboard package is not installed: no event files
            pass

    trainer = Trainer(spe_utils, spe_loss, camera,
                      rot_augment=bool(cfg.DATA.ROT_AUGMENT and device_augment),
                      other_augment=cfg.DATA.OTHER_AUGMENT,
                      clip_batchnorm=cfg.TRAIN.CLIP_BATCHNORM, seed=seed, device=device,
                      mesh=mesh)
    ckpt_mngr = None
    if checkpoint:
        from spef_tpu_torch.train.checkpoint import CheckpointManager

        ckpt_mngr = CheckpointManager(os.path.join(save_folder, "checkpoints"))
    state, rec_loss, rec_score, rec_error = trainer.fit(
        state, data, epochs or cfg.TRAIN.N_EPOCH, scheduler, split["train"], writer=writer,
        checkpoint_manager=ckpt_mngr, resume=checkpoint, best_metric=cfg.TRAIN.BEST_METRIC)
    if writer is not None:
        writer.close()
    warp = None
    if rot_augment is not None:
        warp = {"frames": rot_augment.frames, "warped": rot_augment.warped,
                "seconds": rot_augment.warp_seconds, "warp": rot_augment.warp}
        if lead:
            print(f"Host warp: {warp['warped']} of {warp['frames']} frames warped, "
                  f"{1e3 * warp['seconds'] / max(warp['warped'], 1):.3f} ms a warped frame "
                  f"(host clock, summed over the loader's threads)")
    if not lead:  # rank 0 evaluates and writes the experiment
        import torch.distributed as dist

        dist.barrier()
        return {"loss": rec_loss, "epochs": trainer.epoch_stats, "host_warp": warp,
                "folder": save_folder}

    # Final evaluation through the engine, then persistence.
    engine = SPETorch(state.model.eval(), spe_utils, device=device)
    eval_score, eval_error = evaluation(engine, data, spe_utils, split["eval"])
    for phase in split["eval"]:
        print(f"[{phase}] esa={eval_score[phase]['esa'][0]:.4f} "
              f"ori_err={eval_error[phase]['ori'][0]:.2f}deg "
              f"pos_err={eval_error[phase]['pos'][0]:.3f}m")
    save_score_error(save_folder, eval_score, eval_error)
    save_model(os.path.join(save_folder, "model"), state.model, bit_width)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    return {"loss": rec_loss, "score": eval_score, "error": eval_error,
            "epochs": trainer.epoch_stats, "start_epoch": trainer.start_epoch,
            "host_warp": warp, "decoder": next(iter(data.values())).decoder,
            "folder": save_folder}


def main(argv: Optional[List[str]] = None) -> Dict[str, Optional[dict]]:
    """Run every experiment; returns {name: its record, or None where it
    failed or was skipped}."""
    from spef_tpu_torch.config.train_config import discover_experiments, load_config

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", help="single experiment YAML")
    parser.add_argument("--experiments", help="folder of exp_* configs")
    parser.add_argument("--out", default="experiments/train", help="output root")
    parser.add_argument("--seed", type=int, default=1001)
    parser.add_argument("--data-parallel", action="store_true",
                        help="train over the ranks of torch.distributed.run, one a card (one "
                             "process: no change)")
    parser.add_argument("--cache-dataset", action="store_true",
                        help="decode each split once and serve its epochs from RAM (a "
                             "memmapped sidecar file on later runs)")
    parser.add_argument("--device-data", action="store_true",
                        help="keep the decoded splits on the device and gather each batch "
                             "there (implies --cache-dataset)")
    parser.add_argument("--checkpoint", action="store_true",
                        help="checkpoint every epoch into <out>/<exp>/checkpoints and resume "
                             "from the latest one; the best model is written at every "
                             "improvement")
    parser.add_argument("--epochs", type=int, default=0,
                        help="override TRAIN.N_EPOCH (0 = use config)")
    parser.add_argument("--device-augment", action="store_true",
                        help="run the yaw-rotation augmentation on the device instead of "
                             "warping the frames on the host")
    parser.add_argument("--warm-start", default="",
                        help="flax msgpack checkpoint to seed matching parameters from "
                             "(leaves of another shape keep their fresh init)")
    parser.add_argument("--pretrained-backbone", default="",
                        help="torchvision-format MobileNetV2 checkpoint (.npz or torch "
                             "state_dict) ingested into the backbone before training")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")

    if args.config:
        exps = {os.path.splitext(os.path.basename(args.config))[0]: {
            "config": args.config, "bit_width": None}}
    elif args.experiments:
        exps = discover_experiments(args.experiments)
    else:
        parser.error("one of --config / --experiments is required")

    logging.basicConfig(level=logging.INFO)
    mesh = None
    if args.data_parallel:
        from spef_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.device)
        if mesh.size == 1:  # one process: nothing is sharded
            mesh = None
    results: Dict[str, Optional[dict]] = {}
    for name, paths in exps.items():
        results[name] = None
        out_dir = os.path.join(args.out, name)
        # With --checkpoint an existing directory means "resume", not "skip".
        skip = [bool(os.path.isdir(out_dir) and os.listdir(out_dir) and not args.checkpoint)]
        if mesh is not None:  # rank 0 decides, before it makes the folder
            import torch.distributed as dist

            dist.broadcast_object_list(skip, src=0)
        if skip[0]:
            print(f"Skip {name}: {out_dir} already exists")
            continue
        try:
            cfg = load_config(paths["config"])
            if args.pretrained_backbone:
                cfg.MODEL.PRETRAINED_BACKBONE = args.pretrained_backbone
            results[name] = run_experiment(
                name, cfg, paths["bit_width"], args.out, args.seed,
                mesh=mesh,
                cache_dataset="device" if args.device_data else args.cache_dataset,
                checkpoint=args.checkpoint, epochs=args.epochs,
                device_augment=args.device_augment, warm_start=args.warm_start,
                device=args.device)
        except Exception:
            # Per-experiment error isolation: record the traceback, go on.
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "error.log"), "a") as f:
                traceback.print_exc(file=f)
            traceback.print_exc()
            print(f"Experiment {name} failed; continuing", file=sys.stderr)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
