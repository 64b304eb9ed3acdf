"""Temporal (video) evaluation CLI, on one GPU.

Counterpart of ``spef_tpu.apps.temporal_eval``: every sequence of a video
dataset through ``temporal.inference.sequence_inference`` (a chunked
forward, then the still decode, the adaptive PDF filter and the filtered
decode on the device), the still and video scores of each, the per-axis
Euler traces, the report workbooks and, with ``--plots``, the report
figures (matplotlib).

Usage:
    python -m spef_tpu_torch.apps.temporal_eval \\
        --experiment experiments/train_synth/exp_dspeed_synth --data /path/to/dspeed/video \\
        [--batch-sequences] [--no-filter] [--plots] \\
        [--filter-constants experiments/accuracy_suite/temporal_tuning.json] [--out DIR] \\
        [--device cuda]

It runs on the card; ``--device cpu`` runs it on the CPU.  The filter's
constants are the dataset family's (``temporal/pdf_filter.py``: a video
root gives ``dspeed_video``, the js constants); ``--filter-constants``
overrides them.  ``--batch-sequences`` runs the equal-length sequences
together (``multi_sequence_inference``, cut to the shortest).  It writes
``temporal_metrics.json``, the workbooks' CSVs and, one sequence at a
time, ``temporal_tables*`` into ``--out`` (``<experiment>/temporal``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

__all__ = ["evaluate_sequence", "run_batched_sequences", "main", "parse_args"]


def _gather(loader):
    """(frames, ori, pos) of a loader's valid rows, in order."""
    frames, oris, poss = [], [], []
    for batch in loader:
        n_valid = int(batch["mask"].sum())
        frames.append(batch["images"][:n_valid])
        oris.append(batch["ori"][:n_valid])
        poss.append(batch["pos"][:n_valid])
    return np.concatenate(frames), np.concatenate(oris), np.concatenate(poss)


def _scores(truth_ori, truth_pos, ori, pos):
    from spef_tpu_torch.pose.score import score_batch

    dev = ori.device
    return {k: float(v) for k, v in score_batch(torch.as_tensor(truth_ori, device=dev),
                                                torch.as_tensor(truth_pos, device=dev),
                                                ori, pos).items()}


def evaluate_sequence(spe_utils, forward_fn, loader, filter_video=True, **filter_kwargs):
    """Run one sequence; returns (results of device tensors, truth dict,
    metrics dict)."""
    from spef_tpu_torch.pose.rotations import quat2euler
    from spef_tpu_torch.temporal.inference import sequence_inference

    frames, ori, pos = _gather(loader)
    truth = {"ori": ori, "pos": pos}
    res = sequence_inference(spe_utils, forward_fn, frames, filter_video=filter_video,
                             **filter_kwargs)

    metrics = {"still": _scores(ori, pos, res["ori_still"], res["pos_still"])}
    if filter_video:
        metrics["video"] = _scores(ori, pos, res["ori_video"], res["pos_video"])

    # The per-axis Euler traces (the reference plots yaw / pitch / roll errors).
    metrics["euler_true"] = quat2euler(torch.as_tensor(ori, dtype=torch.float32)).tolist()
    metrics["euler_still"] = quat2euler(res["ori_still"]).cpu().tolist()
    if filter_video:
        metrics["euler_video"] = quat2euler(res["ori_video"]).cpu().tolist()
        metrics["ori_distance"] = res["ori_distance"].cpu().tolist()
        metrics["pos_distance"] = res["pos_distance"].cpu().tolist()
    return res, truth, metrics


def _report_args(res, truth):
    """(args, kwargs) of the report functions for one sequence's results."""
    kwargs = {}
    if "ori_video" in res:
        kwargs = {name: res[key].cpu().numpy() for name, key in (
            ("video_ori", "ori_video"), ("video_pos", "pos_video"),
            ("ori_distance", "ori_distance"), ("pos_distance", "pos_distance"))}
    return (truth["ori"], truth["pos"], res["ori_still"].cpu().numpy(),
            res["pos_still"].cpu().numpy()), kwargs


def _line(seq, entry):
    line = f"[{seq}] still esa={entry['still']['esa_score']:.4f}"
    if "video" in entry:
        line += f"  video esa={entry['video']['esa_score']:.4f}"
    return line


def run_batched_sequences(spe_utils, forward_fn, data, seq_names, out_dir,
                          filter_video=True, plots=False, **filter_kwargs):
    """All sequences, cut to the shortest, through one
    ``multi_sequence_inference``; writes the workbooks and
    ``temporal_metrics.json``."""
    from spef_tpu_torch.temporal.inference import multi_sequence_inference
    from spef_tpu_torch.temporal.report import (sequence_figures, sequence_metrics,
                                                write_workbooks)

    gathered = [_gather(data[seq]) for seq in seq_names]
    t_min = min(g[0].shape[0] for g in gathered)
    seqs = np.stack([g[0][:t_min] for g in gathered])
    res = multi_sequence_inference(spe_utils, forward_fn, seqs, filter_video=filter_video,
                                   **filter_kwargs)

    summary = {}
    books = {"still": {}, "video": {}, "dist": {}}
    for i, seq in enumerate(seq_names):
        truth = {"ori": gathered[i][1][:t_min], "pos": gathered[i][2][:t_min]}
        one = {k: v[i] for k, v in res.items()}
        entry = {"still": _scores(truth["ori"], truth["pos"], one["ori_still"],
                                  one["pos_still"])}
        if filter_video:
            entry["video"] = _scores(truth["ori"], truth["pos"], one["ori_video"],
                                     one["pos_video"])
        summary[seq] = entry
        print(_line(seq, entry))
        rargs, rkwargs = _report_args(one, truth)
        books["still"][seq], books["video"][seq], books["dist"][seq] = sequence_metrics(
            *rargs, **rkwargs)
        if plots:
            sequence_figures(out_dir, seq, *rargs, **rkwargs)
    write_workbooks(out_dir, books["still"], books["video"], books["dist"])
    with open(os.path.join(out_dir, "temporal_metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"Saved metrics to {out_dir}/temporal_metrics.json")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", required=True)
    parser.add_argument("--data", required=True, help="video dataset root")
    parser.add_argument("--no-filter", action="store_true")
    parser.add_argument("--plots", action="store_true", help="report figures (matplotlib)")
    parser.add_argument("--batch-sequences", action="store_true",
                        help="run the equal-length sequences together")
    parser.add_argument("--out", default=None)
    parser.add_argument("--filter-constants", default=None,
                        help="JSON with tuned filter constants (the layout of "
                             "experiments/accuracy_suite/temporal_tuning.json); overrides "
                             "the dataset family's")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to evaluate on the CPU")

    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.config.train_config import load_config
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.dataset import detect_dataset, load_dataset
    from spef_tpu_torch.engine import load_experiment_model
    from spef_tpu_torch.temporal.report import (sequence_figures, sequence_metrics,
                                                write_workbooks)
    from spef_tpu_torch.utils.experiment import save_score_error, set_seed

    filter_overrides = {}
    if args.filter_constants:
        with open(args.filter_constants) as f:
            tuned = json.load(f)
        for kind in ("ori", "pos"):
            best = tuned[kind]["best"]
            filter_overrides[f"{kind}_filter"] = {
                "n": best["n"], "alpha": best["alpha"],
                "distance_metric": tuned[kind]["best_metric"],
            }
        print(f"filter constants from {args.filter_constants}: "
              + ", ".join(f"{k}={v}" for k, v in filter_overrides.items()))

    set_seed(1001)
    cfg = load_config(os.path.join(args.experiment, "config.yaml"))
    if cfg.MODEL.HEAD.ORI != "classification" or cfg.MODEL.HEAD.POS != "classification":
        raise ValueError("Adaptative temporal filtering requires classification/classification")
    spe_utils = SPEUtils.from_config(cfg, load_camera(args.data), device=args.device)
    data, split = load_dataset(args.data, batch_size=32, img_size=tuple(cfg.DATA.IMG_SIZE),
                               device=args.device)
    # The dataset family's filter constants; --filter-constants wins.
    dataset_kind = detect_dataset(args.data)
    model = load_experiment_model(args.experiment, device=args.device,
                                  n_ori_bins=spe_utils.orientation.n_bins,
                                  n_pos_bins=spe_utils.position.n_bins)

    out_dir = args.out or os.path.join(args.experiment, "temporal")
    os.makedirs(out_dir, exist_ok=True)
    if args.batch_sequences:
        run_batched_sequences(spe_utils, model, data, split["eval"], out_dir,
                              filter_video=not args.no_filter, plots=args.plots,
                              dataset=dataset_kind, **filter_overrides)
        return

    summary = {}
    books = {"still": {}, "video": {}, "dist": {}}
    for seq in split["eval"]:
        res, truth, metrics = evaluate_sequence(
            spe_utils, model, data[seq], filter_video=not args.no_filter,
            dataset=dataset_kind, **filter_overrides)
        summary[seq] = {k: metrics[k] for k in ("still", "video") if k in metrics}
        print(_line(seq, summary[seq]))
        rargs, rkwargs = _report_args(res, truth)
        books["still"][seq], books["video"][seq], books["dist"][seq] = sequence_metrics(
            *rargs, **rkwargs)
        if args.plots:
            sequence_figures(out_dir, seq, *rargs, **rkwargs)
    write_workbooks(out_dir, books["still"], books["video"], books["dist"])

    with open(os.path.join(out_dir, "temporal_metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    scores = {seq: {k: [v["esa_score"]] for k, v in m.items()} for seq, m in summary.items()}
    errors = {
        seq: {f"{k}_{axis}": [v[f"{axis}_error"]] for k, v in m.items() for axis in ("ori", "pos")}
        for seq, m in summary.items()
    }
    save_score_error(out_dir, scores, errors, name="temporal_tables")
    print(f"Saved metrics to {out_dir}/temporal_metrics.json")


if __name__ == "__main__":
    main()
