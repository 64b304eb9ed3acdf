"""NN statistics CLI: per-layer parameters and MACs of a model configuration.

Counterpart of ``spef_tpu.apps.nn_stats``, with the same flags; the table
is :func:`spef_tpu_torch.utils.stats.print_model_summary`'s (kernels HWIO,
outputs NHWC, as JAX prints them).  The model is built on the CPU and run
on one frame.

Usage:
    python -m spef_tpu_torch.apps.nn_stats [--backbone mobilenet_v2] [--head ursonet]
        [--img-size 240 384] [--ori classification] [--pos regression]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> dict:
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.utils.stats import print_model_summary

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--backbone", default="mobilenet_v2")
    parser.add_argument("--head", default="ursonet")
    parser.add_argument("--img-size", type=int, nargs=2, default=(240, 384))
    parser.add_argument("--ori", default="classification")
    parser.add_argument("--pos", default="regression")
    parser.add_argument("--ori-bins-per-dim", type=int, default=12)
    parser.add_argument("--pos-bins-per-dim", type=int, default=10)
    args = parser.parse_args(argv)

    spe_utils = SPEUtils.create(
        SPEED_CAMERA, ori_mode=args.ori, n_ori_bins_per_dim=args.ori_bins_per_dim,
        ori_delete_unused_bins=True, pos_mode=args.pos,
        n_pos_bins_per_dim=args.pos_bins_per_dim, use_keypoints=False, device="cpu",
    )
    model = import_model(
        backbone_name=args.backbone, head_name=args.head, img_size=tuple(args.img_size),
        ori_mode=args.ori, n_ori_bins=spe_utils.orientation.n_bins,
        pos_mode=args.pos, n_pos_bins=spe_utils.position.n_bins, device="cpu",
    )
    return print_model_summary(model, tuple(args.img_size))


if __name__ == "__main__":
    main()
