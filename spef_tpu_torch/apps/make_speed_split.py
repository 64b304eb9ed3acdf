"""SPEED train / valid split writer.

Counterpart of ``spef_tpu.apps.make_speed_split``, with the same flags and
outputs.  The reference split of SPEED (10,200 train / 1,800 valid
entries) is bundled with the port (``data/speed_split/``) and used by
``load_dataset(".../speed")`` unless the dataset directory holds its own;
this tool copies it into a dataset directory (to inspect or edit it for an
experiment) or, with ``--random``, derives a new split from the dataset's
own ``train.json``: a shuffle seeded by ``--seed``
(``np.random.RandomState``), the first ``round(n * --valid-fraction)``
entries of it for validation, both files in the order of ``train.json``.

Usage:
    python -m spef_tpu_torch.apps.make_speed_split --dataset /path/to/speed
    python -m spef_tpu_torch.apps.make_speed_split --dataset /path/to/speed \\
        --random [--valid-fraction 0.15] [--seed 1001]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import List, Optional

import numpy as np

from spef_tpu_torch.data.dataset import SPEED_SPLIT_DIR

__all__ = ["main"]

_NAMES = ("train_no_valid.json", "valid.json")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", required=True, help="SPEED root (holds train.json)")
    parser.add_argument("--random", action="store_true",
                        help="derive a fresh random split instead of the bundled reference one")
    parser.add_argument("--valid-fraction", type=float, default=0.15)
    parser.add_argument("--seed", type=int, default=1001)
    args = parser.parse_args(argv)

    if not args.random:
        for name in _NAMES:
            dst = os.path.join(args.dataset, name)
            shutil.copyfile(os.path.join(SPEED_SPLIT_DIR, name), dst)
            with open(dst) as f:
                print(f"{name}: {len(json.load(f))} entries (reference split)")
        return

    src = os.path.join(args.dataset, "train.json")
    if not os.path.isfile(src):
        raise SystemExit(f"{src} not found")
    with open(src) as f:
        entries = json.load(f)

    order = np.arange(len(entries))
    np.random.RandomState(args.seed).shuffle(order)
    valid_idx = set(order[:int(round(len(entries) * args.valid_fraction))].tolist())
    train = [e for i, e in enumerate(entries) if i not in valid_idx]
    valid = [e for i, e in enumerate(entries) if i in valid_idx]
    for name, data in zip(_NAMES, (train, valid)):
        with open(os.path.join(args.dataset, name), "w") as f:
            json.dump(data, f)
        print(f"{name}: {len(data)} entries")


if __name__ == "__main__":
    main()
