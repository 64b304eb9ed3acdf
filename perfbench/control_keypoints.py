"""Readings that set a keypoint cell's limits, on the card at the cell's own
size (``control.py``'s modes, for cells whose traffic runs the
``keypoints_stream`` driver):

    python3 perfbench/control_keypoints.py --workload <cell> --mode program --seeds S1 S2 ...
    python3 perfbench/control_keypoints.py --workload <cell> --mode control --seeds S1 S2 S3
    python3 perfbench/control_keypoints.py --workload <cell> --mode fault:<name> --seeds S1 S2 S3

``program``: a short run of the cell a seed, every number its comparison
reckons.  ``control``: the reference in ``control_lowp`` (fp8 operands) in
the program's place, over every frame of the pool.  ``fault:<name>``: a run
with one of ``faults.STREAM``'s faults under the timed path (``half``,
``stale``).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_readings(root: str, workload: str, seed: int, device, sizes=None):
    """The control's numbers, named as the cell's comparison names them."""
    import torch

    from perfbench.drivers import keypoints_stream
    from perfbench.harness import Context, cell_files
    from perfbench.trace import Tracer

    _, cell, cfg, traffic, limits = cell_files(root, workload)
    dev = torch.device(device)
    ctx = Context(root=root, cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=seed,
                  seconds=0.0, trace=False, device=dev, backend="plain", t_start=0.0,
                  tracer=Tracer(False, dev), sizes=sizes or {})
    return keypoints_stream.control_readings(ctx)


def main(argv=None) -> int:
    import torch

    from perfbench import faults
    from perfbench.harness import run_cell

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    root = os.getcwd()
    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode == "control":
            readings = control_readings(root, args.workload, seed, dev)
        else:
            fault = faults.STREAM[args.mode.split(":", 1)[1]] if ":" in args.mode else None
            readings = run_cell(root, args.workload, seed, args.seconds, False, dev,
                                fault=fault)["numbers"]
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "readings": readings, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
