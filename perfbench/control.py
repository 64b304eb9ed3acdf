"""Readings that set a cell's limits, on the card at the cell's own size:

    python3 perfbench/control.py --workload <cell> --mode program --seeds S1 S2 ...
    python3 perfbench/control.py --workload <cell> --mode control --seeds S1 S2 S3
    python3 perfbench/control.py --workload <cell> --mode fault:<name> --seeds S1 S2 S3

``program``: a short run of the cell a seed (the timed path, at its sizes),
every number its comparison reckons, those the cell's limits leave out
too.  ``control``: the reference computed in the precision below the
configuration's (``control_lowp``: int4 weights for int8, fp8 operands for
bf16) put in the program's place, compared the same way.
``fault:<name>``: a run with one of ``perfbench/faults.py``'s faults under
the timed path.  One JSON line a seed; the benchmark's own runs never run
this.
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
    import numpy as np
    import torch

    from perfbench.harness import Context, cell_files
    from perfbench.trace import Tracer

    _, cell, cfg, traffic, limits = cell_files(root, workload)
    ctx = Context(root=root, cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=seed,
                  seconds=0.0, trace=False, device=torch.device(device), backend="plain",
                  t_start=0.0, tracer=Tracer(False, torch.device(device)), sizes=sizes or {})
    lowp = cfg["control_lowp"]
    if traffic["driver"] == "train":
        from perfbench.drivers import train

        # The start's three steps; then one more from the reference's state
        # after them, in the place of the window's step.
        *batches, last = train.checked_batches(ctx)
        ref = train.reference_steps(ctx, batches)
        low = train.reference_steps(ctx, batches, lowp)
        found = train.gaps(ref, low["losses"], low["first_grad"], low["change"],
                           low["first_pdfs"])
        start = dict(ref["state"], gen=ref["gen_state"])
        ref1 = train.reference_steps(ctx, [last], gen_state=start["gen"], start=start)
        low1 = train.reference_steps(ctx, [last], lowp, gen_state=start["gen"], start=start)
        found.update(train.window_gaps(ref1, start, dict(low1["state"], loss=low1["losses"][0])))
        return found
    from perfbench.drivers import stream

    pool = stream.make_pool(ctx)
    used = list(range(len(pool)))
    ref = stream.reference_outputs(ctx, pool, used)
    low = stream.reference_outputs(ctx, pool, used, lowp)
    worst = {}
    for i in used:
        out = {"ori_soft": np.exp(low[i]["ori_logpdf"]), "pos_soft": np.exp(low[i]["pos_logpdf"])}
        found = {**stream.pose_gaps(low[i]["ori"], low[i]["pos"], ref[i]),
                 **stream.logpdf_gaps(out, ref[i])}
        for name, v in found.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def main(argv=None) -> int:
    import torch

    from perfbench import faults
    from perfbench.harness import cell_files, run_cell

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
    _, _, _, traffic, _ = cell_files(root, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode == "control":
            readings = control_readings(root, args.workload, seed, dev)
        else:
            fault = None
            if args.mode.startswith("fault:"):
                table = faults.TRAIN if traffic["driver"] == "train" else faults.STREAM
                fault = table[args.mode.split(":", 1)[1]]
            readings = run_cell(root, args.workload, seed, args.seconds, False, dev,
                                fault=fault)["numbers"]
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "readings": readings, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
