"""The benchmark's harness: one cell of ``BENCHMARK.json``, found by name.

A cell names a configuration (its file, ``perfbench/configs/<name>.json``
by way of the ``configs`` entry) and a traffic mix
(``perfbench/traffic/<traffic>.json``), whose ``driver`` names the general
generator that runs it (``perfbench/drivers/<driver>.py``).  The cell's
limits on the numbers compared with the reference are
``perfbench/limits/<cell>.json``; each per-layer metric is the reader
``perfbench/metrics/<metric>.py``.  A later change adds a configuration,
a mix, a cell or a metric by adding files and entries.

A run: set-up (load, build, warm every shape of the cell), the measured
window, the traced stretch with ``--trace 1``, the peak of device memory,
the program's state freed, then the comparison with the plain reference.
The last line of standard output is the result, in the contract's shape.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "spef_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, its files' contents, the run's
    arguments, the device, the tracer and the clock of the process's start."""

    root: str
    cell: Dict[str, Any]
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    backend: str
    t_start: float
    tracer: Any = None
    sizes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fault: Optional[Callable] = None

    def size(self, key: str, default):
        """A size of the cell, or the smaller one a CPU test asks for."""
        return self.sizes.get(key, default)

    def mark(self, what: str) -> None:
        """A set-up phase's end, on standard error, in seconds from the start."""
        print(f"[perfbench] {what}: {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr,
              flush=True)


@dataclasses.dataclass
class Run:
    """What a driver hands back: its end-to-end numbers, the requests (or
    steps) attempted and failed, the comparison with the reference (every
    number it reckons, by name), and how to free the program's state
    before it."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    check: Callable[[], Dict[str, float]]
    free: Callable[[], None]


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def cell_files(root: str, workload: str):
    """(bench, cell, config, traffic, limits) of a cell named in
    ``BENCHMARK.json`` under ``root``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no cell {workload!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{workload}.json"))
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    unknown = sorted(set(traffic) - set(driver.KEYS) - {"driver"})
    if unknown:
        raise ValueError(f"traffic {cell['traffic']!r}: the {traffic['driver']} driver reads no "
                         f"{unknown}")
    return bench, cell, cfg, traffic, limits


def cell_metrics(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics the cell reports: its end-to-end ones untraced, its
    per-layer ones traced (a metric with ``workloads`` where they name the
    cell; without, where the cell reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def load_reader(name: str):
    """The reader module of a per-layer metric, by its file name."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loaded_forbidden() -> List[str]:
    """Top-level names in ``sys.modules`` among the forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             backend: str = "cuda", t_start: Optional[float] = None,
             sizes: Optional[Dict] = None, fault: Optional[Callable] = None) -> Dict[str, Any]:
    """Run one cell and return its result (not yet printed): the contract's
    keys, ``numbers`` (every number the comparison reckons), and ``checks``
    (name -> value and limit, of the numbers the cell's limits name) last."""
    import torch

    from perfbench.trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg, traffic, limits = cell_files(root, workload)
    device = torch.device(device)
    ctx = Context(root=root, cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=seed,
                  seconds=seconds, trace=trace, device=device, backend=backend,
                  t_start=t_start, tracer=Tracer(trace, device), sizes=sizes or {},
                  fault=fault)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    run = driver.run(ctx)  # set-up, window, traced stretch
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run.free()  # the program's state, before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = run.check()
    # A number the comparison could not reckon (no answer came) fails.
    checks = {k: (numbers.get(k), lim) for k, lim in limits.items()}
    correct = all(v is not None and v <= lim for v, lim in checks.values())
    metrics: Dict[str, Dict[str, Any]] = {}
    summary = ctx.tracer.summary
    for m in cell_metrics(bench, workload, trace):
        if trace:
            value = load_reader(m["name"]).read(summary, ctx) if summary else None
        else:
            value = run.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
           "power_limit": power_limit() if device.type == "cuda" else None}
    result: Dict[str, Any] = {"correct": correct, "attempted": run.attempted,
                              "failed": run.failed if correct else max(run.failed, 1),
                              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
    result["numbers"] = numbers
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv: List[str], t_start: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.getcwd()
    cell = cell_files(root, args.workload)[1]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell {args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=t_start)
    result.pop("numbers")
    found = loaded_forbidden()
    if found:
        print(f"the process loaded {found}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
