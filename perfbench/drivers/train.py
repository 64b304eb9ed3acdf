"""Training traffic: the recipe's train-phase batch loop over a
device-resident split, as ``Trainer.fit`` runs it.

The mix's file gives the batch, the split's size and the augmentation
(``KEYS``; a mix with another key is refused).  The split (uint8 frames
and poses from the recipe's ranges) is made on the device from the seed,
and reshuffled every pass.  A step: the batch gathered and scaled to
[0, 1], ``data/augment.py::train_augment``, the soft-class targets,
``train/step.py::train_update`` (forward, loss, backward, Adam), the
per-step metrics (``Trainer``'s masked ESA, whose decode syncs the host),
and the metrics read back every ``flush_every`` steps.  Every random draw
of the program comes from one generator.

Set-up builds the model (the trained checkpoint, read by the benchmark and
loaded into the port's model: training resumed from it) and its optimizer
once, and drives it through its first steps on the window's own call and
feed; the window takes over the same object.  ``train_fps``: frames
stepped over the window's seconds, to the last step's end.

The comparison, in two parts.  The start: the reference's three steps
from the same weights, on the same rows and draws: each step's loss, the
first step's log-PDFs, each leaf's first gradient norm (the program's
from Adam's first moment after one step) and each leaf's change after
three steps (read before the fourth).  A step inside the window, drawn
from the seed: the program's trainable leaves, BatchNorm running
statistics, Adam's moments and the generator's state are copied before
it and after it, and the reference takes that one step from the copy
before, on the same rows and draws: its loss, each leaf's change, each
running statistic's change and each leaf's second moment after it.  (The
reference follows the program there from the program's own state: the
bf16 program and the float32 reference part ways over tens of steps.)
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import frames
from perfbench.harness import Run

KEYS = ("batch", "split_frames", "z_range", "xy_over_z", "min_visible", "rot_augment",
        "other_augment", "flush_every", "checked_steps", "warmup_steps", "trace_after_steps",
        "trace_steps", "window_step_range")


def _program(ctx, leaves):
    """(state, utils, loss, camera) of the port for the configuration."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import Camera
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state

    ctx.mark("program imported")
    cfg, dev = ctx.cfg, ctx.device
    camera = Camera(**cfg["camera"])
    utils = SPEUtils.create(
        camera, ori_mode=cfg["ori_mode"], n_ori_bins_per_dim=cfg["ori_bins_per_dim"],
        ori_smooth_factor=cfg["ori_smooth_factor"],
        ori_delete_unused_bins=cfg["ori_delete_unused_bins"], pos_mode=cfg["pos_mode"],
        n_pos_bins_per_dim=cfg["pos_bins_per_dim"], pos_smooth_factor=cfg["pos_smooth_factor"],
        device=dev)
    model = import_model(cfg["backbone"], cfg["head"], residual=cfg["residual"],
                         ori_mode=cfg["ori_mode"], n_ori_bins=cfg["n_ori_bins"],
                         pos_mode=cfg["pos_mode"], n_pos_bins=cfg["n_pos_bins"],
                         img_size=tuple(cfg["img_size"]), device=dev)
    ctx.mark("model built")
    missing, unexpected = model.load_state_dict(leaves, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise ValueError(f"the checkpoint does not fit the model: {missing} {unexpected}")
    tr = cfg["train"]
    opt, sched = import_optimizer(model.parameters(), tr["lr"], tr["optimizer"],
                                  weight_decay=tr["weight_decay"])
    return create_train_state(model, opt, sched), utils, SPELoss(cfg["ori_mode"],
                                                                 cfg["pos_mode"]), camera


def make_data(ctx):
    """(split (n, H, W, 3) uint8, ori, pos, rows): the device-resident split
    and its poses from the seed, and ``rows(i)``, step ``i``'s rows of a
    permutation drawn anew every pass."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    batch = ctx.size("batch", tr["batch"])
    n = ctx.size("split_frames", tr["split_frames"])
    h, w = ctx.size("img_size", cfg["img_size"])
    data_gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    split = torch.randint(0, 256, (n, h, w, 3), generator=data_gen, device=dev,
                          dtype=torch.uint8)
    ori, pos = frames.sample_poses(data_gen, n, cfg["camera"], tuple(tr["z_range"]),
                                   tr["xy_over_z"], tr["min_visible"])
    steps_per_pass = n // batch
    order: Dict[str, torch.Tensor] = {}

    def rows(i: int) -> torch.Tensor:
        if i % steps_per_pass == 0:
            order["perm"] = torch.randperm(n, generator=data_gen, device=dev)
        j = i % steps_per_pass
        return order["perm"][j * batch:(j + 1) * batch]

    return split, ori, pos, rows


def checked_batches(ctx):
    """The checked steps' rows (uint8 frames, ori, pos) and the next
    step's, on the host."""
    split, ori, pos, rows = make_data(ctx)
    out = []
    for i in range(ctx.traffic["checked_steps"] + 1):
        idx = rows(i)
        out.append(tuple(t[idx].cpu() for t in (split, ori, pos)))
    return out


def run(ctx) -> Run:
    from spef_tpu_torch.data.augment import train_augment
    from spef_tpu_torch.train.step import train_update
    from spef_tpu_torch.train.trainer import _masked_metrics

    from perfbench.reference import model, weights

    cfg, tr, dev, span = ctx.cfg, ctx.traffic, ctx.device, ctx.tracer.span
    batch = ctx.size("batch", tr["batch"])

    split, ori_all, pos_all, rows = make_data(ctx)
    ctx.mark("split made")
    leaves = model.from_flax(weights.flax_tree(ctx.root, cfg["weights"]), dev)
    state, utils, loss_fn, camera = _program(ctx, leaves)
    del leaves
    program = {"state": state, "split": split}
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 2)  # the program's draws
    t255 = torch.tensor(255.0, device=dev)
    mask = torch.ones(batch, device=dev)
    ctx.mark("program built")

    pending: List[Dict[str, torch.Tensor]] = []

    def flush() -> None:
        if pending:
            values = torch.stack([torch.stack([m[k].float() for k in sorted(m)])
                                  for m in pending]).cpu().numpy()
            if not np.all(np.isfinite(values)):
                raise ValueError("non-finite loss or metric")
            pending.clear()

    def step(idx: torch.Tensor, fault=ctx.fault):
        st = program["state"]
        with span("feed"):
            images = program["split"][idx].float() / t255
            ori, pos = ori_all[idx], pos_all[idx]
        with span("augment"):
            images, ori, pos = train_augment(gen, images, ori, pos, camera,
                                             tr["rot_augment"], tr["other_augment"])
        with span("encode"):
            targets = utils.encode_targets(ori, pos)
        with span("step"):
            update = fault(train_update) if fault is not None else train_update
            loss, pose = update(st, images, targets, utils, loss_fn, gen,
                                cfg["train"]["clip_batchnorm"])
        with span("metrics"):
            metrics = {"loss": loss, **_masked_metrics(utils, pose, targets, mask)}
        pending.append(metrics)
        if len(pending) >= tr["flush_every"]:
            flush()
        return loss, pose

    # Set-up: the first steps, on the window's call and feed; the reference
    # follows the checked ones.
    params = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    checked = tr["checked_steps"]
    batches, losses, first_grad, change, first_pdfs = [], [], {}, {}, {}
    for i in range(max(tr["warmup_steps"], checked)):
        idx = rows(i)
        if i < checked:
            batches.append(tuple(t[idx].cpu() for t in (split, ori_all, pos_all)))
        loss, pose = step(idx)
        if i < checked:
            losses.append(float(loss))
        if i == 0:
            first_pdfs = {k: pose[k].float().cpu() for k in ("ori_soft", "pos_soft")}
            b1 = cfg["train"]["betas"][0]
            first_grad = {k: v / (1 - b1) for k, v in program_state(state)["m"].items()}
        if i == checked - 1:
            change = {k: (p.detach() - start[k]).float().cpu() for k, p in params.items()}
    flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del start, params
    ctx.tracer.prepare()
    ctx.mark("first steps taken")

    lo, hi = ctx.size("window_step_range", tr["window_step_range"])
    checked_in_window = int(np.random.default_rng(ctx.seed).integers(lo, hi))
    window: Dict[str, Dict] = {}
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    t_end = t0 + ctx.seconds
    i = max(tr["warmup_steps"], checked)
    steps = 0
    trace_from, trace_n = tr["trace_after_steps"], tr["trace_steps"]
    while time.perf_counter() < t_end:
        if ctx.trace and steps == trace_from:
            ctx.tracer.start()
        idx = rows(i)
        if steps == checked_in_window:  # one step's copies to the host, a few ms
            window["before"] = dict(program_state(state), gen=gen.get_state(),
                                    batch=tuple(t[idx].cpu() for t in (split, ori_all, pos_all)))
            loss = float(step(idx)[0])
            window["after"] = dict(program_state(state), loss=loss)
        else:
            step(idx)
        i += 1
        steps += 1
        if ctx.trace and steps == trace_from + trace_n:
            ctx.tracer.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_stop = time.perf_counter()
    if ctx.tracer.active:
        ctx.tracer.stop()
    flush()
    end_to_end = {"setup_s": setup_s, "train_fps": steps * batch / (t_stop - t0)}
    ctx.mark(f"window done; {steps} steps")

    def check() -> Dict[str, float]:
        return compare(ctx, batches, losses, first_grad, change, first_pdfs, window)

    return Run(end_to_end=end_to_end, attempted=steps, failed=0, check=check,
               free=program.clear)


def program_state(state) -> Dict[str, object]:
    """Copies of the program's trainable leaves, BatchNorm running
    statistics and Adam's moments (zero for a leaf it has not stepped), and
    the steps Adam has taken; float32, on the host."""
    model, opt = state.model, state.optimizer
    params = dict(model.named_parameters())

    def copy(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32, copy=True)

    def moment(p, key):
        return copy(opt.state[p][key]) if p in opt.state else copy(torch.zeros_like(p))

    steps = [int(s["step"]) for s in opt.state.values()]
    return {"params": {k: copy(p) for k, p in params.items()},
            "stats": {k: copy(b) for k, b in model.named_buffers() if ".running_" in k},
            "m": {k: moment(p, "exp_avg") for k, p in params.items()},
            "v": {k: moment(p, "exp_avg_sq") for k, p in params.items()},
            "t": max(steps, default=0)}


def reference_steps(ctx, batches, lowp=None, gen_state=None, start=None) -> Dict[str, object]:
    """The reference's steps on ``batches``, on the device: from the
    checkpoint and the run's draws, or from ``start`` (a ``program_state``)
    and the generator's state ``gen_state``; with its state and the
    generator's after them (``state``, ``gen_state``)."""
    from perfbench.reference import model, train, weights

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    if tr["rot_augment"] or not tr["other_augment"]:
        raise ValueError("the reference augments as the recipe does: colour and blur, no rotation")
    gen = torch.Generator(device=dev)
    if gen_state is None:
        gen.manual_seed(ctx.seed + 2)
    else:
        gen.set_state(gen_state)
    on_dev = [tuple(t.to(dev) for t in b) for b in batches]
    if start is None:
        tree = model.from_flax(weights.flax_tree(ctx.root, cfg["weights"]), dev)
        leaves = model.trainable(cfg, tree)
        stats = {k: v for k, v in tree.items() if ".running_" in k}
        adam = None
    else:
        leaves = {k: v.to(dev) for k, v in start["params"].items()}
        stats = {k: v.to(dev) for k, v in start["stats"].items()}
        adam = {"m": {k: v.to(dev) for k, v in start["m"].items()},
                "v": {k: v.to(dev) for k, v in start["v"].items()}, "t": start["t"]}
    out = train.run_steps(cfg, leaves, on_dev, gen, lowp, stats=stats, adam=adam)
    host = {key: {k: t.float().cpu() for k, t in out[key].items()}
            for key in ("first_grad", "change", "first_pdfs", "params", "stats", "m", "v")}
    state = {k: host[k] for k in ("params", "stats", "m", "v")}
    return {"losses": out["losses"], **host, "state": dict(state, t=out["t"]),
            "gen_state": gen.get_state()}


def _median_gap(mine: Dict[str, torch.Tensor], theirs: Dict[str, torch.Tensor], keys) -> float:
    """The median leaf's gap of norms, each leaf against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    norms = {k: float(theirs[k].norm()) for k in keys}
    med = float(np.median(list(norms.values())))
    return float(np.median([abs(float(mine[k].norm()) - n) / max(n, med)
                            for k, n in norms.items()]))


def _moved(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others move under Adam by round-off alone."""
    g_norm = {k: float(g.norm()) for k, g in first_grad.items()}
    g_med = float(np.median(list(g_norm.values())))
    return [k for k in g_norm if g_norm[k] >= 1e-3 * g_med]


def gaps(ref: Dict, losses, first_grad, change, first_pdfs) -> Dict[str, float]:
    """The start's numbers: the widest relative loss gap over the steps;
    the widest gap of the first step's log-PDFs (the train-mode forward's
    activated outputs, over bins the reference gives 1e-6 or more); and the
    median leaf's gap of the first gradient's norm and of the change's norm
    (the change over the leaves that move, ``_moved``)."""
    out = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))}
    out["logpdf_step1"] = max(
        float((torch.log(torch.clamp(first_pdfs[k].double(), min=1e-30))
               - torch.log(ref["first_pdfs"][k].double())).abs()[ref["first_pdfs"][k] >= 1e-6].max())
        for k in ("ori_soft", "pos_soft"))
    out["grad_gap_median"] = _median_gap(first_grad, ref["first_grad"], list(ref["first_grad"]))
    out["change_gap_median"] = _median_gap(change, ref["change"], _moved(ref["first_grad"]))
    return out


def window_gaps(ref: Dict, before: Dict, after: Dict) -> Dict[str, float]:
    """The window step's numbers, the reference having taken it from
    ``before``: the relative loss gap; the median leaf's gap of the change's
    norm (over the leaves that move), of each running statistic's change
    and of each leaf's second moment after the step."""
    loss = float(after["loss"])
    mine_change = {k: after["params"][k] - before["params"][k] for k in before["params"]}
    mine_stats = {k: after["stats"][k] - before["stats"][k] for k in before["stats"]}
    ref_stats = {k: ref["stats"][k] - before["stats"][k] for k in before["stats"]}
    return {"window_loss_rel": abs(loss - ref["losses"][0]) / abs(ref["losses"][0]),
            "window_change_gap_median": _median_gap(mine_change, ref["change"],
                                                    _moved(ref["first_grad"])),
            "window_stats_gap_median": _median_gap(mine_stats, ref_stats, list(ref_stats)),
            "window_v_gap_median": _median_gap(after["v"], ref["v"], list(ref["v"]))}


def compare(ctx, batches, losses, first_grad, change, first_pdfs, window) -> Dict[str, float]:
    """Every number of the start and of the window step (none of the
    window step where the window closed before it)."""
    found = gaps(reference_steps(ctx, batches), losses, first_grad, change, first_pdfs)
    if window:
        before = window["before"]
        ref = reference_steps(ctx, [before["batch"]], gen_state=before["gen"], start=before)
        found.update(window_gaps(ref, before, window["after"]))
    return found
