#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``spef_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with one CUDA card and the CUDA toolkit
(``nvcc``); phase 17 serves over every visible card, and on two or more also
launches the kernels off the current card.  Phase 17 alone, on a host with
several cards:

    python3 -c "import torch, numpy as np, chip_smoke as cs; \
        f = np.random.RandomState(0).randint(0, 256, (cs.BATCH, 240, 384, 3), np.uint8); \
        cs.phase_sharded(torch, np, f, cs.phase_card_and_build())"

It imports nothing of JAX and nothing of ``spef_tpu``.  Phases, each printed
on its own lines; any failure exits nonzero:

  1. the card (``nvidia-smi`` name and power limit) and the kernel build:
     every ``spef_tpu_torch/csrc/*.cu`` compiled by ``nvcc`` for ``sm_90a``,
     one process per source, all at once;
  2. every K1 variant (with the flagship's largest expand, block 1's
     bits -> float32 at M = 5,898,240, block 0's projection, and the int8
     carry's division, shifted emit and residual) and K2 mode (with the
     carry's ``-128`` halo, division and shifted emit), K3 with a signed
     and a bits output and K4 over its options (no expand, both residual
     cases, stride 2 at even and odd height, hidden / depthwise grid on and
     off, uint8-bits input, Cin padded to the mma depth, exact sums), each
     against its plain PyTorch version at flagship layer shapes.
     Mismatches must be 0 wherever the sums are integers.
     Where they are not (K1 with bf16 input, K4 with a real-valued
     depthwise output) the tensor cores' order may move an output by one
     step where the value rounded last sits on a tie
     (``int8_matmul_requant_rounding_input``, ``fused_mbconv_rounding_input``;
     up to ceil(ratio) steps where a residual sum is requantized by a ratio
     above 1, which no flagship layer does); such mismatches are counted and
     printed with the largest of them, any other, or a share above
     ``TIE_SHARE``, fails;
  3. the float flagship (``exp_dspeed_synth``, MobileNetV2 + URSONet,
     240x384) served through ``spef_tpu_torch.apps.serve``: requests of
     256, 37 (padded) and 1 frames; the host-to-device copy and the predict
     function timed apart; checked against the float32 model on the CPU;
  4. the boundary-recipe int8 flagship (the committed asset graph) served on
     the kernels: the launch counters are set to 0 before it is driven and
     must read 34 K1 and 17 K2 launches a forward after it; the copy, the
     predict function and the int8 forward alone timed apart; the kernels'
     logits within 0.3 of the plain backend's on the card (K1's ties at
     the projections), the distance printed, and within 0.3 of the plain
     backend on the CPU;
  5. the same int8 graph served by the fused executor
     (``--int8-executor fused``): counters to 0, then 1 K3, 17 K4 and 1 K1
     launch a forward; the copy, the predict function and the fused forward
     alone timed apart; logits within 0.3 of the plain backend's on the card
     (K4's tie rule), the distance printed; the distance of its logits and
     poses from the layer executor's printed;
  6. the int8 build chain at full width: the flagship's float checkpoint
     into its boundary-recipe QAT twin (``copy_params``), converted
     (``convert_qat_params``) and calibrated on the card (``calibrate_graph``
     on the 32 frames ``render_frame`` gives for seed 0, in the dataset's
     channel order, batches of 8); the
     graph held against the committed asset (structure, ``w_int``, qmax,
     strides, ``mult_core`` and ``bias`` identical; every step within one
     histogram bin, the largest difference printed);
  7. that graph written out as a QAT experiment (``config.yaml``,
     ``save_model`` with the calibrated scales, ``int8_graph.pkl``) and
     served: the engine's variants (the QAT model's forward, ``weight-only``,
     ``int8-carry``) and ``apps.serve --int8-executor carry`` at serve
     windows of 256 and 1, the counters set to 0 before each and read after
     (34 K1 and 17 K2 launches a carry forward, none for the other two);
     request p50 of 8 (host clock), frames/s, the carry forward alone (CUDA
     events); its logits within 0.3 of the plain backend's and of the
     ``layer`` executor's on the same graph, its distances from
     ``int8_forward`` and the QAT forward printed;
  8. accuracy on the flagship's valid and test splits: the 2,000 + 2,000
     D-SPEED frames (240x384, seed 1001) written by the port's writer
     (``data/synthetic.py::_create_eval_splits``: the 20,000 train frames'
     draws replayed once, then the valid and test frames rendered and
     written as PNG by worker processes) into ``build/`` and removed at the
     end, with the seconds this takes; the float flagship evaluated by
     ``python -m spef_tpu_torch.apps.eval`` on each (its test ESA within
     0.002 of the recorded ``eval_score_error.json``, its valid ESA within
     0.003 of the recorded ``score_error.json``, 0.12932); the committed int8 graph evaluated on the same loader batches by the
     ``layer``, ``fused`` and ``carry`` executors on the kernels, the
     counters set to 0 before each and read after (per-forward launches
     times the batches); the carry's ESA within 0.003 of JAX's
     ``int8_carry`` on the same graph and frames
     (``spef_tpu_torch/assets/flagship_test_esa.json``), ``layer``'s and
     ``fused``'s within 0.01 of the carry's; the per-frame pose distances
     between executors (mean, p99, max, in degrees and metres); each
     executor's kernels within 0.3 logit of its plain backend on the first
     256 test frames; the seconds of each step and the PNG decode time a
     frame; after phase 12, ``bench.py``'s construction once (a random-init ``_q``
     model at 256x256, boundary recipe, carry + decode, batch 256), its
     frames/s printed;
  9. each kernel at its path's own inputs (batch 256): mismatches (K1's
     bf16-input calls and K4 under the tie rule, at most one step; any
     mismatch of an integer-input call fails), kernel / plain / library time
     (CUDA events) and its bound, printed as one ``{"kernels": [...]}`` JSON
     line of four entries; K1's one call on the fused path (the head conv)
     is timed apart, and K1's and K2's calls on the carry path;
 10. training, the flagship at full width (``mobilenet_v2`` + URSONet,
     1232 + 1000 bins, batch 64, 240x384, Adam): a D-SPEED still set of 512
     + 128 + 128 frames written into ``build/``; a parity gate (one SGD
     step from the flagship checkpoint on the first 64 train frames, one
     dropout mask for both sides, bf16 on the card against float32 on the
     CPU: loss within 1%, the cosine of the two parameter updates at least
     0.99, BN running statistics within 1e-2); a learning gate (40 Adam
     steps from a fresh init on one batch: the loss above the targets'
     entropy at most halves); ``python -m spef_tpu_torch.apps.train`` on the
     flagship's config for 2 epochs (streaming loader, checkpoints, the
     device augmentation), resumed for a third from device-resident data
     (the split decoded in that epoch), a fourth from RAM and a fifth from
     the card, both from the sidecar the third wrote; its per-epoch step ms
     p50 (CUDA events), frames/s, step share of the epoch, augmentation ms
     and peak memory printed, its final ESAs, and the trained experiment
     served for one batch by ``apps.serve``;
 11. the deployment build on that set: ``python -m
     spef_tpu_torch.apps.build_int8 --recipe boundary --autotune`` from the
     flagship's float checkpoint, calibrated on the train batches, one QAT
     epoch (8 steps of ``mobilenet_v2_q``) on device-resident data; the ladder's
     ESAs (``qat``, ``int8``, ``weight_only``) and the parity report; int8
     within 0.05 of float's ESA on the same frames; the written
     ``int8_graph.pkl`` served by ``apps.serve --int8-executor carry`` and
     ``layer`` on K1/K2 (launches counted), within 0.3 logit of its plain
     backend on 64 frames; the set removed;
 12. the keypoints family, on phase 8's test split (written before phase 8
     and removed after this one): (a) the decoder alone, EPnP, RANSAC and
     RANSAC + border gate 0.02 on JAX's keypoints of the first 256 test
     frames (``assets/keypoints_decode_ref.npz``), each frame's pose
     distance from JAX's printed, median at most 0.01 deg and at most 4%
     (EPnP) or 20% (RANSAC) of the frames beyond 1 deg, about twice the
     port's shares on the CPU; (b) the six rows of
     ``assets/keypoints_test_esa.json`` on the 2,000 frames (the heatmap
     model by EPnP, RANSAC and gated RANSAC, the regression model by EPnP,
     the registry's two-pass pair by RANSAC through ``python -m
     spef_tpu_torch.apps.eval --ransac --crop-refine``, and its
     ``crop-refine-w8`` engine variant), each test ESA within 0.01 of JAX's
     on the same frames, the TPU-era recorded ESAs printed beside them; the
     launch counters read 0 (no hand kernel on this path); (c) CUDA-event
     times at batches 1 and 256 of the coarse forward, the EPnP and RANSAC
     decodes, ``crop_resize``, the fine forward and the two-pass predict,
     the kernels each decode launches (``torch.profiler``) and its host
     synchronizations (``torch.cuda.set_sync_debug_mode("warn")``), and
     request p50 through ``PoseServer`` for the two-pass pipeline at serve
     windows 1 and 64;
 13. temporal (video) evaluation: the 11 D-SPEED video scenarios, their
     first 300 frames at 240x384 (3,300 frames), written into ``build/`` by
     ``python -m spef_tpu_torch.apps.create_dspeed --skip-still --render``
     in worker processes and removed at the end, each scenario's frames
     hashing to what ``assets/temporal_esa.json`` (JAX on the CPU) was
     measured on; (a) the float flagship through ``python -m
     spef_tpu_torch.apps.temporal_eval``, serial and ``--batch-sequences``:
     each scenario's still and video ESA within 0.005 of JAX's and their
     means within 0.002, the two modes within 1e-4 relative + 1e-5 of each
     other, ``ACCURACY.md``'s TPU-era row printed beside each; (b) the
     committed int8 graph on the ``fused`` executor through
     ``multi_sequence_inference`` (counters 0 before, 52 forwards' launches
     after), each video ESA within 0.01 of JAX's ``int8_carry``; (c) one
     scenario streamed frame by frame through ``Inference.predict(frame,
     "Adaptative")`` on the ``carry`` executor (34 K1 and 17 K2 launches a
     frame), its video ESA within 0.003 of JAX's ``int8_carry``, its
     filtered PDFs within 1e-5 of ``scan_filter`` over the PDFs it was fed;
     (d) the app's wall time and frames/s in both modes, streaming p50 / p95
     a frame for the float flagship and the carry (host clock), forward
     chunks, ``scan_filter`` a sequence with its kernels a step
     (``torch.profiler``) and host syncs, decode and continuity (CUDA
     events); the ``kernels`` line's ``launches_temporal_path``;
 14. deploy and serve, after phase 12 while phase 8's test split is on disk:
     (a) ``python -m spef_tpu_torch.apps.export`` (its ``main``) of the float
     flagship and, on a temporary experiment (the flagship's config,
     ``model/`` linked, the committed asset as ``int8_graph.pkl``), of
     ``--int8`` and ``--int8 --weight-only``, at batch 256 on the card
     (``torch.export``; the export path reaches no hand kernel); (b) each
     ``.spef`` served in a fresh process by ``python -m
     spef_tpu_torch.apps.serve --artifact ... --frames-dir`` on the first
     256 test frames, its printed poses held to the artifact loaded here at
     print precision, and the loaded artifact to the live engine on the same
     frames (float: log-PDFs within 1e-3, poses within 0.01 deg and 1e-3 m;
     int8 and weight-only: log-PDFs within 1e-5), each artifact's size and
     load time; (c) ``serving.serve_stream`` at depth 2 (pinned ring, copy
     stream) on the ``fused`` and ``carry`` executors and on the ``fused``
     forward alone (no decode), over 16 distinct batches of 256 frames,
     counters 0 before and read after (16 forwards' launches), each result
     in order bit for bit ``PoseServer.predict``'s, frames/s streamed
     against sequential and against the same ring staged in the caller's
     thread (no staging thread; in turns), the host synchronizations of one
     predict; (d) the 70.8 MB batch's copy to the card, pageable against
     pinned (CUDA events), and request p50 / p95 at windows 1 and 256 for
     float and ``fused`` through ``PoseServer``'s pinned staging and
     through a pageable copy, in turns; (e) ``python -m
     spef_tpu_torch.apps.benchmark`` (its ``main``) on every path at batch
     64, 240x384, its JSON printed, the ``int8_cuda`` path's launches
     counted (34 K1 and 17 K2 a forward), then every K1 and K2 call of one
     ``int8_cuda`` forward on the benchmark's own graph (default bit widths)
     and batch held against its plain version by ``check_call``, and the
     forward's logits against the plain backend's (0.3); (f)
     ``apps.nn_stats`` on the flagship's shape, its totals; the ``kernels``
     line's ``launches_deploy_path`` and ``deploy_path_check``;
 15. the host data path, while phase 10's set is on disk: first a line that
     names what the native JPEG / PNG loader (``spef_tpu_torch.native``)
     lacks on this host, if anything; (a) the committed JPEG frames
     (``assets/speed_jpeg/``, 8 at SPEED's 1920x1200, their sha256 held to
     ``assets/speed_jpeg_ref.json``): where the loader builds, decoded at
     240x384 and held to JAX's decoded batch (``speed_jpeg_ref.npz``; the
     mismatch count printed, both libjpeg versions where it is not 0), its
     resize held to the numpy twin, and ``apps.serve --frames-dir`` run on
     them (float and ``fused``); where it does not, nothing decodes the
     JPEGs and the reference's decoded batch is served instead; the float
     flagship's poses within phase 3's gates of JAX's float32 ones (the
     float32 model on the card: soft PDFs within 1e-4, positions 1e-3 m;
     the served bf16 model: 10 deg, 0.5 m); the ``fused`` executor's poses
     against them printed (int8 against float: not gated), its logits
     within 0.3 of its plain backend, its kernels (K3, K4, K1) at this
     batch held against their plain versions, its launches counted; (b)
     the decoder the loaders chose here (phase 8's split went through it);
     (c) ``python -m spef_tpu_torch.apps.train`` with the flagship's config
     as it is (``ROT_AUGMENT`` on, no ``--device-augment``: the host warp
     in the loader, ``native/warp.cpp`` where g++ is present), one epoch at
     batch 64: step ms p50, frames/s against phase 10's device
     augmentation, the host warp's ms a frame (in the loader's threads, and
     alone on one thread); then one
     step with and without ``--data-parallel`` (world size 1, cuDNN
     deterministic): the two written checkpoints identical, byte for byte;
     (d) the host synchronizations of one ``predict`` (one: the decode's
     ``eigh``), and the weight-only forward (bf16 products with float32
     sums) on the card against the CPU's within 0.3 logit; the ``kernels``
     line's ``launches_host_path`` and ``host_path_check``;
 16. the viewer, the GUI and the autotuner, while phase 10's set and phase
     11's experiment (``int8_graph.pkl``) are on disk; phase 11 itself ran
     ``apps.build_int8 --autotune`` (its winners in a table of its own, its
     ``autotune_report.json`` checked and summarized): (a) ``python -m
     spef_tpu_torch.apps.viewer --n 16 --video`` (its ``main``) on the
     ``float`` and ``int8-carry`` engines, counters 0 before and read after
     (none on float, 34 K1 and 17 K2 a frame on the carry), the frames
     written, each engine's per-frame ESA and latency, one frame redrawn on
     the CPU from the poses it drew and held equal to its PNG, the carry's
     K1 / K2 calls on one frame held against the plain versions; (b)
     ``apps.gui``'s ``make_server`` on an ephemeral port in a thread:
     ``GET /``, ``/api/state``, ``/api/select`` of ``int8-carry``, eight
     ``/api/frame`` calls with the temporal filter on (counters read), a
     reset; each PNG decoded, the metrics and the p50 latency; (c)
     ``quant.autotune.tune_graph`` on the committed flagship graph at batch
     256 into a table of this run's own (no later phase reads it): each
     node's default and best ms, speedup, library-form ms and backend; the
     forward all-fused at the cost model's tiles, all-fused at the tuned
     tiles and on ``plan_backends``' plan, each held against the plain
     backend (every kernel call by ``check_call``, every kernel the plan
     launches called at least once, logits within 0.3),
     launches counted, timed by CUDA events; the tuned tiles' K4 outputs
     against the default tiles'; the ``kernels`` line's
     ``launches_viewer_gui_tuner_path`` and ``viewer_gui_tuner_path_check``;
 17. inference sharded over every visible card (the driver's machine has
     one, so there the mesh is that card): each executor (float, ``layer``,
     ``fused``, ``carry`` on the committed asset, the two-pass crop-refine
     pair by RANSAC) served by ``apps.serve --device cuda``
     (``PoseServer`` over ``make_local_mesh("cuda")``: one replica a card
     runs the forward on its rows, one decode of the gathered window on the
     first card) against ``--device cuda:0``, the counters 0 before and
     read after, in all and card by card (``launches_by_card``: the
     per-forward launches on every card, each request); requests of 256
     and of 10 (padded) compared: for the int8 executors the served logits
     (each request's own) and then every output bit for bit, a difference
     admitted only as the ties of a card whose kernel calls meet their
     contract; log-PDFs within 1e-3 for float, keypoints within 1e-3 for
     crop-refine, quaternions up to sign (largest angle printed); frames/s,
     request p50, the predict and its two stages (forwards, decode) over
     the cards against one card, and how far the cards' forwards overlap
     (1: all at once, 0: one after another); (d) the same numbers for
     ``fused`` and crop-refine at a window of 1,024; on two or more cards
     first (a): one forward of ``layer`` and of ``fused`` built on the last card
     while ``cuda:0`` is current, every K1-K4 call held to its plain
     version; the ``kernels`` line's ``launches_sharded_path`` (all
     cards', and each card's as counted) and ``sharded_path_check``;
 18. the last line: ``{"ok": true, "device": {...}}``.

It exits nonzero, printing no result, where ``torch.cuda.is_available()`` is
false or the package is missing.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")
BATCH = 256

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

KERNELS = {
    "int8_matmul_requant": {
        "source": "spef_tpu_torch/csrc/int8_matmul_requant.cu",
        "replaces": "spef_tpu/ops/pallas/int8_ops.py:117",
    },
    "int8_depthwise3x3": {
        "source": "spef_tpu_torch/csrc/int8_depthwise3x3.cu",
        "replaces": "spef_tpu/ops/pallas/int8_ops.py:252",
    },
    "fused_stem": {
        "source": "spef_tpu_torch/csrc/fused_stem.cu",
        "replaces": "spef_tpu/ops/pallas/fused_block.py:980",
    },
    "fused_mbconv": {
        "source": "spef_tpu_torch/csrc/fused_mbconv.cu",
        "replaces": "spef_tpu/ops/pallas/fused_block.py:633",
    },
}
# Kernels redesigned for Hopper after their first port.
REDESIGNED = ("int8_depthwise3x3", "fused_mbconv", "int8_matmul_requant", "fused_stem")
# The most of a call's outputs that may sit on a tie and differ from the
# plain version (K1 with bf16 input, K4 with a real-valued depthwise output).
TIE_SHARE = 0.005
# What one forward of each executor launches.
LAYER_LAUNCHES = {"int8_matmul_requant": 34, "int8_depthwise3x3": 17}
CARRY_LAUNCHES = {"int8_matmul_requant": 34, "int8_depthwise3x3": 17}
FUSED_LAUNCHES = {"fused_stem": 1, "fused_mbconv": 17, "int8_matmul_requant": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call from CUDA events around ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def diff(a, b):
    """(mismatching elements, max |a - b|) of two outputs of one kernel."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    d = (a.float() - b.float()).abs()
    bits = a.view(torch.uint8) != b.view(torch.uint8) if a.dtype == torch.int8 else a != b
    return int(bits.sum()), float(d.max()) if d.numel() else 0.0


def check_mm(a, args, kw):
    """K1's output ``a`` against its plain version under K1's contract;
    returns (mismatches, max |a - plain|, steps the rule admits at a tie).
    Integer inputs sum exactly: 0 mismatches.  bf16 input: an int8 output
    may differ only where the tie rule admits it, on at most ``TIE_SHARE``
    of the outputs; a float32 output must lie within the rule's ``eps`` of
    the plain version's.  Raises on anything else."""
    from spef_tpu_torch.ops.int8_ops import (
        int8_matmul_requant_plain, int8_matmul_requant_rounding_input, tie_mismatches)
    import torch

    b = int8_matmul_requant_plain(*args, **kw)
    mis, err = diff(a, b)
    if args[0].dtype != torch.bfloat16:
        if mis:
            raise AssertionError(f"int8_matmul_requant: {mis} mismatches with integer input")
        return 0, err, 0
    v, eps, step = int8_matmul_requant_rounding_input(*args, **kw)
    if _f32_out(kw):
        outside = int(((a.double() - b.double()).abs() > eps).sum())
        if outside:
            raise AssertionError(f"int8_matmul_requant: {outside} float32 outputs further than "
                                 f"eps from the plain version's")
        return mis, err, 0
    mis, refused = tie_mismatches(a, b, v, eps, step)
    if refused or err > step or mis > TIE_SHARE * a.numel():
        raise AssertionError(f"int8_matmul_requant: {mis} mismatches of {a.numel()} outputs, "
                             f"{refused} of them not within {step} step(s) at a tie "
                             f"(max |d| {err})")
    return mis, err, step


def check_mbconv(a, args, kw):
    """K4's output ``a`` against its plain version under K4's contract;
    returns (mismatches, max |a - plain|, steps the rule admits at a tie).
    With the depthwise output on a grid every sum is exact: 0 mismatches.
    Otherwise a mismatch must be one the tie rule admits, and at most
    ``TIE_SHARE`` of the outputs may differ.  The rule admits one int8 step,
    but where a residual sum is requantized by a ratio above 1: there one
    step of the shared grid is up to ceil(ratio) output steps.  The call's
    ``tile`` (the kernel's output tile) has no part in the plain version.
    Raises on anything else."""
    from spef_tpu_torch.ops.fused_block import (
        fused_mbconv_plain, fused_mbconv_rounding_input, tie_mismatches)

    x, wts = args
    kw = {k: v for k, v in kw.items() if k != "tile"}
    b = fused_mbconv_plain(x, wts, **kw)
    mis, err = diff(a, b)
    if kw.get("inv_d") is not None:
        if mis:
            raise AssertionError(f"fused_mbconv: {mis} mismatches with the depthwise output "
                                 f"on a grid")
        return 0, err, 0
    v, eps, step = fused_mbconv_rounding_input(x, wts, **kw)
    mis, refused = tie_mismatches(a, b, v, eps, step)
    if refused or err > step or mis > TIE_SHARE * a.numel():
        raise AssertionError(f"fused_mbconv: {mis} mismatches of {a.numel()} outputs, {refused} "
                             f"of them not within {step} step(s) at a tie (max |d| {err})")
    return mis, err, step


def check_call(name, a, args, kw):
    """One kernel call's output ``a`` against its plain version on the same
    inputs: K2 and K3 exactly, K1 and K4 by ``check_mm`` / ``check_mbconv``,
    with at most one int8 step at a tie (no residual ratio of the flagship's
    graphs is above 1).  Returns (mismatches, max |a - plain|, steps
    admitted at a tie); raises on anything else."""
    from spef_tpu_torch.ops import fused_block, int8_ops

    if name == "fused_mbconv":
        mis, err, step = check_mbconv(a, args, kw)
    elif name == "int8_matmul_requant":
        mis, err, step = check_mm(a, args, kw)
    else:
        ops = fused_block if name == "fused_stem" else int8_ops
        (mis, err), step = diff(a, getattr(ops, name + "_plain")(*args, **kw)), 0
        if mis:
            raise AssertionError(f"{name}: {mis} kernel/plain mismatches")
    if step > 1 or err > 1:
        raise AssertionError(f"{name}: max |kernel - plain| {err} with {step} step(s) "
                             f"admitted; the flagship allows one")
    return mis, err, step


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for one call's work.
# ---------------------------------------------------------------------------


def _f32_out(kw):
    """Whether a K1 call's keyword arguments ask for a float32 output (no
    requant: neither ``out_inv_step`` nor the carry's ``out_step``)."""
    return kw.get("out_inv_step") is None and kw.get("out_step") is None


def mm_bound(args, kw):
    x, w = args[0], args[1]
    m, k = x.shape
    n = w.shape[1]
    out_bytes = 4 if _f32_out(kw) else 1
    nbytes = m * k * x.element_size() + k * n + m * n * out_bytes + 8 * n
    if kw.get("residual") is not None and not _f32_out(kw):
        nbytes += m * n
    ops = 2 * m * n * k
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_OPS_S["bf16" if x.dtype.is_floating_point else "int8"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def dw_bound(args, kw):
    x = args[0]
    b, h, w, c = x.shape
    s = kw.get("stride", 1)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    bf16_out = kw.get("out_inv_step", 1.0) is None and kw.get("out_step") is None
    out_bytes = 2 if bf16_out else 1
    nbytes = x.numel() * x.element_size() + b * ho * wo * c * out_bytes + 9 * c + 8 * c
    ops = 2 * 9 * b * ho * wo * c  # f32 multiply-adds on the CUDA cores
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S["f32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _bound(nbytes, ops_by_rate):
    """(ms, "bytes" | "operations"): bytes at the memory rate against the
    operations, each kind at its own peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = sum(ops / PEAK_OPS_S[rate] for rate, ops in ops_by_rate.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def stem_bound(args, kw):
    x, w = args[0], args[1]
    b, h, wd, _ = x.shape
    cout = w.shape[-1]
    npix = b * ((h - 1) // 2 + 1) * ((wd - 1) // 2 + 1)
    nbytes = x.numel() + npix * cout + w.numel() + 8 * cout
    return _bound(nbytes, {"int8": 2 * 27 * npix * cout})


def mbconv_bound(args, kw):
    """Input and output once as int8 plus the weights; the expand at the int8
    tensor rate, the projection at the int8 rate when the depthwise output
    is on a grid and at the bf16 rate when it is real-valued, the nine taps
    at the float32 rate."""
    x, wts = args
    b, h, wd, cin = x.shape
    ch, cout = wts["w3"].shape
    s = kw.get("stride", 1)
    npix_in, npix_out = b * h * wd, b * ((h - 1) // s + 1) * ((wd - 1) // s + 1)
    operands = ("w1", "m1", "b1", "w2", "m2", "b2", "w3", "m3", "b3")  # not their packed copies
    nbytes = x.numel() + npix_out * cout + sum(
        wts[k].numel() * wts[k].element_size() for k in operands if k in wts)
    ops = {"f32": 2 * 9 * npix_out * ch}
    proj = "int8" if kw.get("inv_d") is not None else "bf16"
    ops[proj] = 2 * npix_out * ch * cout
    if "w1" in wts:
        ops["int8"] = ops.get("int8", 0) + 2 * npix_in * cin * ch
    return _bound(nbytes, ops)


# ---------------------------------------------------------------------------
# Library yardsticks (timed here only; the port never calls them).
# ---------------------------------------------------------------------------


def mm_library(args, kw):
    """bf16 ``torch.matmul`` plus the epilogue as PyTorch ops."""
    import torch

    x, w, mult, bias = args[:4]
    xb = x.to(torch.bfloat16) if not x.dtype.is_floating_point else x
    wb = w.to(torch.bfloat16)
    inv = kw.get("out_inv_step")
    if kw.get("out_step") is not None:
        inv = 1.0 / kw["out_step"]

    def run():
        y = torch.matmul(xb, wb).float() * mult + bias
        if inv is None:
            return y.relu_() if kw.get("relu", True) else y
        return torch.clamp(torch.round(y * inv), kw.get("out_qmin", 0.0),
                           kw.get("out_qmax", 127.0)).to(torch.int8)

    return run


def dw_library(args, kw):
    """bf16 depthwise ``F.conv2d(groups=C)`` on a channels_last view."""
    import torch

    x, w = args[0], args[1]
    c = x.shape[-1]
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # NHWC memory = channels_last
    wb = w.to(torch.bfloat16).permute(2, 0, 1).reshape(c, 1, 3, 3).contiguous(
        memory_format=torch.channels_last)
    s = kw.get("stride", 1)
    return lambda: torch.nn.functional.conv2d(xb, wb, stride=s, padding=1, groups=c)


def stem_library(args, kw):
    """One bf16 ``F.conv2d(stride=2)`` on a channels_last view."""
    import torch

    x, w = args[0], args[1]
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # NHWC memory = channels_last
    wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: torch.nn.functional.conv2d(xb, wb, stride=2, padding=1)


def mbconv_library(args, kw):
    """No single PyTorch call computes a block: the chain of three bf16
    ``F.conv2d`` calls (1x1, depthwise 3x3, 1x1) on channels_last views,
    without the requants between them."""
    import torch

    x, wts = args
    conv2d = torch.nn.functional.conv2d
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)  # noqa: E731
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    ch, cout = wts["w3"].shape
    w1 = cl(wts["w1"].to(torch.bfloat16).t().reshape(ch, -1, 1, 1)) if "w1" in wts else None
    w2 = cl(wts["w2"].to(torch.bfloat16).permute(2, 0, 1).reshape(ch, 1, 3, 3))
    w3 = cl(wts["w3"].to(torch.bfloat16).t().reshape(cout, ch, 1, 1))
    s = kw.get("stride", 1)

    def run():
        h = conv2d(xb, w1) if w1 is not None else xb
        return conv2d(conv2d(h, w2, stride=s, padding=1, groups=ch), w3)

    return run


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card_and_build():
    from spef_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] nvcc {_build.nvcc_path()}: built {built} in "
        f"{time.perf_counter() - t0:.1f} s (sm_90a, one process per source, in parallel)")
    for name, out in _build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return card


def phase_variants(torch, dev):
    """Every K1 variant and K2 mode vs plain at flagship layer shapes."""
    from spef_tpu_torch.ops.int8_ops import (
        int8_depthwise3x3, int8_depthwise3x3_plain, int8_matmul_requant)

    g = torch.Generator().manual_seed(0)
    # block 14 expand / project at batch 256: M = 256*8*12, K/N = 160/960.
    m, k, n = BATCH * 8 * 12, 160, 960
    ints = torch.randint(-16, 16, (m, k), generator=g).to(torch.int8)
    bits = torch.randint(-128, 128, (m, k), generator=g).to(torch.int8)
    real = (torch.rand(m, n, generator=g) * 6).to(torch.bfloat16)
    w_e = torch.randint(-8, 8, (k, n), generator=g).to(torch.int8)
    w_p = torch.randint(-8, 8, (n, k), generator=g).to(torch.int8)
    vec = lambda size, s: (torch.rand(size, generator=g) * s).to(dev)  # noqa: E731
    res = torch.randint(-7, 8, (m, k), generator=g).to(torch.int8).to(dev)
    # Blocks 0 and 1 at 120x192: M = 256*120*192.
    m01 = BATCH * 120 * 192
    cases = {
        "int8_in_int8_out_relu": (ints, w_e, dict(relu=True, out_inv_step=8.0, out_qmax=15.0)),
        "bits_in_bits_out": (bits, w_e, dict(relu=True, out_inv_step=3.0, out_qmax=255.0,
                                             in_unsigned=True, out_bits=True)),
        "int8_in_f32_out": (ints, w_e, dict(relu=True, out_inv_step=None)),
        "bf16_in_int8_out": (real, w_p, dict(relu=False, out_inv_step=2.0, out_qmin=-128.0)),
        "bf16_in_residual": (real, w_p, dict(relu=False, out_inv_step=4.0, out_qmax=7.0,
                                             out_qmin=-8.0, res_ratio=0.75, residual=res)),
        "bf16_in_f32_out": (real, w_p, dict(relu=True, out_inv_step=None)),
        # block 1's expand: uint8 bits in, float32 out (the largest K1 call)
        "block1_expand_bits_in_f32_out": (
            torch.randint(-128, 128, (m01, 16), generator=g).to(torch.int8),
            torch.randint(-8, 8, (16, 96), generator=g).to(torch.int8),
            dict(relu=True, out_inv_step=None, in_unsigned=True)),
        # block 0's projection: bf16 depthwise output in, int8 out
        "block0_project_bf16_in": (
            (torch.rand(m01, 32, generator=g) * 6).to(torch.bfloat16),
            torch.randint(-8, 8, (32, 16), generator=g).to(torch.int8),
            dict(relu=False, out_inv_step=2.0, out_qmin=-128.0)),
        # the int8 carry's conventions: requant by division, a shifted
        # unsigned emit, and the projection's division with a residual
        "carry_int8_in_div_shifted_out": (ints, w_e, dict(
            relu=True, out_inv_step=None, out_step=0.125, out_qmax=255.0, out_zp=128)),
        "carry_int8_in_div_int8_out": (ints, w_e, dict(
            relu=False, out_inv_step=None, out_step=0.5, out_qmin=-128.0)),
        "carry_bf16_in_div": (real, w_p, dict(relu=False, out_inv_step=None, out_step=0.5,
                                              out_qmin=-128.0)),
        "carry_bf16_in_residual_div": (real, w_p, dict(
            relu=False, out_inv_step=None, out_step=0.25, out_qmax=127.0, out_qmin=-128.0,
            res_ratio=1.0, res_qmax=127.0, res_qmin=-128.0, residual=res)),
    }
    for name in list(cases):
        x, w, kw = cases.pop(name)
        nn_ = w.shape[1]
        args = (x.to(dev), w.to(dev), vec(nn_, 1e-2), vec(nn_, 0.1))
        a = int8_matmul_requant(*args, **kw)
        torch.cuda.synchronize()
        mis, err, step = check_mm(a, args, kw)
        rule = f"tie rule, {step} step(s) admitted" if step else (
            "within eps" if x.dtype == torch.bfloat16 else "exact")
        log(f"[variants] K1 {name} M={x.shape[0]} K={x.shape[1]} N={nn_}: {mis} mismatches "
            f"({rule}; share {mis / a.numel():.2e}), max |kernel - plain| {err}")
        del a, args, x
    total = 0
    dw_cases = {
        # block 13 (stride 2, 576 ch at 15x24) and block 14 (stride 1, 960 ch at 8x12)
        "int8_in_int8_out_s1": ((BATCH, 8, 12, 960), 1, "int8", dict(out_inv_step=6.0)),
        "bits_in_bits_out_s2": ((BATCH, 15, 24, 576), 2, "bits",
                                dict(out_inv_step=2.0, out_qmax=255.0, in_unsigned=True,
                                     out_bits=True)),
        "bits_in_bf16_out_s1": ((BATCH, 120, 192, 32), 1, "bits",
                                dict(out_inv_step=None, in_unsigned=True)),
        "f32_in_bf16_out_s2": ((BATCH, 15, 24, 576), 2, "real", dict(out_inv_step=None)),
        "f32_in_int8_out_s1": ((BATCH, 8, 12, 960), 1, "real", dict(out_inv_step=6.0)),
        # blocks 1 and 2 as the boundary recipe runs them: float32 in, bf16 out
        "f32_in_bf16_out_s2_block1": ((BATCH, 120, 192, 96), 2, "real", dict(out_inv_step=None)),
        "f32_in_bf16_out_s1_block2": ((BATCH, 60, 96, 144), 1, "real", dict(out_inv_step=None)),
        # the int8 carry's conventions: a shifted input padded with -128,
        # requant by division, a shifted unsigned emit
        "carry_shifted_in_halo_div_shifted_out_s1": (
            (BATCH, 120, 192, 32), 1, "int8",
            dict(out_inv_step=None, out_step=0.1, out_qmax=255.0, out_zp=128, halo=-128)),
        "carry_shifted_in_halo_div_s2": ((BATCH, 15, 24, 576), 2, "int8",
                                         dict(out_inv_step=None, out_step=0.2, halo=-128)),
        "carry_f32_in_div_shifted_out_s2": ((BATCH, 15, 24, 576), 2, "real", dict(
            out_inv_step=None, out_step=0.1, out_qmax=255.0, out_zp=128)),
    }
    for name, (shape, stride, src, kw) in dw_cases.items():
        if src == "real":
            x = torch.rand(shape, generator=g) * 4
        else:
            x = torch.randint(-128 if src == "bits" else -64, 128 if src == "bits" else 64,
                              shape, generator=g).to(torch.int8)
        c = shape[-1]
        w = torch.randint(-8, 8, (3, 3, c), generator=g).to(torch.int8)
        args = (x.to(dev), w.to(dev), vec(c, 1e-2), vec(c, 0.05))
        kw = dict(kw, stride=stride, in_step=1.0 if src == "real" else 0.05)
        a = int8_depthwise3x3(*args, **kw)
        b = int8_depthwise3x3_plain(*args, **kw)
        torch.cuda.synchronize()
        mis, err = diff(a, b)
        total += mis
        log(f"[variants] K2 {name} {tuple(shape)}: {mis} mismatches, "
            f"max |kernel - plain| {err}")
        del a, b, x, args
    total += _fused_variants(torch, dev, g)
    if total:
        raise AssertionError(f"{total} kernel/plain mismatches across the variants")


def random_mbconv_operands(g, cin, ch, cout, expand=True, hidden_grid=False, dw_grid=False,
                           residual=None, exact=False):
    """Random K4 operands (``wts``, keyword arguments) from the generator
    ``g``, scaled so that every stage spreads over its range.  ``residual``:
    None, "ratio" (the consumer has another step) or "same".  ``exact``
    (for inputs in [-8, 8), no grids): small integer weights, power-of-two
    multipliers and biases in eighths, so that every product and partial sum
    is exact in float32 and no summation order can change a bit.  Also used
    by the tests."""
    import torch

    rnd = lambda n, s: torch.rand(n, generator=g) * s  # noqa: E731
    wint = lambda *shape: torch.randint(-8, 8, shape, generator=g).to(torch.int8)  # noqa: E731
    if exact:
        small = lambda *shape: torch.randint(-4, 4, shape, generator=g).to(torch.int8)  # noqa: E731
        eighths = lambda n: torch.randint(-8, 8, (n,), generator=g).float() / 8.0  # noqa: E731
        wts = dict(w1=small(cin, ch), m1=torch.full((ch,), 0.125), b1=eighths(ch),
                   w2=small(3, 3, ch), m2=torch.full((ch,), 0.25), b2=eighths(ch),
                   w3=small(ch, cout), m3=torch.full((cout,), 0.125), b3=eighths(cout))
        kw = dict(inv_h=None, inv_d=None, use_residual=residual is not None, inv_sh=1.0,
                  qmax_sh=127.0, ratio_out=2.0)
        return wts, kw
    wts = {}
    if expand:
        wts.update(w1=wint(cin, ch), m1=rnd(ch, 4.0 / (cin ** 0.5 * 170.0)),
                   b1=torch.randn(ch, generator=g) * 0.05)
    h_scale = 20.0 if (expand and hidden_grid) else (1.0 if expand else 40.0)
    wts.update(w2=wint(3, 3, ch), m2=rnd(ch, 0.3 / h_scale),
               b2=torch.randn(ch, generator=g) * 0.05, w3=wint(ch, cout),
               m3=rnd(cout, 4.0 / (ch ** 0.5 * 14.0 * (20.0 if dw_grid else 1.0))),
               b3=torch.randn(cout, generator=g) * 0.05)
    kw = dict(inv_h=20.0 if (expand and hidden_grid) else None, qmax_h=255.0,
              inv_d=20.0 if dw_grid else None, qmax_d=255.0,
              use_residual=residual is not None, inv_sh=12.0, qmax_sh=127.0,
              ratio_out={None: 10.0, "ratio": 0.8, "same": None}[residual])
    return wts, kw


def _fused_variants(torch, dev, g):
    """K3 with a signed and a bits output, and K4 over its options, each at a
    flagship shape at batch 256 against its plain version; returns the
    mismatches."""
    from spef_tpu_torch.ops.fused_block import fused_mbconv, fused_stem, fused_stem_plain

    total = 0
    frames = torch.randint(0, 256, (BATCH, 240, 384, 3), generator=g).to(torch.uint8).to(dev)
    w = torch.randint(-8, 8, (3, 3, 3, 32), generator=g).to(torch.int8).to(dev)
    mult = (torch.rand(32, generator=g) * 2e-2 / 255.0).to(dev)
    bias = (torch.randn(32, generator=g) * 0.05).to(dev)
    for name, qmax in (("int8_out", 127.0), ("bits_out", 255.0)):
        a = fused_stem(frames, w, mult, bias, inv_step=qmax / 0.3, qmax=qmax)
        b = fused_stem_plain(frames, w, mult, bias, inv_step=qmax / 0.3, qmax=qmax)
        torch.cuda.synchronize()
        mis, err = diff(a, b)
        total += mis
        log(f"[variants] K3 {name} {tuple(frames.shape)} -> {tuple(a.shape)}: {mis} mismatches, "
            f"max |kernel - plain| {err}")
        del a, b
    del frames
    cases = {
        # name: (x shape, Ch, Cout, stride, in_unsigned, operand options)
        "no_expand_in_unsigned_s1": ((BATCH, 120, 192, 32), 32, 16, 1, True, dict(expand=False)),
        "s2_even_height": ((BATCH, 120, 192, 16), 96, 24, 2, False, dict()),
        "s1_residual_ratio": ((BATCH, 60, 96, 24), 144, 24, 1, False, dict(residual="ratio")),
        "s1_residual_same_step": ((BATCH, 15, 24, 96), 576, 96, 1, False,
                                  dict(residual="same")),
        "s2_odd_height_15_to_8": ((BATCH, 15, 24, 96), 576, 160, 2, False, dict()),
        "s1_hidden_960": ((BATCH, 8, 12, 160), 960, 320, 1, False, dict()),
        "grids_on_s1_residual_ratio": ((BATCH, 30, 48, 64), 384, 64, 1, False,
                                       dict(hidden_grid=True, dw_grid=True, residual="ratio")),
        "grids_on_s2_in_unsigned": ((BATCH, 60, 96, 32), 192, 64, 2, True,
                                    dict(hidden_grid=True, dw_grid=True)),
        "hidden_grid_only_s1": ((BATCH, 15, 24, 64), 384, 96, 1, False, dict(hidden_grid=True)),
        "dw_grid_only_s2": ((BATCH, 30, 48, 32), 192, 64, 2, False, dict(dw_grid=True)),
        # block 3: Cin 24 is padded with zeros to the mma depth of 32
        "s2_cin24_padded_k": ((BATCH, 60, 96, 24), 144, 32, 2, False, dict()),
        # every product and partial sum exact: the tensor cores' order cannot show
        "exact_sums_s1_residual": ((BATCH, 30, 48, 32), 64, 32, 1, False,
                                   dict(exact=True, residual="ratio")),
        "exact_sums_s2": ((BATCH, 30, 48, 32), 64, 32, 2, False, dict(exact=True)),
    }
    for name, (shape, ch, cout, stride, unsigned, opts) in cases.items():
        lo, hi = (-8, 8) if opts.get("exact") else ((-128, 128) if unsigned else (-64, 64))
        x = torch.randint(lo, hi, shape, generator=g).to(torch.int8).to(dev)
        wts, kw = random_mbconv_operands(g, shape[-1], ch, cout, **opts)
        wts = {k: v.to(dev) for k, v in wts.items()}
        kw.update(stride=stride, in_unsigned=unsigned)
        a = fused_mbconv(x, wts, **kw)
        torch.cuda.synchronize()
        mis, err, step = check_mbconv(a, (x, wts), kw)
        rule = f"tie rule, {step} step(s) admitted" if step else "exact"
        log(f"[variants] K4 {name} {tuple(shape)} Ch={ch} -> {tuple(a.shape)}: {mis} mismatches "
            f"({rule}; share {mis / a.numel():.2e}), max |kernel - plain| {err}, "
            f"{a.unique().numel()} distinct values")
        if opts.get("exact"):
            total += mis  # nothing to round differently: must be 0
        del a, x
    return total


def _serve(torch, args_list):
    from spef_tpu_torch.apps import serve

    args = serve.parse_args(args_list)
    server, img_size = serve.build_server(args)
    return server, img_size


def _check_pose(np, pose, n):
    assert pose["ori"].shape == (n, 4) and pose["pos"].shape == (n, 3), pose["ori"].shape
    assert pose["ori_soft"].shape == (n, 1232) and pose["pos_soft"].shape == (n, 1000)
    for v in pose.values():
        assert np.isfinite(v).all()
    assert np.allclose(np.linalg.norm(pose["ori"], axis=-1), 1.0, atol=1e-4)


def _drive(np, server, frames, label):
    """Requests of 256, 37 (padded) and 1 frames; returns the 256 pose."""
    for n in (BATCH, 37, 1):
        pose, ms = server.predict(frames[:n])
        _check_pose(np, pose, n)
        log(f"[{label}] request of {n}: ori {pose['ori'].shape} pos {pose['pos'].shape}, "
            f"{ms:.2f} ms, {n / ms * 1e3:.1f} frames/s")
        if n == BATCH:
            out = pose
    t0 = time.perf_counter()
    reps = 4
    for _ in range(reps):
        server.predict(frames)
    fps = reps * BATCH / (time.perf_counter() - t0)
    log(f"[{label}] sustained {fps:.1f} frames/s at batch {BATCH} "
        f"(p50 {server.stats()['p50_ms']:.2f} ms/request)")
    return out


def _request_parts(torch, server, frames, label):
    """CUDA-event times of a batch-256 request's parts: the host-to-device
    copy of the frames and the predict function on frames already there."""
    x = torch.from_numpy(frames).to(server.device)
    h2d = time_ms(lambda: torch.from_numpy(frames).to(server.device), reps=3)
    predict = time_ms(lambda: server.predict_fn(x), reps=3)
    log(f"[{label}] batch {BATCH} on the card: host-to-device copy {h2d:.3f} ms, "
        f"predict (forward + softmax + decode) {predict:.3f} ms")
    return x


def phase_float(torch, np, dev, frames):
    from spef_tpu_torch.engine import build_predict_fn

    server, _ = _serve(torch, ["--experiment", FLAGSHIP, "--batch", str(BATCH)])
    log(f"[float] warmup {server.warmup():.2f} s")
    _drive(np, server, frames, "float")
    _request_parts(torch, server, frames, "float")

    # Reference on a small input: the float32 model on the card (TF32 off)
    # and on the CPU must agree; the served bf16 model must stay close.
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.models.wrapper import import_model

    small = torch.from_numpy(frames[:2])
    params = os.path.join(FLAGSHIP, "model", "parameters.msgpack")
    outs = {}
    for where in ("cuda", "cpu"):
        model = import_model(params_path=params, ori_mode="classification", n_ori_bins=1232,
                             pos_mode="classification", n_pos_bins=1000, device=where,
                             compute_dtype=torch.float32)
        utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification",
                                pos_mode="classification", device=where)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            outs[where] = {k: v.cpu() for k, v in
                           build_predict_fn(model, utils)(small.to(where)).items()}
        finally:
            torch.backends.cudnn.allow_tf32 = saved
    served, _ = server.predict(frames[:2])
    d_soft = float((outs["cuda"]["ori_soft"] - outs["cpu"]["ori_soft"]).abs().max())
    d_pos = float((outs["cuda"]["pos"] - outs["cpu"]["pos"]).abs().max())
    dot = (torch.from_numpy(served["ori"]) * outs["cpu"]["ori"]).sum(-1).abs().clamp(max=1)
    ang = float(2 * torch.rad2deg(torch.arccos(dot)).max())
    d_pos_bf16 = float((torch.from_numpy(served["pos"]) - outs["cpu"]["pos"]).abs().max())
    log(f"[float] f32 card vs f32 CPU: max |d ori_soft| {d_soft:.3e}, max |d pos| "
        f"{d_pos:.3e} m; served bf16 vs f32 CPU: ori {ang:.3f} deg, pos {d_pos_bf16:.4f} m")
    assert d_soft < 1e-4 and d_pos < 1e-3, (d_soft, d_pos)
    assert ang < 10.0 and d_pos_bf16 < 0.5, (ang, d_pos_bf16)


def _counters():
    from spef_tpu_torch.ops.fused_block import fused_mbconv, fused_stem
    from spef_tpu_torch.ops.int8_ops import int8_depthwise3x3, int8_matmul_requant

    return {"int8_matmul_requant": int8_matmul_requant, "int8_depthwise3x3": int8_depthwise3x3,
            "fused_stem": fused_stem, "fused_mbconv": fused_mbconv}


def _reset_counters():
    for fn in _counters().values():
        fn.launches = 0
        fn.launches_by_card = {}


def _read_counters(label, forwards, per_forward):
    """The launch counts since ``_reset_counters``: exactly ``per_forward``
    a forward, and 0 for the kernels off the path."""
    launches = {name: fn.launches for name, fn in _counters().items()}
    log(f"[{label}] launches over {forwards} forwards: {launches}")
    want = {name: per_forward.get(name, 0) * forwards for name in launches}
    assert launches == want, (launches, want)
    return launches


def _drive_counted(np, server, frames, label, per_forward):
    """A main path: every launch count to 0, warmup + requests, read the
    counts; they must be exactly what ``per_forward`` says, forward for
    forward, and 0 for the kernels that are not on this path."""
    _reset_counters()
    log(f"[{label}] warmup {server.warmup():.2f} s")
    pose = _drive(np, server, frames, label)
    # warmup, the three requests, the sustained run
    return pose, _read_counters(label, 1 + 3 + 4, per_forward)


def phase_int8(torch, np, dev, frames, executor):
    """The committed int8 graph served by one executor: ``layer`` (K1/K2,
    one kernel a layer) or ``fused`` (K3/K4, one kernel a block, then K1)."""
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    label = "int8" if executor == "layer" else "fused"
    build, per_forward = ((build_cuda_forward, LAYER_LAUNCHES) if executor == "layer"
                          else (build_fused_forward, FUSED_LAUNCHES))
    server, _ = _serve(torch, ["--experiment", FLAGSHIP, "--int8-graph", ASSET,
                               "--int8-executor", executor, "--int8-backend", "cuda",
                               "--batch", str(BATCH)])
    pose, launches = _drive_counted(np, server, frames, label, per_forward)

    x = _request_parts(torch, server, frames, label)
    graph = load_int8_graph(ASSET)
    fwd_cuda = build(graph, backend="cuda", device=dev)
    assert fwd_cuda.launches_per_call == per_forward
    log(f"[{label}] batch {BATCH} on the card: int8 forward alone "
        f"{time_ms(lambda: fwd_cuda(x), reps=3):.3f} ms")
    got = fwd_cuda(x)
    want = build(graph, backend="plain", device=dev)(x)
    torch.cuda.synchronize()
    for name, a, b in zip(("ori", "pos"), got, want):
        mis, err = diff(a, b)
        log(f"[{label}] cuda vs plain on the card, {name} logits {tuple(a.shape)}: "
            f"{mis} mismatches, max |d logit| {err}")
        # K1's (layer) or K4's (fused) ties move a few activations by one step.
        assert err < 0.3, (name, err)
    if executor == "fused":
        plain_server, _ = _serve(torch, ["--experiment", FLAGSHIP, "--int8-graph", ASSET,
                                         "--int8-executor", executor, "--int8-backend", "plain",
                                         "--batch", str(BATCH)])
        log_distance(np, "fused", "kernels vs plain backend on the card", (pose, got),
                     (plain_server.predict(frames)[0], want))
    assert np.array_equal(pose["ori_soft"], torch.softmax(got[0], -1).cpu().numpy())
    cpu = build(graph, backend="plain", device="cpu")(torch.from_numpy(frames[:2]))
    d = max(float((a[:2].cpu() - b).abs().max()) for a, b in zip(got, cpu))
    log(f"[{label}] card vs plain on the CPU (2 frames): max |d logit| {d:.4g}")
    assert d < 0.3, d
    return launches, pose, got


def log_executor_distance(np, layer, fused):
    """How far the fused executor's logits and poses are from the layer
    executor's on the same frames.  They follow different JAX twins (a
    float32 against a bf16 hidden tensor, integer pixels against pixels / 255
    in bf16 in the stem), so this is reported, not required to be 0."""
    (_, layer_pose, layer_logits), (_, pose, logits) = layer, fused
    log_distance(np, "fused", "fused vs layer executor", (pose, logits),
                 (layer_pose, layer_logits))


def _recorded_calls(torch, module, names, build, frames, dev):
    """One forward of ``build()`` with ``module``'s kernel wrappers replaced
    by recorders; returns {name: [(args, kw), ...]} with the tensors each
    call got on the card."""
    calls = {name: [] for name in names}

    def recorder(name, fn):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return rec

    saved = {name: getattr(module, name) for name in names}
    try:
        for name, fn in saved.items():
            setattr(module, name, recorder(name, fn))
        fwd = build()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    fwd(torch.from_numpy(frames).to(dev))
    torch.cuda.synchronize()
    return calls


def phase_kernels(torch, dev, frames, launches, built_graph):
    """Each kernel at its main path's own inputs (one batch-256 forward):
    K1 and K2 on the layer executor's, K3 and K4 on the fused executor's;
    then K1 and K2 again on the int8-carry executor's (the graph built on
    the card), in their carry modes."""
    import spef_tpu_torch.quant.int8_carry as int8_carry
    import spef_tpu_torch.quant.int8_cuda as int8_cuda
    import spef_tpu_torch.quant.int8_fused as int8_fused
    from spef_tpu_torch.ops import fused_block, int8_ops
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    graph = load_int8_graph(ASSET)
    calls = _recorded_calls(
        torch, int8_cuda, ("int8_matmul_requant", "int8_depthwise3x3"),
        lambda: int8_cuda.build_cuda_forward(graph, backend="cuda", device=dev), frames, dev)
    fused_calls = _recorded_calls(
        torch, int8_fused, ("fused_stem", "fused_mbconv", "int8_matmul_requant"),
        lambda: int8_fused.build_fused_forward(graph, backend="cuda", device=dev), frames, dev)
    head_conv = fused_calls.pop("int8_matmul_requant")  # K1's one call on the fused path
    calls.update(fused_calls)
    carry_calls = _recorded_calls(
        torch, int8_carry, ("int8_matmul_requant", "int8_depthwise3x3"),
        lambda: int8_carry.build_int8_carry_forward(built_graph, backend="cuda", device=dev),
        frames, dev)
    table = {
        # name: (module, bound, library yardstick, its label)
        "int8_matmul_requant": (int8_ops, mm_bound, mm_library, "bf16 matmul + epilogue ops"),
        "int8_depthwise3x3": (int8_ops, dw_bound, dw_library, "bf16 conv2d(groups=C)"),
        "fused_stem": (fused_block, stem_bound, stem_library, "bf16 conv2d(stride=2)"),
        "fused_mbconv": (fused_block, mbconv_bound, mbconv_library, "chain of 3"),
    }

    def measure(name, i, args, kw):
        """One call: (mismatches, max error, kernel / plain / library / bound ms, bound by,
        steps K4's tie rule admitted)."""
        module, bound_fn, lib_fn, _ = table[name]
        kernel, plain = getattr(module, name), getattr(module, name + "_plain")
        a = kernel(*args, **kw)
        torch.cuda.synchronize()
        mis, err, step = check_call(name, a, args, kw)
        numel = a.numel()
        del a
        k_ms = time_ms(lambda: kernel(*args, **kw), reps=10)
        p_ms = time_ms(lambda: plain(*args, **kw), reps=2)
        l_ms = time_ms(lib_fn(args, kw), reps=10)
        b_ms, by = bound_fn(args, kw)
        extra = ""
        if name == "fused_mbconv":
            x, wts = args
            tile = fused_block.choose_mbconv_tile(
                *x.shape, *wts["w3"].shape, kw["stride"], "w1" in wts, kw["inv_d"] is not None,
                kw["use_residual"])
            extra = (f", tile {tile[0]}x{tile[1]}, mismatching share {mis / numel:.2e}, largest "
                     f"|kernel - plain| {err:g} of {step} step(s) admitted at a tie")
        elif step:
            extra = (f", mismatching share {mis / numel:.2e}, largest |kernel - plain| {err:g} "
                     f"of {step} step(s) admitted at a tie")
        log(f"[kernels] {name} call {i}: in {tuple(args[0].shape)} {args[0].dtype}, "
            f"{mis} mismatches, kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
            f"library {l_ms:.4f} ms, bound {b_ms:.4f} ms ({by}){extra}")
        return mis, err, k_ms, p_ms, l_ms, b_ms, by, step

    def measure_all(name, recs, path):
        """Every recorded call of one kernel on one path, summed."""
        lib_label = table[name][3]
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0}
        mismatches, max_err, max_step = 0, 0.0, 0
        for i, (args, kw) in enumerate(recs):
            mis, err, k_ms, p_ms, l_ms, b_ms, by, step = measure(name, f"{path} {i}", args, kw)
            mismatches, max_err, max_step = mismatches + mis, max(max_err, err), max(max_step, step)
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["library_ms"] += l_ms
            tot["bound_ms"] += b_ms
            tot["bytes_ms" if by == "bytes" else "ops_ms"] += b_ms
        log(f"[kernels] {name} on {path}: {len(recs)} calls a forward, {mismatches} "
            f"mismatches, kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, library "
            f"({lib_label}) {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms a "
            f"batch-{BATCH} forward ({tot['ms'] / tot['bound_ms']:.1f}x the bound)")
        return tot, mismatches, max_err, max_step

    paths = {"int8_matmul_requant": "layer", "int8_depthwise3x3": "layer",
             "fused_stem": "fused", "fused_mbconv": "fused"}
    rows = []
    for name, recs in calls.items():
        lib_label = table[name][3]
        tot, mismatches, max_err, max_step = measure_all(name, recs, paths[name])
        tied = name in ("fused_mbconv", "int8_matmul_requant")
        row = {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name], "max_abs_err": max_err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": tot["library_ms"], "library": lib_label, "mismatches": mismatches,
            "calls_per_forward": len(recs), "redesigned": name in REDESIGNED,
        }
        if tied:
            # Every one of them admitted by the tie rule (check_mbconv and
            # check_mm raise otherwise, and on any integer-input mismatch);
            # max_abs_err is the largest of them, in int8 steps, and
            # tie_steps_admitted the most the rule admitted at any call.
            row["tie_mismatches"] = mismatches
            row["tie_steps_admitted"] = max_step
        if name in carry_calls:
            # The same kernel on the int8-carry path: division, shifted
            # grids and the -128 halo.
            c_tot, c_mis, c_err, _ = measure_all(name, carry_calls[name], "carry")
            row["carry_path"] = {
                "calls_per_forward": len(carry_calls[name]), "ms": c_tot["ms"],
                "plain_ms": c_tot["plain_ms"], "library_ms": c_tot["library_ms"],
                "bound_ms": c_tot["bound_ms"],
                "bound_by": "bytes" if c_tot["bytes_ms"] >= c_tot["ops_ms"] else "operations",
                "max_abs_err": c_err, "mismatches": c_mis}
        rows.append(row)

    # K1's head-conv call of the fused path (int8 in, float32 out), apart.
    (args, kw), = head_conv
    # Integer input: check_call inside measure raises on any mismatch.
    _, err, k_ms, p_ms, l_ms, b_ms, by, _ = measure("int8_matmul_requant", "fused-path", args, kw)
    for row in rows:
        if row["name"] == "int8_matmul_requant":
            row["fused_path"] = {"calls_per_forward": 1, "ms": k_ms, "plain_ms": p_ms,
                                 "library_ms": l_ms, "bound_ms": b_ms, "bound_by": by,
                                 "max_abs_err": err}
    return rows


# ---------------------------------------------------------------------------
# The int8 build chain and the int8-carry executor
# ---------------------------------------------------------------------------

STEP_KEYS = ("act_step", "shared_step", "step", "pool_step")


def compare_graphs(np, got, want, path="graph"):
    """Hold a graph built on the card against the committed asset: the same
    structure, integer weights, grids' qmax, strides and flags; identical
    float32 arrays (``mult_core``, ``bias``, the head's scales and biases:
    the conversion is the same float64 numpy on both sides); every
    calibrated step within one histogram bin, taken as ``amax / 2048`` (the
    narrowest bin the 99.99th percentile of a 2048-bin histogram can have
    picked).  Returns the largest step difference in bins; raises on any
    other difference."""
    worst = 0.0
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            if k in STEP_KEYS:
                qmax = want[{"act_step": "act_qmax", "shared_step": "shared_qmax",
                             "step": "qmax", "pool_step": "pool_qmax"}[k]]
                amax = want[k] * qmax
                bins = abs(got[k] - want[k]) * qmax / (amax / 2048.0)
                if not bins <= 1.0:
                    raise AssertionError(f"{path}/{k}: step {got[k]!r} vs {want[k]!r}, "
                                         f"{bins:.4f} bins apart")
                worst = max(worst, bins)
            else:
                worst = max(worst, compare_graphs(np, got[k], want[k], f"{path}/{k}"))
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{path}: length {len(got)} != {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            worst = max(worst, compare_graphs(np, a, b, f"{path}[{i}]"))
    elif isinstance(want, np.ndarray):
        if not (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and got.shape == want.shape and np.array_equal(got, want)):
            raise AssertionError(f"{path}: arrays differ")
    elif got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")
    return worst


def phase_build(torch, np, dev):
    """The flagship's boundary-recipe int8 graph built on the card from its
    float checkpoint: the QAT twin (``mobilenet_v2_q`` + ``ursonet_q``),
    ``copy_params``, ``convert_qat_params``, ``calibrate_graph`` on the 32
    frames ``render_frame`` gives for seed 0 (in the dataset's channel
    order, RGB), in batches of 8; then held
    against the committed asset (``compare_graphs``)."""
    from spef_tpu_torch.data.synthetic import generate_positions, render_frame
    from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
    from spef_tpu_torch.models.wrapper import flax_variables, import_model, load_flax_variables
    from spef_tpu_torch.quant.bitwidth import boundary_bit_width
    from spef_tpu_torch.quant.calibrate import calibrate_graph
    from spef_tpu_torch.quant.convert import convert_qat_params
    from spef_tpu_torch.quant.int8_graph import load_int8_graph, scalars
    from spef_tpu_torch.quant.warmstart import copy_params

    t0 = time.perf_counter()
    qmodel = import_model("mobilenet_v2_q", "ursonet_q", bit_width=boundary_bit_width(),
                          ori_mode="classification", n_ori_bins=1232,
                          pos_mode="classification", n_pos_bins=1000, device=dev)
    src = read_flax_msgpack(os.path.join(FLAGSHIP, "model", "parameters.msgpack"))
    load_flax_variables(qmodel, copy_params(src, flax_variables(qmodel)))
    graph = convert_qat_params(qmodel)
    t1 = time.perf_counter()
    rng = np.random.RandomState(0)
    oris, poss = generate_positions(rng, 32)
    # In the dataset's channel order: render_frame gives OpenCV's BGR, the
    # dataset stores it as RGB, which is what the model was trained on.
    calib = np.stack([render_frame(q, p, img_size=(240, 384), rng=rng)[..., ::-1]
                      for q, p in zip(oris, poss)])
    t2 = time.perf_counter()
    graph, amaxes = calibrate_graph(graph, (calib[i:i + 8] for i in range(0, 32, 8)),
                                    device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"[build] float checkpoint -> QAT twin -> copy_params -> convert_qat_params "
        f"{t1 - t0:.2f} s; 32 calibration frames rendered {t2 - t1:.2f} s; calibrate_graph "
        f"on the card (4 batches of 8, {len(amaxes)} sites) {t3 - t2:.2f} s")
    worst = compare_graphs(np, scalars(graph), load_int8_graph(ASSET))
    log(f"[build] graph built on the card vs the committed asset: structure, w_int, qmax, "
        f"strides, mult_core and bias identical; largest calibrated step difference "
        f"{worst:.6f} of a histogram bin (at most 1)")
    return qmodel, graph, amaxes


def write_qat_experiment(np, qmodel, graph, amaxes, exp_dir):
    """A QAT experiment as the build chain leaves one: ``config.yaml`` (the
    flagship's), ``model/parameters.msgpack`` + ``model/bit_width.json``
    (``save_model``, the calibrated scales written into the QAT model's
    ``log2_scale`` leaves) and ``int8_graph.pkl``."""
    import pickle
    import shutil

    from spef_tpu_torch.models.wrapper import flax_variables, load_flax_variables, save_model
    from spef_tpu_torch.quant.calibrate import write_scales_to_params

    os.makedirs(exp_dir)
    shutil.copy(os.path.join(FLAGSHIP, "config.yaml"), os.path.join(exp_dir, "config.yaml"))
    load_flax_variables(qmodel, write_scales_to_params(flax_variables(qmodel), amaxes))
    save_model(os.path.join(exp_dir, "model"), qmodel)
    with open(os.path.join(exp_dir, "int8_graph.pkl"), "wb") as f:
        pickle.dump(graph, f, protocol=4)


def _timed_requests(np, server, frames, label, n=8):
    """``n`` requests of ``len(frames)`` frames: p50 of their host-clock
    times and frames/s over them."""
    times = []
    for _ in range(n):
        _, ms = server.predict(frames)
        times.append(ms)
    p50 = float(np.percentile(times, 50))
    fps = len(frames) * n / (sum(times) / 1e3)
    log(f"[{label}] {n} requests of {len(frames)} frames: p50 {p50:.3f} ms (host clock), "
        f"{fps:.1f} frames/s")
    return p50, fps


def log_distance(np, label, what, a, b):
    """How far two runs' logits and poses are on the same frames; ``a`` and
    ``b`` are (pose, logits).  Returns the largest logit distance."""
    (pose_a, logits_a), (pose_b, logits_b) = a, b
    d_logit = max(float((x.float() - y.float()).abs().max()) for x, y in zip(logits_a, logits_b))
    dot = np.clip(np.abs((pose_a["ori"] * pose_b["ori"]).sum(-1)), 0.0, 1.0)
    ang = 2.0 * np.degrees(np.arccos(dot))
    d_pos = np.linalg.norm(pose_a["pos"] - pose_b["pos"], axis=-1)
    log(f"[{label}] {what} over {len(dot)} frames: max |d logit| "
        f"{d_logit:.4g}; orientation mean {ang.mean():.3f} deg, max {ang.max():.3f} deg; "
        f"position mean {d_pos.mean():.4f} m, max {d_pos.max():.4f} m")
    return d_logit


def phase_carry(torch, np, dev, frames, exp_dir, graph):
    """The QAT experiment served: the engine's variants (the QAT model's
    float forward, ``weight-only``, ``int8-carry``) and ``apps.serve
    --int8-executor carry`` at serve windows of 256 and 1, launches counted;
    the carry forward alone; its distances from the plain backend, the
    ``layer`` executor, ``int8_forward`` and the QAT forward."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_engine_variant, discover_engine_variants
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.bitwidth import load_bit_width
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
    from spef_tpu_torch.quant.int8_model import build_int8_forward

    variants = discover_engine_variants(exp_dir)
    log(f"[carry] engine variants of the QAT experiment: {variants}")
    assert variants == ["float", "weight-only", "int8-carry"], variants
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device=dev)
    qat_model = import_model(
        "mobilenet_v2_q", "ursonet_q",
        params_path=os.path.join(exp_dir, "model", "parameters.msgpack"),
        bit_width=load_bit_width(os.path.join(exp_dir, "model", "bit_width.json")),
        ori_mode="classification", n_ori_bins=1232, pos_mode="classification",
        n_pos_bins=1000, device=dev)
    x = torch.from_numpy(frames).to(dev)
    poses = {}
    for variant in variants:
        engine = build_engine_variant(exp_dir, qat_model, utils, variant, device=dev)
        per_forward = CARRY_LAUNCHES if variant == "int8-carry" else {}
        _reset_counters()
        engine.predict(x)  # warmup
        times = [engine.predict(x)[1] for _ in range(8)]
        _read_counters(f"carry:{variant}", 9, per_forward)
        pose, _ = engine.predict(x)
        poses[variant] = {k: v.cpu().numpy() for k, v in pose.items()}
        _check_pose(np, poses[variant], BATCH)
        log(f"[carry:{variant}] engine predict at batch {BATCH} on frames on the card: p50 "
            f"{float(np.percentile(times, 50)):.3f} ms of 8 (host clock), "
            f"{BATCH / float(np.percentile(times, 50)) * 1e3:.1f} frames/s")

    graph_pkl = os.path.join(exp_dir, "int8_graph.pkl")
    for window in (BATCH, 1):
        server, _ = _serve(torch, ["--experiment", exp_dir, "--int8-graph", graph_pkl,
                                   "--int8-executor", "carry", "--batch", str(window)])
        _reset_counters()
        log(f"[carry] serve --int8-executor carry --batch {window}: warmup "
            f"{server.warmup():.2f} s")
        _timed_requests(np, server, frames[:window], f"carry b{window}")
        counted = _read_counters(f"carry b{window}", 1 + 8, CARRY_LAUNCHES)
        if window == BATCH:
            launches = counted
            served = server.predict(frames)[0]
            _check_pose(np, served, BATCH)
            _request_parts(torch, server, frames, "carry")

    fwd = build_int8_carry_forward(graph, backend="cuda", device=dev)
    assert fwd.launches_per_call == CARRY_LAUNCHES, fwd.launches_per_call
    for n in (BATCH, 1):
        log(f"[carry] int8-carry forward alone at batch {n}: "
            f"{time_ms(lambda: fwd(x[:n]), reps=10):.3f} ms (CUDA events)")
    got = fwd(x)

    def pose_of(logits):
        return {k: v.cpu().numpy() for k, v in
                utils.decode(utils.last_activ({"ori_soft": logits[0], "pos_soft": logits[1]})
                             ).items()}

    plain = build_int8_carry_forward(graph, backend="plain", device=dev)(x)
    d = log_distance(np, "carry", "kernels vs plain backend on the card",
                     (pose_of(got), got), (pose_of(plain), plain))
    assert d < 0.3, d  # K1's ties at the bf16 projections
    layer = build_cuda_forward(graph, backend="cuda", device=dev)(x)
    d = log_distance(np, "carry", "carry vs layer executor (same graph)",
                     (pose_of(got), got), (pose_of(layer), layer))
    assert d < 0.3, d
    ref = build_int8_forward(graph, device=dev)(x)
    log_distance(np, "carry", "carry vs int8_forward (same graph)",
                 (pose_of(got), got), (pose_of(ref), ref))
    with torch.inference_mode():
        qat = qat_model(x.float() / torch.tensor(255.0, device=dev))
    log_distance(np, "carry", "carry vs the QAT forward",
                 (pose_of(got), got), (pose_of(qat), qat))
    assert np.array_equal(poses["int8-carry"]["ori_soft"], pose_of(got)["ori_soft"])
    return launches


# ---------------------------------------------------------------------------
# Training and the deployment build
# ---------------------------------------------------------------------------

# A D-SPEED still set for the training phases (240x384, seed 1001).
TRAIN_SET = {"n_train": 512, "n_valid": 128, "n_test": 128}
TRAIN_BATCH = 64  # the flagship's DATA.BATCH_SIZE
PARITY_LOSS_TOL = 0.01  # bf16 on the card vs float32 on the CPU, one SGD step
PARITY_COSINE = 0.99  # of the two parameter updates, flattened
PARITY_BN_TOL = 0.01  # running statistics, ||card - cpu|| / ||cpu|| a tensor
LEARN_STEPS = 40
INT8_ESA_TOL = 0.05  # the built int8 graph's ESA against float's on the same frames


class _Tee:
    """Writes to stdout and keeps a copy (a phase reads what the CLI printed)."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()

    def text(self):
        return "".join(self.parts)


def _flagship_config(still, path):
    """The flagship's config.yaml with DATA.PATH set to ``still``."""
    with open(os.path.join(FLAGSHIP, "config.yaml")) as f:
        cfg = f.read()
    assert "PATH: /tmp/dspeed_syn/still" in cfg
    with open(path, "w") as f:
        f.write(cfg.replace("PATH: /tmp/dspeed_syn/still", f"PATH: {still}"))
    return path


def _first_train_batch(torch, np, still, dev):
    """The first 64 train frames (no shuffle, no augmentation): images /
    255 (IEEE division) and the pose, on ``dev``."""
    from spef_tpu_torch.data.dataset import load_dataset

    data, _ = load_dataset(still, TRAIN_BATCH, (240, 384))
    batch = next(iter(data["train"]))
    assert batch["mask"].all()
    images = torch.from_numpy(batch["images"]).to(dev).float() / torch.tensor(255.0, device=dev)
    return images, torch.from_numpy(batch["ori"]).to(dev), torch.from_numpy(batch["pos"]).to(dev)


def _flagship_utils(still, dev):
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import load_camera

    return SPEUtils.create(load_camera(still), ori_mode="classification",
                           pos_mode="classification", device=dev)


def _parity_gate(torch, np, dev, still):
    """One SGD step (lr 1e-3, momentum 0.9) from the flagship checkpoint on
    the first 64 train frames, one dropout mask for both sides: bf16 on the
    card against float32 on the CPU.  Gates: the loss within 1%, the
    cosine of the two parameter updates at least 0.99, the BN running
    statistics within 1e-2."""
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state, train_update

    class FixedDropout(torch.nn.Module):
        """The head's dropout (rate 0.2) with one mask for both sides."""

        def __init__(self, keep):
            super().__init__()
            self.keep = keep

        def forward(self, x):
            return torch.where(self.keep, x / (1.0 - 0.2), torch.zeros_like(x))

    keep = torch.rand((TRAIN_BATCH, 1280), generator=torch.Generator().manual_seed(0)) < 0.8
    runs = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        t0 = time.perf_counter()
        utils = _flagship_utils(still, where)
        model = import_model(params_path=os.path.join(FLAGSHIP, "model", "parameters.msgpack"),
                             ori_mode="classification", n_ori_bins=utils.orientation.n_bins,
                             pos_mode="classification", n_pos_bins=utils.position.n_bins,
                             device=where, compute_dtype=dtype)
        model.head.ori_dropout = FixedDropout(keep.to(where))
        before = {n: p.detach().float().cpu().clone() for n, p in model.named_parameters()}
        optimizer, _ = import_optimizer(model.parameters(), 1e-3, "SGD", 0.9)
        images, ori, pos = _first_train_batch(torch, np, still, where)
        loss, _ = train_update(create_train_state(model, optimizer), images,
                               utils.encode_targets(ori, pos), utils,
                               SPELoss("classification", "classification"),
                               torch.Generator(device=where).manual_seed(0))
        runs[where.type] = {
            "loss": float(loss),
            "update": {n: p.detach().float().cpu() - before[n] for n, p in
                       model.named_parameters()},
            "stats": {n: b.detach().float().cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
        }
        log(f"[train:parity] one SGD step of the flagship at batch {TRAIN_BATCH} on {where.type} "
            f"({str(dtype).replace('torch.', '')}): loss {runs[where.type]['loss']:.6f}, "
            f"{time.perf_counter() - t0:.2f} s with the model's load")
    card, cpu = runs[dev.type], runs["cpu"]
    rel_loss = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    a = torch.cat([card["update"][n].flatten() for n in cpu["update"]]).double()
    b = torch.cat([cpu["update"][n].flatten() for n in cpu["update"]]).double()
    cosine = float(a @ b / (a.norm() * b.norm()))
    per_tensor = {n: float(torch.nn.functional.cosine_similarity(
        card["update"][n].flatten().double(), u.flatten().double(), dim=0))
        for n, u in cpu["update"].items() if float(u.norm()) > 1e-12}
    worst = min(per_tensor, key=per_tensor.get)
    # Tensors whose update is at least 1e-3 of the largest one's: BN biases
    # ahead of another BN get gradients that are zero up to rounding.
    norms = {n: float(u.norm()) for n, u in cpu["update"].items()}
    moving = {n: c for n, c in per_tensor.items() if norms[n] >= 1e-3 * max(norms.values())}
    worst_moving = min(moving, key=moving.get)
    bn = {n: float((card["stats"][n] - s).norm() / s.norm()) for n, s in cpu["stats"].items()}
    worst_bn = max(bn, key=bn.get)
    log(f"[train:parity] loss {card['loss']:.6f} (card, bf16) vs {cpu['loss']:.6f} (CPU, "
        f"float32): {rel_loss:.3e} relative (at most {PARITY_LOSS_TOL}); update cosine "
        f"{cosine:.6f} over {a.numel()} parameters (at least {PARITY_COSINE}), per-tensor "
        f"minimum {per_tensor[worst]:.4f} ({worst}, of {len(per_tensor)}), "
        f"{moving[worst_moving]:.4f} over the {len(moving)} tensors whose update is at least "
        f"1e-3 of the largest ({worst_moving}); BN running "
        f"statistics worst {bn[worst_bn]:.3e} relative ({worst_bn}, at most {PARITY_BN_TOL})")
    assert rel_loss <= PARITY_LOSS_TOL, rel_loss
    assert cosine >= PARITY_COSINE, cosine
    assert bn[worst_bn] <= PARITY_BN_TOL, (worst_bn, bn[worst_bn])


def _learning_gate(torch, np, dev, still):
    """40 Adam steps (lr 1e-3) from a fresh init (seed 1001) on one fixed
    batch of 64: the loss above the targets' entropy H (the KL part) at
    most halves.  Returns the step ms p50 (CUDA events)."""
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state, train_update

    utils = _flagship_utils(still, dev)
    model = import_model(ori_mode="classification", n_ori_bins=utils.orientation.n_bins,
                         pos_mode="classification", n_pos_bins=utils.position.n_bins,
                         seed=1001, device=dev)
    optimizer, _ = import_optimizer(model.parameters(), 1e-3, "Adam")
    state = create_train_state(model, optimizer)
    images, ori, pos = _first_train_batch(torch, np, still, dev)
    targets = utils.encode_targets(ori, pos)
    entropy = sum(float(torch.special.entr(targets[k]).sum(-1).mean())
                  for k in ("ori_soft", "pos_soft"))
    spe_loss = SPELoss("classification", "classification")
    gen = torch.Generator(device=dev).manual_seed(1001)
    losses, times = [], []
    for _ in range(LEARN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _ = train_update(state, images, targets, utils, spe_loss, gen)
        end.record()
        losses.append(loss)
        times.append((start, end))
    torch.cuda.synchronize()
    losses = torch.stack(losses).cpu().numpy()
    step_ms = [s.elapsed_time(e) for s, e in times]
    kl_1, kl_n = losses[0] - entropy, losses[-1] - entropy
    log(f"[train:learn] {LEARN_STEPS} Adam steps from a fresh init on one batch of "
        f"{TRAIN_BATCH}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, the targets' entropy H "
        f"{entropy:.4f}, KL {kl_1:.4f} -> {kl_n:.4f} ({kl_n / kl_1:.3f} of it, at most 0.5); "
        f"step p50 {float(np.percentile(step_ms[1:], 50)):.3f} ms (CUDA events, batch "
        f"{TRAIN_BATCH}, 240x384, data on the card)")
    assert np.isfinite(losses).all(), losses
    assert kl_n <= 0.5 * kl_1, (kl_1, kl_n)
    _profile_steps(torch, lambda: train_update(state, images, targets, utils, spe_loss, gen))
    return float(np.percentile(step_ms[1:], 50))


# Kernel-name fragments -> the part of a train step they belong to (first match).
_STEP_PARTS = (("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit_gemm", "dgrad",
                                        "wgrad", "fprop")),
               ("batch norm", ("batch_norm", "batchnorm", "welford", "bn_")),
               ("optimizer (Adam)", ("multi_tensor", "adam", "foreach")),
               ("matmul (cuBLAS)", ("gemm", "gemv", "cublas")),
               ("reductions", ("reduce",)),
               ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _profile_steps(torch, step, n=5):
    """``n`` train steps under ``torch.profiler``: device time a step by part
    (kernel names, ``_STEP_PARTS``) and the share of the window the card sat
    idle (no kernel running)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0]
    if not kernels:
        log("[train:profile] torch.profiler recorded no device time on this machine (not "
            "measured); the step times above are CUDA events")
        return
    parts = {}
    for e in kernels:
        name = e.name.lower()
        part = next((p for p, keys in _STEP_PARTS if any(k in name for k in keys)), "other")
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for a, b in spans:  # the union of the kernels' intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = spans[-1][1] - spans[0][0]
    total = sum(parts.values())
    log(f"[train:profile] {n} steps under torch.profiler: {len(kernels) / n:.0f} kernels and "
        f"{total / n / 1e3:.3f} ms of device time a step (host clock {wall_us / n / 1e3:.3f} ms "
        f"a step with the profiler on); the card idle {100 * (1 - busy / window):.1f}% of the "
        f"window from the first kernel to the last; by part: " + ", ".join(
            f"{p} {t / n / 1e3:.3f} ms ({100 * t / total:.1f}%)"
            for p, t in sorted(parts.items(), key=lambda kv: -kv[1])))


def _log_epochs(label, epochs):
    for s in epochs:
        mem = s["peak_memory_bytes"] / 2**30
        log(f"[train:cli] {label}, epoch {s['epoch']}: train step p50 {s['step_ms_p50']:.3f} ms "
            f"(CUDA events), {s['frames_per_s']:.1f} frames/s, steps "
            f"{100 * s['step_share']:.1f}% of the epoch's {s['wall_s']:.2f} s, augmentation "
            f"{s['augment_ms']:.3f} ms a batch, max_memory_allocated {mem:.3f} GiB")


def _train_cli(torch, np, dev, still, root):
    """``python -m spef_tpu_torch.apps.train`` on the flagship's config:
    two epochs from the streaming loader with checkpoints and the device
    augmentation; a third resumed from them on device-resident data (the
    split decoded in that epoch); a fourth on RAM-cached and a fifth on
    device-resident data, both read from the sidecar the third wrote; the
    trained experiment served for one batch through ``apps.serve``."""
    import contextlib

    from spef_tpu_torch.apps import train as train_app
    from spef_tpu_torch.data.dataset import load_dataset

    cfg = _flagship_config(still, os.path.join(root, "exp_dspeed_synth.yaml"))
    common = ["--config", cfg, "--out", os.path.join(root, "train_out"), "--checkpoint",
              "--device-augment"]
    runs = {}
    # The first cached run decodes the split inside its epoch and writes the
    # sidecar; the later ones memmap it.
    for label, flags, resumed in (
            ("streaming loader", ["--epochs", "2"], None),
            ("device-resident data, decoded in the epoch", ["--epochs", "3", "--device-data"],
             2),
            ("RAM-cached data, from the sidecar", ["--epochs", "4", "--cache-dataset"], 3),
            ("device-resident data, from the sidecar", ["--epochs", "5", "--device-data"], 4)):
        tee = _Tee()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            result = train_app.main(common + flags)["exp_dspeed_synth"]
        assert result is not None, f"apps.train {' '.join(flags)} failed (traceback above)"
        if resumed:
            assert f"Resumed from epoch {resumed}" in tee.text(), flags
            assert result["start_epoch"] == resumed + 1, result["start_epoch"]
        log(f"[train:cli] apps.train {' '.join(flags)} --checkpoint --device-augment ({label}): "
            f"{time.perf_counter() - t0:.2f} s"
            + (f"; it printed 'Resumed from epoch {resumed}'" if resumed else ""))
        _log_epochs(label, result["epochs"])
        runs[label] = result
    last = runs["device-resident data, from the sidecar"]
    for phase in ("valid", "test"):
        esa = last["score"][phase]["esa"][0]
        log(f"[train:cli] final evaluation after 5 epochs: {phase} ESA {esa:.4f}, ori "
            f"{last['error'][phase]['ori'][0]:.2f} deg, pos "
            f"{last['error'][phase]['pos'][0]:.3f} m")
        assert np.isfinite(esa)

    server, _ = _serve(torch, ["--experiment", last["folder"], "--batch", str(TRAIN_BATCH)])
    data, _ = load_dataset(still, TRAIN_BATCH, (240, 384))
    frames = next(iter(data["test"]))["images"]
    pose, ms = server.predict(frames)
    _check_pose(np, pose, TRAIN_BATCH)
    log(f"[train:cli] the trained experiment served by apps.serve: one batch of "
        f"{TRAIN_BATCH} test frames, {ms:.2f} ms")
    return cfg, runs["streaming loader"]["epochs"][-1]["frames_per_s"]


def phase_training(torch, np, dev, root):
    """Phase 10: the flagship trained on the card at full width.  Returns
    the dataset, the config the deployment build uses and the streaming
    epoch's frames/s with the device augmentation."""
    from spef_tpu_torch.data.synthetic import create_synthetic_dataset, render_workers

    workers = render_workers()
    t0 = time.perf_counter()
    still = create_synthetic_dataset(root, img_size=(240, 384), seed=1001, workers=workers,
                                     **TRAIN_SET)
    log(f"[train] D-SPEED still set written ({TRAIN_SET['n_train']} + {TRAIN_SET['n_valid']} + "
        f"{TRAIN_SET['n_test']} frames at 240x384, seed 1001, {workers} render processes): "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _parity_gate(torch, np, dev, still)
    t1 = time.perf_counter()
    _learning_gate(torch, np, dev, still)
    t2 = time.perf_counter()
    cfg, device_augment_fps = _train_cli(torch, np, dev, still, root)
    log(f"[train] seconds: parity gate {t1 - t0:.2f}, learning gate {t2 - t1:.2f}, the CLI "
        f"(four runs, five epochs, evaluations, serve) {time.perf_counter() - t2:.2f}")
    return still, cfg, device_augment_fps


def phase_deploy_build(torch, np, dev, still, cfg, root, card):
    """Phase 11: ``python -m spef_tpu_torch.apps.build_int8`` on the
    phase-10 set: the boundary recipe warm-started from the flagship's float
    checkpoint, calibrated on the train batches, one QAT epoch from device-
    resident data; the ladder (qat, int8, weight_only) and the parity
    report; int8 within 0.05 of float's ESA on the same frames; the written
    ``int8_graph.pkl`` served through ``--int8-executor carry`` and ``layer``
    on K1/K2, within 0.3 logit of its plain backend on 64 frames.  Returns
    the launches of those two serves."""
    from spef_tpu_torch.apps import build_int8 as build_app
    from spef_tpu_torch.data.dataset import load_dataset
    from spef_tpu_torch.engine import SPETorch
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.train.trainer import evaluation

    t0 = time.perf_counter()
    _reset_counters()
    # --autotune stores its winners in the port's default table; here they go
    # to a table of this run's own, which nothing after this call reads.
    with _TuningTable(os.path.join(root, "build_tuning.json")):
        result = build_app.main(["--config", cfg, "--out", os.path.join(root, "build_out"),
                                 "--recipe", "boundary", "--fp32-checkpoint",
                                 os.path.join(FLAGSHIP, "model", "parameters.msgpack"),
                                 "--calibrate", "percentile", "--qat-epochs", "1",
                                 "--device-data", "--autotune"])
    t1 = time.perf_counter()
    folder, ladder = result["folder"], result["ladder"]
    tuner_launches = {name: fn.launches for name, fn in _counters().items()}
    report_path = os.path.join(folder, "autotune_report.json")
    failed = []
    if not os.path.isfile(report_path):
        failed.append("apps.build_int8 --autotune wrote no autotune_report.json")
    else:
        with open(report_path) as f:
            report = json.load(f)
        speedups = [e["speedup"] for e in report.values() if e.get("speedup")]
        log(f"[build] (d) apps.build_int8 --autotune at batch {TRAIN_BATCH}: "
            f"autotune_report.json, {len(report)} signatures; tuned / default speedup median "
            f"{np.median(speedups):.3f}x, max {max(speedups):.3f}x; backends "
            f"{sorted(e.get('backend') for e in report.values())}; launches while building "
            f"(the tuner's and the calibration's) {tuner_launches}; {card}")
        if tuner_launches["fused_mbconv"] == 0 or tuner_launches["fused_stem"] == 0:
            failed.append(f"the tuner launched no K3 / K4: {tuner_launches}")
    utils = _flagship_utils(still, dev)
    data, split = load_dataset(still, TRAIN_BATCH, (240, 384))
    model = import_model(params_path=os.path.join(FLAGSHIP, "model", "parameters.msgpack"),
                         ori_mode="classification", n_ori_bins=utils.orientation.n_bins,
                         pos_mode="classification", n_pos_bins=utils.position.n_bins,
                         device=dev)
    float_score, _ = evaluation(SPETorch(model, utils, device=dev), data, utils, split["eval"])
    log(f"[build] apps.build_int8 --recipe boundary --fp32-checkpoint <flagship> --calibrate "
        f"percentile --qat-epochs 1 --device-data: {t1 - t0:.2f} s "
        f"({TRAIN_SET['n_train'] // TRAIN_BATCH} QAT steps of mobilenet_v2_q; --autotune)")
    for phase in split["eval"]:
        f_esa = float_score[phase]["esa"][0]
        got = {stage: ladder[stage][phase]["esa"][0] for stage in ("qat", "int8", "weight_only")}
        log(f"[build] {phase} ESA: float {f_esa:.4f}, " + ", ".join(
            f"{k} {v:.4f}" for k, v in got.items()) + f" (int8 within {INT8_ESA_TOL} of float)")
        if not all(np.isfinite(v) for v in got.values()):
            failed.append(f"{phase}: a ladder ESA is not finite: {got}")
        if not abs(got["int8"] - f_esa) <= INT8_ESA_TOL:
            failed.append(f"{phase}: int8 ESA {got['int8']} is {abs(got['int8'] - f_esa):.4f} "
                          f"from float's {f_esa} (at most {INT8_ESA_TOL})")
    log(f"[build] parity report: {json.dumps(result['parity'])}")
    for part in ("ori_raw", "pos_raw"):
        if not all(np.isfinite(v) for v in result["parity"][part].values()):
            failed.append(f"parity {part} not finite")

    graph_pkl = os.path.join(folder, "int8_graph.pkl")
    graph = load_int8_graph(graph_pkl)
    frames = next(iter(data["test"]))["images"]
    x = torch.from_numpy(frames).to(dev)
    launches = {}
    for executor, build, per_forward in (("carry", build_int8_carry_forward, CARRY_LAUNCHES),
                                         ("layer", build_cuda_forward, LAYER_LAUNCHES)):
        server, _ = _serve(torch, ["--experiment", folder, "--int8-graph", graph_pkl,
                                   "--int8-executor", executor, "--batch", str(TRAIN_BATCH)])
        _reset_counters()
        pose, ms = server.predict(frames)
        launches[executor] = _read_counters(f"build:{executor}", 1, per_forward)
        _check_pose(np, pose, TRAIN_BATCH)
        got = build(graph, backend="cuda", device=dev)(x)
        want = build(graph, backend="plain", device=dev)(x)
        torch.cuda.synchronize()
        d = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        log(f"[build] the built graph served by apps.serve --int8-executor {executor}: "
            f"{TRAIN_BATCH} test frames, {ms:.2f} ms; kernels vs plain backend max |d logit| "
            f"{d:.4g} (at most 0.3)")
        if not d < 0.3:
            failed.append(f"{executor}: kernels {d} in logits from the plain backend")
    if failed:
        raise AssertionError("deployment build gates failed: " + "; ".join(failed))
    return launches, folder


# ---------------------------------------------------------------------------
# Accuracy on the flagship's test split
# ---------------------------------------------------------------------------

# The flagship's D-SPEED split (experiments/gen_dataset.sh): the test split
# follows 20,000 train and 2,000 valid frames at 240x384, seed 1001.
SPLIT = {"n_train": 20000, "n_valid": 2000, "n_test": 2000}
EVAL_BATCH = 32  # apps.eval's default
FLOAT_ESA_TOL = 0.002  # against the recorded eval_score_error.json
VALID_ESA_TOL = 0.003  # the valid split's, against the recorded score_error.json
CARRY_ESA_TOL = 0.003  # against JAX's int8_carry on the same graph and frames
EXECUTOR_ESA_TOL = 0.01  # layer's and fused's against the carry's
ESA_RECORD = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_test_esa.json")


class _PoseRecorder:
    """An engine that keeps every pose its engine returns (device tensors
    moved to the host), for the per-frame distances between executors."""

    def __init__(self, engine):
        self.engine, self.ori, self.pos = engine, [], []

    def predict(self, images):
        pose, ms = self.engine.predict(images)
        self.ori.append(pose["ori"].cpu())
        self.pos.append(pose["pos"].cpu())
        return pose, ms


def _timed(label, fn, tag="accuracy"):
    t0 = time.perf_counter()
    out = fn()
    log(f"[{tag}] {label}: {time.perf_counter() - t0:.2f} s")
    return out


def write_eval_splits(root):
    """The flagship's 2,000-frame valid and test splits, written by the
    port's writer in ``render_workers()`` processes: the 20,000 train
    frames' draws replayed once, then the valid split under ``root/valid``
    and the test split under ``root`` (phases 8 and 12 read it).  Returns
    (test still root, valid still root)."""
    from spef_tpu_torch.data.synthetic import _create_eval_splits, render_workers

    workers = render_workers()
    valid, test = _timed(
        f"valid and test splits written ({SPLIT['n_valid']} + {SPLIT['n_test']} frames at "
        f"240x384, seed 1001, the {SPLIT['n_train']} train frames' draws replayed once; "
        f"{workers} render processes)",
        lambda: _create_eval_splits(os.path.join(root, "valid"), root, img_size=(240, 384),
                                    seed=1001, workers=workers, **SPLIT))
    return test, valid


def phase_accuracy(torch, np, dev, still, valid_still=None):
    """The flagship's test split (``write_eval_splits``) loaded through the
    port's loader; the float flagship evaluated by ``apps.eval`` and the
    committed int8 graph by the three executors on the kernels; each ESA
    held to its reference; the executors' per-frame pose distances; each
    executor's kernels within 0.3 logit of its plain backend on 256 of
    these frames.  Every number is printed before a gate that failed is
    raised.  Returns ({executor: launches over its evaluation}, the loaded
    test batches)."""
    from spef_tpu_torch.apps import eval as eval_app
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.dataset import load_dataset
    from spef_tpu_torch.data.png import _unfilter_wavefront, read_png
    from spef_tpu_torch.engine import SPETorch
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.train.trainer import evaluation

    with open(os.path.join(FLAGSHIP, "eval_score_error.json")) as f:
        recorded = json.load(f)["scores"]["test"]["esa"][0]
    with open(ESA_RECORD) as f:
        jax_record = json.load(f)
    split = SPLIT
    root = os.path.dirname(os.path.normpath(still))
    files = sorted(os.listdir(os.path.join(still, "test", "images")))[:100]
    t0 = time.perf_counter()
    for name in files:
        read_png(os.path.join(still, "test", "images", name))
    log(f"[accuracy] PNG decode: {(time.perf_counter() - t0) / len(files) * 1e3:.3f} ms a "
        f"240x384 frame (mean of {len(files)}, one thread)")
    # Files of other writers (PIL's adaptive filters) hold Average and
    # Paeth rows, which take the anti-diagonal path; its time does not
    # depend on the data.
    rows = np.random.RandomState(0).randint(0, 256, (240, 384 * 3)).astype(np.uint8)
    t0 = time.perf_counter()
    _unfilter_wavefront(rows, np.full(240, 4, np.uint8), 3)
    log(f"[accuracy] PNG unfilter of a 240x384 frame of Paeth rows (anti-diagonals): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms, one thread")

    # Float: the flagship through apps.eval, as a user runs it.  The
    # experiment is a copy whose model/ is the flagship's, so the scores
    # it writes land there.
    exp = os.path.join(root, "exp_dspeed_synth")
    os.makedirs(exp)
    shutil.copy(os.path.join(FLAGSHIP, "config.yaml"), exp)
    os.symlink(os.path.join(FLAGSHIP, "model"), os.path.join(exp, "model"))
    _reset_counters()
    score, error = _timed(
        "float flagship: python -m spef_tpu_torch.apps.eval (load, forward, score)",
        lambda: eval_app.main(["--experiment", exp, "--data", still]))
    _read_counters("accuracy:float", 0, {})
    with open(os.path.join(exp, "eval_score_error.json")) as f:
        written = json.load(f)
    assert written["scores"]["test"]["esa"][0] == score["test"]["esa"][0]
    assert os.path.isfile(os.path.join(exp, "eval_score_error_scores.csv"))
    float_esa = score["test"]["esa"][0]
    log(f"[accuracy] float test ESA {float_esa:.6f} (recorded {recorded:.6f}, JAX on the "
        f"CPU over these frames {jax_record['float']['esa']:.6f}), ori "
        f"{error['test']['ori'][0]:.3f} deg, pos {error['test']['pos'][0]:.4f} m")
    failed = []
    if abs(float_esa - recorded) > FLOAT_ESA_TOL:
        failed.append(f"float test ESA {float_esa} is {abs(float_esa - recorded):.5f} from "
                      f"the recorded {recorded} (at most {FLOAT_ESA_TOL})")
    if valid_still is not None:
        # The valid split: the asset's own score_error.json, never scored by
        # the port before.
        with open(os.path.join(FLAGSHIP, "score_error.json")) as f:
            recorded_valid = json.load(f)["scores"]["valid"]["esa"][0]
        t0 = time.perf_counter()
        score, error = eval_app.main(["--experiment", exp, "--data", valid_still])
        valid_esa = score["valid"]["esa"][0]
        log(f"[accuracy] float valid ESA {valid_esa:.6f} (recorded {recorded_valid:.6f}, d "
            f"{abs(valid_esa - recorded_valid):.6f}, at most {VALID_ESA_TOL}), ori "
            f"{error['valid']['ori'][0]:.3f} deg, pos {error['valid']['pos'][0]:.4f} m; "
            f"apps.eval on the valid split: {time.perf_counter() - t0:.2f} s")
        if not abs(valid_esa - recorded_valid) <= VALID_ESA_TOL:
            failed.append(f"float valid ESA {valid_esa} is {abs(valid_esa - recorded_valid):.5f} "
                          f"from the recorded {recorded_valid} (at most {VALID_ESA_TOL})")

    # Int8: the committed graph on the same loader batches.
    data, splits = load_dataset(still, EVAL_BATCH, (240, 384))
    assert splits["eval"] == ("test",), splits
    batches = _timed(f"test split loaded ({len(data['test'])} batches of "
                           f"{EVAL_BATCH})", lambda: list(data["test"]))
    n = int(sum(b["mask"].sum() for b in batches))
    assert n == split["n_test"], n
    graph = load_int8_graph(ASSET)
    utils = SPEUtils.create(load_camera(still), ori_mode="classification",
                            pos_mode="classification", device=dev)
    executors = {"layer": (build_cuda_forward, LAYER_LAUNCHES),
                 "fused": (build_fused_forward, FUSED_LAUNCHES),
                 "carry": (build_int8_carry_forward, CARRY_LAUNCHES)}
    esa, poses, launches = {}, {}, {}
    for name, (build, per_forward) in executors.items():
        rec = _PoseRecorder(SPETorch(None, utils, forward_fn=build(graph, backend="cuda",
                                                                   device=dev), device=dev))
        _reset_counters()
        score, error = _timed(f"{name} executor: evaluation over the test split",
                                    lambda: evaluation(rec, {"test": batches}, utils,
                                                       ("test",)))
        launches[name] = _read_counters(f"accuracy:{name}", len(batches), per_forward)
        esa[name] = score["test"]["esa"][0]
        poses[name] = (torch.cat(rec.ori)[:n].numpy(), torch.cat(rec.pos)[:n].numpy())
        log(f"[accuracy] {name} test ESA {esa[name]:.6f}, ori {error['test']['ori'][0]:.3f} "
            f"deg, pos {error['test']['pos'][0]:.4f} m")
    for a, b in (("layer", "carry"), ("fused", "carry"), ("layer", "fused")):
        dot = np.clip(np.abs((poses[a][0] * poses[b][0]).sum(-1)), 0.0, 1.0)
        ang = 2.0 * np.degrees(np.arccos(dot))
        dist = np.linalg.norm(poses[a][1] - poses[b][1], axis=-1)
        log(f"[accuracy] {a} vs {b} over {n} frames: orientation mean {ang.mean():.4f} deg, "
            f"p99 {np.percentile(ang, 99):.4f}, max {ang.max():.4f}; position mean "
            f"{dist.mean():.5f} m, p99 {np.percentile(dist, 99):.5f}, max {dist.max():.5f}")
    jax_carry = jax_record["int8_carry"]["esa"]
    log(f"[accuracy] carry {esa['carry']:.6f} vs JAX int8_carry {jax_carry:.6f} "
        f"(d {abs(esa['carry'] - jax_carry):.6f}, at most {CARRY_ESA_TOL}); layer d "
        f"{abs(esa['layer'] - esa['carry']):.6f}, fused d "
        f"{abs(esa['fused'] - esa['carry']):.6f} from the carry (at most {EXECUTOR_ESA_TOL})")

    # The 0.3-logit gate of phases 4, 5 and 7, on 256 rendered frames.
    x = torch.from_numpy(np.concatenate([b["images"] for b in batches])[:BATCH]).to(dev)
    for name, (build, _) in executors.items():
        got = build(graph, backend="cuda", device=dev)(x)
        want = build(graph, backend="plain", device=dev)(x)
        torch.cuda.synchronize()
        pose_of = lambda lg: {k: v.cpu().numpy() for k, v in utils.decode(  # noqa: E731
            utils.last_activ({"ori_soft": lg[0], "pos_soft": lg[1]})).items()}
        d = log_distance(np, f"accuracy:{name}", "kernels vs plain backend on the first test "
                         "frames", (pose_of(got), got), (pose_of(want), want))
        if not d < 0.3:
            failed.append(f"{name}: kernels {d} in logits from the plain backend on "
                          f"rendered frames (at most 0.3)")
    if abs(esa["carry"] - jax_carry) > CARRY_ESA_TOL:
        failed.append(f"carry test ESA {esa['carry']} is "
                      f"{abs(esa['carry'] - jax_carry):.5f} from JAX's {jax_carry} "
                      f"(at most {CARRY_ESA_TOL})")
    for name in ("layer", "fused"):
        if abs(esa[name] - esa["carry"]) > EXECUTOR_ESA_TOL:
            failed.append(f"{name} test ESA {esa[name]} is "
                          f"{abs(esa[name] - esa['carry']):.5f} from the carry's (at most "
                          f"{EXECUTOR_ESA_TOL})")
    if failed:
        raise AssertionError("accuracy gates failed: " + "; ".join(failed))
    return launches, batches


SYNTH = os.path.join(REPO, "experiments", "train_synth")
KP_COARSE = os.path.join(SYNTH, "exp_keypoints_heatmap_synth")
KP_FINE = os.path.join(SYNTH, "exp_keypoints_crop2_synth")
KP_REGRESSION = os.path.join(SYNTH, "exp_keypoints_synth")
KP_RECORD = os.path.join(REPO, "spef_tpu_torch", "assets", "keypoints_test_esa.json")
KP_NPZ = os.path.join(REPO, "spef_tpu_torch", "assets", "keypoints_decode_ref.npz")
KP_DECODES = {"epnp": dict(ransac=False, border_gate=None),
              "ransac": dict(ransac=True, border_gate=None),
              "ransac_gate": dict(ransac=True, border_gate=0.02)}
# The decoder against JAX's on the same keypoints: the median distance, and
# the share of frames beyond KP_FAR_DEG by decode, set from the port's CPU
# run against the npz (1.95% / 10.16% / 11.33% beyond 1 deg), about twice
# those (tests/test_torch_keypoints_esa.py holds the CPU to the same gates).
KP_MEDIAN_DEG = 0.01
KP_FAR_DEG = 1.0
KP_FAR_SHARE = {"epnp": 0.04, "ransac": 0.2, "ransac_gate": 0.2}
KP_ESA_TOL = 0.01  # each row against JAX's on the same frames
KP_WINDOWS = (1, 64)


def _pose_distance(np, q_a, t_a, q_b, t_b):
    q_a, t_a, q_b, t_b = (np.asarray(x, np.float64) for x in (q_a, t_a, q_b, t_b))
    dot = np.clip(np.abs((q_a * q_b).sum(-1)), 0.0, 1.0)
    return 2.0 * np.degrees(np.arccos(dot)), np.linalg.norm(t_a - t_b, axis=-1)


def _recorded_esa(exp, name):
    """A committed eval sidecar's test ESA (the JAX package's own run)."""
    path = os.path.join(exp, f"{name}.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)["scores"]["test"]["esa"][0]


def _source_name(torch, filename):
    """``filename`` as ``torch/<path>`` inside torch's install, as its path
    from the repo root inside the repo, else as it is."""
    path = os.path.abspath(filename)
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    if path.startswith(torch_dir + os.sep):
        return "torch/" + os.path.relpath(path, torch_dir)
    if path.startswith(REPO + os.sep):
        return os.path.relpath(path, REPO)
    return path


def _kernels_and_syncs(torch, fn):
    """(CUDA kernels one call of ``fn`` launches by ``torch.profiler``, copies
    and memsets left out, or None where the profiler sees no device
    activity; the host synchronizations the call makes under
    ``torch.cuda.set_sync_debug_mode("warn")``, counted by the source line
    that made them: ``torch/<path>:<line>`` inside torch's install, the path
    from the repo root inside the repo, else the full path)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.lower().startswith(("memcpy", "memset")))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message).lower():
            key = f"{_source_name(torch, w.filename)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return (kernels or None), where


def phase_keypoints(torch, np, dev, still, batches):
    """The keypoints family on the card: (a) the decoder alone on JAX's
    keypoints of 256 test frames (``keypoints_decode_ref.npz``), each
    decode's per-frame distance from JAX's pose; (b) the six rows of
    ``keypoints_test_esa.json`` on the 2,000 test frames of phase 8, each
    test ESA within ``KP_ESA_TOL`` of JAX's, the two-pass RANSAC row through
    ``python -m spef_tpu_torch.apps.eval``; (c) CUDA-event times at batches 1
    and 256 of the forwards, the decodes, ``crop_resize`` and the two-pass
    predict, request p50 through ``PoseServer`` at serve windows 1 and 64,
    the kernels each decode launches (``torch.profiler``) and the host
    synchronizations it makes.  No hand kernel is on this path: the launch
    counters must read 0.  Every number is printed before a failed gate
    raises."""
    from spef_tpu_torch.apps import eval as eval_app
    from spef_tpu_torch.codec.crop import crop_box_from_keypoints, crop_resize
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.engine import (SPETorch, build_crop_refine_fn, build_engine_variant,
                                       load_experiment_model)
    from spef_tpu_torch.serving import PoseServer
    from spef_tpu_torch.train.trainer import evaluation

    with open(KP_RECORD) as f:
        record = json.load(f)
    camera = load_camera(still)
    failed = []

    def utils(ransac=False, border_gate=None):
        return SPEUtils.create(camera, ori_mode="keypoints", pos_mode="keypoints",
                               keypoints_ransac=ransac, keypoints_border_gate=border_gate,
                               device=dev)

    # (a) The decoder alone, on JAX's keypoints.
    with np.load(KP_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    kp = torch.from_numpy(ref["keypoints"]).to(dev)
    kpts = utils().keypoints
    for name, kw in KP_DECODES.items():
        out = kpts.decode_batch(kp, **kw)
        assert out["ori"].device.type == out["pos"].device.type == dev.type  # no CPU fallback
        ang, dist = _pose_distance(np, out["ori"].cpu(), out["pos"].cpu(), ref[f"{name}_ori"],
                                   ref[f"{name}_pos"])
        far = float(np.mean(ang > KP_FAR_DEG))
        log(f"[keypoints:decode] {name} on JAX's keypoints of {len(ang)} test frames, pose "
            f"distance from JAX's: median {np.median(ang):.5f} deg, p90 "
            f"{np.percentile(ang, 90):.5f}, p99 {np.percentile(ang, 99):.4f}, max "
            f"{ang.max():.4f} deg; {100 * far:.2f}% beyond {KP_FAR_DEG} deg; position median "
            f"{np.median(dist):.6f} m, max {dist.max():.4f} m")
        if not (np.median(ang) <= KP_MEDIAN_DEG and far <= KP_FAR_SHARE[name]):
            failed.append(f"decoder {name}: median {np.median(ang):.5f} deg (at most "
                          f"{KP_MEDIAN_DEG}), {100 * far:.2f}% beyond {KP_FAR_DEG} deg (at "
                          f"most {100 * KP_FAR_SHARE[name]}%)")

    # (b) The six rows on the test split.
    coarse = load_experiment_model(KP_COARSE, device=dev)
    regression = load_experiment_model(KP_REGRESSION, device=dev)
    data = {"test": batches}
    esa = {}
    _reset_counters()
    n_forwards = 0
    for row, (model, kw) in {"coarse_epnp": (coarse, KP_DECODES["epnp"]),
                             "coarse_ransac": (coarse, KP_DECODES["ransac"]),
                             "coarse_ransac_gate": (coarse, KP_DECODES["ransac_gate"]),
                             "regression_epnp": (regression, KP_DECODES["epnp"])}.items():
        u = utils(kw["ransac"], kw["border_gate"])
        score, error = _timed(f"{row}: evaluation over the test split",
                              lambda: evaluation(SPETorch(model, u, device=dev), data, u,
                                                 ("test",)), "keypoints")
        esa[row] = (score["test"]["esa"][0], error["test"]["ori"][0], error["test"]["pos"][0])
        n_forwards += len(batches)
    # The registry's two-pass pair through apps.eval, as a user runs it.
    exp = os.path.join(os.path.dirname(os.path.normpath(still)), "exp_keypoints_heatmap_synth")
    os.makedirs(exp, exist_ok=True)
    shutil.copy(os.path.join(KP_COARSE, "config.yaml"), exp)
    os.symlink(os.path.join(KP_COARSE, "model"), os.path.join(exp, "model"))
    score, error = _timed(
        "crop_refine_ransac: python -m spef_tpu_torch.apps.eval --ransac --crop-refine "
        "exp_keypoints_crop2_synth (load, two passes, decode, score)",
        lambda: eval_app.main(["--experiment", exp, "--data", still, "--ransac",
                               "--crop-refine", KP_FINE, "--device", dev.type]), "keypoints")
    assert os.path.isfile(os.path.join(exp, "eval_score_error_ransac_croprefine.json"))
    esa["crop_refine_ransac"] = (score["test"]["esa"][0], error["test"]["ori"][0],
                                 error["test"]["pos"][0])
    cwd = os.getcwd()
    os.chdir(REPO)  # the committed registry names its fine model from the repo root
    try:
        w8 = build_engine_variant(KP_COARSE, coarse, utils(True), "crop-refine-w8", device=dev)
    finally:
        os.chdir(cwd)
    score, error = _timed("crop_refine_w8_ransac: evaluation over the test split",
                          lambda: evaluation(w8, data, w8.spe_utils, ("test",)), "keypoints")
    esa["crop_refine_w8_ransac"] = (score["test"]["esa"][0], error["test"]["ori"][0],
                                    error["test"]["pos"][0])
    _read_counters("keypoints", n_forwards, {})
    tpu_era = {"coarse_epnp": _recorded_esa(KP_COARSE, "eval_score_error"),
               "coarse_ransac": _recorded_esa(KP_COARSE, "eval_score_error_ransac"),
               "regression_epnp": _recorded_esa(KP_REGRESSION, "eval_score_error")}
    for row, (e, ori, pos) in esa.items():
        want = record["rows"][row]["esa"]
        era = tpu_era.get(row)
        log(f"[keypoints:accuracy] {row}: test ESA {e:.6f} (JAX on the CPU over these frames "
            f"{want:.6f}, d {abs(e - want):.6f}, at most {KP_ESA_TOL}), ori {ori:.3f} deg, pos "
            f"{pos:.4f} m" + (f"; the TPU-era recorded ESA {era:.4f}, other frames, for "
                              f"information" if era is not None else ""))
        if abs(e - want) > KP_ESA_TOL:
            failed.append(f"{row}: test ESA {e} is {abs(e - want):.5f} from JAX's {want}")

    # (c) Times on the card.
    fine = load_experiment_model(KP_FINE, device=dev)
    frames = torch.from_numpy(np.concatenate([b["images"] for b in batches])[:BATCH]).to(dev)
    u_epnp, u_ransac = utils(), utils(True)
    two_pass = build_crop_refine_fn(coarse, fine, u_ransac, crop_hw=(240, 384))
    for b in (1, BATCH):
        x8 = frames[:b]
        x = x8.float() / 255.0
        with torch.inference_mode():
            k = torch.sigmoid(coarse(x))
            box = crop_box_from_keypoints(k, 1.5)
            crops = crop_resize(x, box, (240, 384))
            parts = {
                "coarse forward": lambda: coarse(x),
                "EPnP decode": lambda: u_epnp.decode({"keypoints": k}),
                "RANSAC decode": lambda: u_ransac.decode({"keypoints": k}),
                "crop_resize": lambda: crop_resize(x, box, (240, 384)),
                "fine forward": lambda: fine(crops),
                "two-pass predict (RANSAC)": lambda: two_pass(x8),
            }
            reps = 20 if b == 1 else 5
            times = {name: time_ms(fn, reps) for name, fn in parts.items()}
        log(f"[keypoints:time] batch {b}: " + ", ".join(
            f"{name} {ms:.3f} ms" for name, ms in times.items()) + " (CUDA events)")
        for name in ("EPnP decode", "RANSAC decode"):
            with torch.inference_mode():
                n_k, syncs = _kernels_and_syncs(torch, parts[name])
            log(f"[keypoints:decode] {name} at batch {b}: "
                f"{n_k if n_k is not None else 'not measured'} CUDA kernels a call "
                f"(torch.profiler); {sum(syncs.values())} host synchronizations a call "
                f"(torch.cuda.set_sync_debug_mode('warn')), by line: {syncs}")
    for window in KP_WINDOWS:
        server = PoseServer(two_pass, img_shape=(240, 384, 3), max_batch=window, device=dev)
        server.warmup()
        _timed_requests(np, server, frames[:window].cpu().numpy(),
                        f"keypoints:serve crop-refine window {window}")
    if failed:
        raise AssertionError("keypoints gates failed: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# Temporal (video) evaluation
# ---------------------------------------------------------------------------

TEMPORAL_RECORD = os.path.join(REPO, "spef_tpu_torch", "assets", "temporal_esa.json")
TEMPORAL_N_FRAMES = 299  # create_dspeed --n-frames: 300 frames a scenario
TEMPORAL_HW = (240, 384)
TEMPORAL_ESA_TOL = 0.005  # each scenario's float still / video ESA against JAX's
TEMPORAL_MEAN_TOL = 0.002  # the mean over the 11, each mode
MODES_REL, MODES_ABS = 1e-4, 1e-5  # serial against --batch-sequences (tests/test_temporal_cli.py)
STREAM_SCENARIO = "TITR"
STREAM_PDF_TOL = 1e-5  # the streaming filter against scan_filter on what it was fed


def write_scenarios(root):
    """The 11 D-SPEED video scenarios, 300 frames each at 240x384, written by
    ``python -m spef_tpu_torch.apps.create_dspeed`` under ``root``; each
    scenario's frames must hash to what the JAX reference was measured on.
    Returns the video root."""
    from spef_tpu_torch.apps import create_dspeed
    from spef_tpu_torch.data.synthetic import render_workers

    with open(TEMPORAL_RECORD) as f:
        record = json.load(f)
    video = os.path.join(root, "video")
    _timed(f"11 scenarios written (python -m spef_tpu_torch.apps.create_dspeed --skip-still "
           f"--render, {TEMPORAL_HW[0]}x{TEMPORAL_HW[1]}, --n-frames {TEMPORAL_N_FRAMES}: "
           f"{11 * (TEMPORAL_N_FRAMES + 1)} frames, {render_workers()} render processes)",
           lambda: create_dspeed.main([
               "--out", video, "--skip-still", "--render", "--img-height", str(TEMPORAL_HW[0]),
               "--img-width", str(TEMPORAL_HW[1]), "--n-frames", str(TEMPORAL_N_FRAMES)]),
           "temporal")
    for seq, row in record["scenarios"].items():
        digest = create_dspeed.frames_sha256(os.path.join(video, seq))
        if digest != row["frames_sha256"]:
            raise AssertionError(f"{seq}: the frames written here are not those JAX's "
                                 f"reference was measured on (sha256 {digest})")
    log(f"[temporal] the 11 scenarios' frames hash to the reference's sha256 values")
    return video


def _temporal_cli(root, exp, video, mode, extra):
    """``python -m spef_tpu_torch.apps.temporal_eval`` in one mode; returns
    (its temporal_metrics.json, wall seconds)."""
    from spef_tpu_torch.apps import temporal_eval

    out = os.path.join(root, f"temporal_{mode}")
    _reset_counters()
    t0 = time.perf_counter()
    temporal_eval.main(["--experiment", exp, "--data", video, "--out", out, *extra])
    wall = time.perf_counter() - t0
    _read_counters(f"temporal:float {mode}", 0, {})  # no hand kernel on the float path
    files = set(os.listdir(out))
    assert {"temporal_metrics.json", "still_metrics_S.csv", "video_metrics_S.csv",
            "distances_S.csv"} <= files, files
    if mode == "serial":
        assert "temporal_tables.json" in files, files
    with open(os.path.join(out, "temporal_metrics.json")) as f:
        return json.load(f), wall


def _stream(torch, np, engine, utils, frames, label, card):
    """``Inference.predict(frame, "Adaptative")`` frame after frame, after one
    warm-up frame and a reset; returns (still soft outputs fed to the
    filter, filtered soft outputs, video poses, per-frame host ms)."""
    from spef_tpu_torch.temporal.inference import Inference

    stream = Inference(engine, utils, dataset="dspeed_video")
    stream.predict(frames[:1], "Adaptative")
    stream.reset()
    _reset_counters()
    fed, filtered, poses, ms = {"ori": [], "pos": []}, {"ori": [], "pos": []}, [], []
    for i in range(len(frames)):
        t0 = time.perf_counter()
        still, _, video = stream.predict(frames[i:i + 1], "Adaptative")
        ms.append((time.perf_counter() - t0) * 1e3)
        for k in ("ori", "pos"):
            fed[k].append(still[f"{k}_soft"])
            filtered[k].append(video[f"{k}_soft"])
        poses.append((video["ori"], video["pos"]))
    log(f"[temporal:time] streaming Inference.predict(frame, 'Adaptative'), {label}, "
        f"{len(frames)} frames of {STREAM_SCENARIO}: p50 {np.percentile(ms, 50):.3f} ms, p95 "
        f"{np.percentile(ms, 95):.3f} ms a frame (host clock: copy, forward, decode, "
        f"filter, re-decode, continuity) on {card}")
    return fed, filtered, poses, ms


def _hold_path(torch, tag, label, module, names, build, frames, dev, failed):
    """Every call of the kernels ``names`` (wrappers bound in ``module``) in
    one forward of ``build(backend)`` on ``frames`` (uint8, the path's own
    batch) held by ``check_call``; then the forward's logits
    against the plain backend's, within 0.3.  Every kernel of ``names`` is
    one the path must launch: one it never called, or a disagreement, goes
    into ``failed``.  Returns {kernel: {calls, input, mismatches,
    max_abs_err}}."""
    from spef_tpu_torch.ops import fused_block, int8_ops

    calls = _recorded_calls(torch, module, names, lambda: build(backend="cuda"), frames, dev)
    checks = {}
    for name, recs in calls.items():
        if not recs:
            failed.append(f"{label}: the path never called {name}")
            continue
        kernel = getattr(fused_block if name.startswith("fused") else int8_ops, name)
        mis_sum, max_err, bad = 0, 0.0, 0
        for i, (args, kw) in enumerate(recs):
            try:
                a = kernel(*args, **kw)
                torch.cuda.synchronize()
                mis, err, _ = check_call(name, a, args, kw)
            except AssertionError as e:
                failed.append(f"{label}: call {i}, input {tuple(args[0].shape)}: {e}")
                bad += 1
                continue
            mis_sum, max_err = mis_sum + mis, max(max_err, err)
        log(f"[{tag}:kernels] {label}: {name}, {len(recs)} calls (first input "
            f"{tuple(recs[0][0][0].shape)} {recs[0][0][0].dtype}) against the plain version: "
            f"{bad} calls failed; in the others {mis_sum} mismatches, each at a tie the rule admits; max |kernel - plain| "
            f"{max_err:g}")
        checks[name] = {"calls": len(recs), "input": list(recs[0][0][0].shape),
                        "mismatches": mis_sum, "max_abs_err": max_err}
    x = torch.from_numpy(frames).to(dev)
    got, want = build(backend="cuda")(x), build(backend="plain")(x)
    d = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    log(f"[{tag}:kernels] {label}: kernels vs plain backend on {len(frames)} frames, max "
        f"|d logit| {d:.4g} (at most 0.3)")
    if not d < 0.3:
        failed.append(f"{label}: kernels {d} in logits from the plain backend")
    return checks


def phase_temporal(torch, np, dev, video, card):
    """Temporal evaluation on the 11 scenarios of ``write_scenarios``: (a) the
    float flagship through ``python -m spef_tpu_torch.apps.temporal_eval``,
    serial and ``--batch-sequences``, each scenario's still and video ESA
    within ``TEMPORAL_ESA_TOL`` of JAX's on the same frames and their means
    within ``TEMPORAL_MEAN_TOL``, the two modes together; (b) the committed
    int8 graph on the ``fused`` executor (K3, K4, K1) through
    ``multi_sequence_inference``, each video ESA within ``EXECUTOR_ESA_TOL``
    of JAX's ``int8_carry``; (c) the streaming ``Inference`` on the
    ``carry`` executor (K1, K2) over one scenario, its video ESA within
    ``CARRY_ESA_TOL`` of JAX's, its filtered PDFs those of ``scan_filter``
    over what it was fed; (d) times.  The launch counters are set to 0
    before each path and read after it.  The kernels of (b) and (c) are then
    held against their plain versions at the batches those paths gave them
    (a 64-frame chunk and the tail; one frame).  Every number is printed
    before a failed gate raises.  Returns ({path: launches}, {path:
    {kernel: its check}})."""
    from spef_tpu_torch.apps.temporal_eval import _gather
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.dataset import load_dataset
    from spef_tpu_torch.engine import SPETorch, load_experiment_model
    from spef_tpu_torch.pose.score import score_batch
    from spef_tpu_torch.quant import int8_carry, int8_fused
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.temporal.inference import (multi_sequence_inference,
                                                   quaternion_continuity_scan)
    from spef_tpu_torch.temporal.pdf_filter import filter_defaults, scan_filter

    with open(TEMPORAL_RECORD) as f:
        record = json.load(f)
    rows = record["scenarios"]
    root = os.path.dirname(os.path.normpath(video))
    failed = []

    # (a) Float, through the CLI, as a user runs it.
    exp = os.path.join(root, "exp_dspeed_synth")
    os.makedirs(exp)
    shutil.copy(os.path.join(FLAGSHIP, "config.yaml"), exp)
    os.symlink(os.path.join(FLAGSHIP, "model"), os.path.join(exp, "model"))
    got, walls = {}, {}
    for mode, extra in (("serial", []), ("batched", ["--batch-sequences"])):
        got[mode], walls[mode] = _temporal_cli(root, exp, video, mode, extra)
        n = len(got[mode]) * (TEMPORAL_N_FRAMES + 1)
        log(f"[temporal:time] float, python -m spef_tpu_torch.apps.temporal_eval"
            f"{' --batch-sequences' if extra else ''}: {walls[mode]:.2f} s wall, "
            f"{n / walls[mode]:.1f} frames/s over {n} frames (host clock: PNG load, forward, "
            f"filter, decode, scores, workbooks) on {card}")
    assert sorted(got["serial"]) == sorted(got["batched"]) == sorted(rows)
    for seq in sorted(rows):
        want, era = rows[seq]["float"], rows[seq]["accuracy_md_tpu"]
        parts = []
        for mode in ("still", "video"):
            e = got["serial"][seq][mode]["esa_score"]
            b = got["batched"][seq][mode]["esa_score"]
            d = abs(e - want[mode]["esa"])
            parts.append(f"{mode} {e:.6f} (JAX {want[mode]['esa']:.6f}, d {d:.6f}; batched "
                         f"{b:.6f}, d {abs(b - e):.2e})")
            if d > TEMPORAL_ESA_TOL:
                failed.append(f"float {seq} {mode} ESA {e} is {d:.5f} from JAX's "
                              f"{want[mode]['esa']} (at most {TEMPORAL_ESA_TOL})")
            if abs(b - e) > MODES_ABS + MODES_REL * abs(e):
                failed.append(f"float {seq} {mode}: --batch-sequences ESA {b} against the "
                              f"serial {e} (at most {MODES_REL} relative + {MODES_ABS})")
        log(f"[temporal:accuracy] float {seq}: " + "; ".join(parts) + f"; ACCURACY.md's TPU "
            f"run over 1,500 frames {era['still']:.4f} -> {era['video']:.4f}, for information")
    for mode in ("still", "video"):
        mine = float(np.mean([got["serial"][s][mode]["esa_score"] for s in rows]))
        theirs = float(np.mean([rows[s]["float"][mode]["esa"] for s in rows]))
        log(f"[temporal:accuracy] float mean {mode} ESA over the 11: {mine:.6f} (JAX "
            f"{theirs:.6f}, d {abs(mine - theirs):.6f}, at most {TEMPORAL_MEAN_TOL})")
        if abs(mine - theirs) > TEMPORAL_MEAN_TOL:
            failed.append(f"float mean {mode} ESA {mine} is {abs(mine - theirs):.5f} from "
                          f"JAX's {theirs}")

    # The frames and poses of every scenario, in order, on the host.
    data, split = load_dataset(video, EVAL_BATCH, TEMPORAL_HW)
    seqs = sorted(split["eval"])
    gathered = {seq: _gather(data[seq]) for seq in seqs}
    frames = np.stack([gathered[s][0] for s in seqs])
    utils = SPEUtils.create(load_camera(video), ori_mode="classification",
                            pos_mode="classification", device=dev)
    graph = load_int8_graph(ASSET)

    def esa(seq, ori, pos):
        return float(score_batch(torch.as_tensor(gathered[seq][1], device=ori.device),
                                 torch.as_tensor(gathered[seq][2], device=ori.device),
                                 ori, pos)["esa_score"])

    # (b) The fused executor (K3, K4, K1) on all 11 at once.
    fused = build_fused_forward(graph, backend="cuda", device=dev)
    _reset_counters()
    res = _timed("fused executor: multi_sequence_inference over the 11 scenarios",
                 lambda: multi_sequence_inference(utils, fused, frames, dataset="dspeed_video"),
                 "temporal")
    torch.cuda.synchronize()
    chunks = -(-frames.shape[0] * frames.shape[1] // 64)  # frame_batch 64
    launches = {"fused": _read_counters("temporal:fused", chunks, FUSED_LAUNCHES)}
    for i, seq in enumerate(seqs):
        still = esa(seq, res["ori_still"][i], res["pos_still"][i])
        vid = esa(seq, res["ori_video"][i], res["pos_video"][i])
        want = rows[seq]["int8_carry"]["video"]["esa"]
        log(f"[temporal:accuracy] fused {seq}: still {still:.6f}, video {vid:.6f} (JAX "
            f"int8_carry video {want:.6f}, d {abs(vid - want):.6f}, at most "
            f"{EXECUTOR_ESA_TOL})")
        if abs(vid - want) > EXECUTOR_ESA_TOL:
            failed.append(f"fused {seq} video ESA {vid} is {abs(vid - want):.5f} from JAX's "
                          f"int8_carry {want}")
    # Its kernels against their plain versions at the batches this run gave
    # them: a full chunk and the tail.
    flat = frames.reshape(-1, *frames.shape[2:])
    tail = flat.shape[0] % 64 or 64
    checks = {f"fused chunk of {n}": _hold_path(
        torch, "temporal", f"fused, chunk of {n}", int8_fused, FUSED_LAUNCHES,
        lambda backend: build_fused_forward(graph, backend=backend, device=dev), part, dev,
        failed) for n, part in ((64, flat[:64]), (tail, flat[-tail:]))}

    # (c) The carry executor (K1, K2), streaming, one frame at a time.
    i = seqs.index(STREAM_SCENARIO)
    carry = SPETorch(None, utils, forward_fn=build_int8_carry_forward(graph, backend="cuda",
                                                                      device=dev), device=dev)
    fed, filtered, poses, _ = _stream(torch, np, carry, utils, frames[i], "int8 carry", card)
    launches["carry_streaming"] = _read_counters("temporal:carry streaming", len(frames[i]),
                                                 CARRY_LAUNCHES)
    checks["carry streaming, 1 frame"] = _hold_path(
        torch, "temporal", f"carry streaming, 1 frame of {STREAM_SCENARIO}", int8_carry, CARRY_LAUNCHES,
        lambda backend: build_int8_carry_forward(graph, backend=backend, device=dev),
        frames[i][:1], dev, failed)
    ori = torch.as_tensor(np.stack([p[0] for p in poses]), device=dev)
    pos = torch.as_tensor(np.stack([p[1] for p in poses]), device=dev)
    vid = esa(STREAM_SCENARIO, ori, pos)
    want = rows[STREAM_SCENARIO]["int8_carry"]["video"]["esa"]
    for k, cfg in zip(("ori", "pos"), filter_defaults("dspeed_video")):
        scan, _ = scan_filter(torch.from_numpy(np.stack(fed[k])).to(dev), cfg["n"],
                              cfg["alpha"], cfg["distance_metric"])
        d = float(np.abs(np.stack(filtered[k]) - scan.cpu().numpy()).max())
        log(f"[temporal:accuracy] carry streaming {STREAM_SCENARIO}: filtered {k} PDFs against "
            f"scan_filter over the PDFs fed: max |d| {d:.3e} (at most {STREAM_PDF_TOL})")
        if not d <= STREAM_PDF_TOL:
            failed.append(f"streaming {k} PDFs {d} from scan_filter's")
    log(f"[temporal:accuracy] carry streaming {STREAM_SCENARIO}: video ESA {vid:.6f} (JAX "
        f"int8_carry {want:.6f}, d {abs(vid - want):.6f}, at most {CARRY_ESA_TOL})")
    if abs(vid - want) > CARRY_ESA_TOL:
        failed.append(f"carry streaming video ESA {vid} is {abs(vid - want):.5f} from JAX's "
                      f"int8_carry {want}")

    # (d) Times on the card.
    model = load_experiment_model(FLAGSHIP, device=dev, n_ori_bins=utils.orientation.n_bins,
                                  n_pos_bins=utils.position.n_bins)
    _stream(torch, np, SPETorch(model, utils, device=dev), utils, frames[i], "float flagship",
            card)
    with torch.inference_mode():
        for b in (32, 64):
            x8 = torch.from_numpy(flat[:b]).to(dev)
            x = x8.float() / torch.tensor(255.0, device=dev)
            log(f"[temporal:time] forward chunk of {b} frames on the card: float "
                f"{time_ms(lambda: model(x), 5):.3f} ms, fused {time_ms(lambda: fused(x8), 5):.3f} "
                f"ms (CUDA events) on {card}")
        x = torch.from_numpy(flat[:TEMPORAL_N_FRAMES + 1]).to(dev).float() / torch.tensor(
            255.0, device=dev)
        o, p = model(x)
        last = utils.last_activ({"ori_soft": o, "pos_soft": p})
        soft = {"ori": last["ori_soft"].float(), "pos": last["pos_soft"].float()}
        for k, cfg in zip(("ori", "pos"), filter_defaults("dspeed_video")):
            one = soft[k]
            many = one.expand(len(seqs), *one.shape).contiguous()
            args = (cfg["n"], cfg["alpha"], cfg["distance_metric"])
            n_k, syncs = _kernels_and_syncs(torch, lambda: scan_filter(one, *args))
            steps = one.shape[0] - 1
            log(f"[temporal:time] scan_filter {k} ({tuple(one.shape)}, {cfg['distance_metric']}):"
                f" {time_ms(lambda: scan_filter(one, *args), 3):.3f} ms a sequence; 11 "
                f"sequences batched {time_ms(lambda: scan_filter(many, *args), 3):.3f} ms "
                f"(CUDA events); "
                f"{n_k / steps if n_k else 'not measured'} CUDA kernels a step "
                f"({n_k} over {steps} steps and the stack, torch.profiler); "
                f"{sum(syncs.values())} host synchronizations a call; on {card}")
        q, _ = utils.orientation.decode_batch(soft["ori"])
        qs = q.expand(len(seqs), *q.shape).contiguous()
        log(f"[temporal:time] decode of {soft['ori'].shape[0]} frames: orientation "
            f"{time_ms(lambda: utils.orientation.decode_batch(soft['ori']), 5):.3f} ms, position "
            f"{time_ms(lambda: utils.position.decode_batch(soft['pos']), 5):.3f} ms; continuity "
            f"{time_ms(lambda: quaternion_continuity_scan(q), 3):.3f} ms a sequence, 11 batched "
            f"{time_ms(lambda: quaternion_continuity_scan(qs), 3):.3f} ms (CUDA events) on {card}")
    if failed:
        raise AssertionError("temporal gates failed: " + "; ".join(failed))
    return launches, checks


# ---------------------------------------------------------------------------
# Deploy and serve
# ---------------------------------------------------------------------------

DEPLOY_FRAMES = 256  # the test split's first frames, served from a directory
STREAM_BATCHES = 16  # distinct batches of BATCH frames through serve_stream
FLOAT_LOGP_TOL = 1e-3  # the float artifact's log-PDFs against the live engine's
INT8_LOGP_TOL = 1e-5  # the int8 / weight-only artifacts' against their live forwards
POSE_DEG_TOL, POSE_M_TOL = 0.01, 1e-3  # the float artifact's poses against the live ones
# PERF.md §5: request p50 at batch 256 with the pageable copy (an earlier run).
PAGEABLE_P50 = {"float": 50.13, "fused": 18.62}
BENCH_PATHS = ("float", "forward", "int8_cuda", "int8_plain", "weight_only", "train")
BENCH_BATCH, BENCH_ITERS = 64, 10
SERVE_LINE = r"^(\S+\.png): q=(\[[^\]]*\]) t=(\[[^\]]*\])$"


def _max_logp(torch, a, b):
    """max |d log p| over the two soft-class PDFs of two pose dicts."""
    return max(float((torch.log(torch.as_tensor(a[k]).double())
                      - torch.log(torch.as_tensor(b[k]).double())).abs().max())
               for k in ("ori_soft", "pos_soft"))


def _pose_gap(np, a, b):
    """(max orientation deg, max position m) between two pose dicts."""
    qa, qb = np.asarray(a["ori"], np.float64), np.asarray(b["ori"], np.float64)
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    dot = np.clip(np.abs((qa * qb).sum(-1)), 0.0, 1.0)
    deg = 2.0 * np.degrees(np.arccos(dot))
    dist = np.linalg.norm(np.asarray(a["pos"], np.float64) - np.asarray(b["pos"], np.float64),
                          axis=-1)
    return float(deg.max()), float(dist.max())


def _serve_lines(np, text):
    """{frame name: (q, t)} of ``apps.serve --frames-dir``'s lines."""
    import re

    rows = {}
    for line in text.splitlines():
        m = re.match(SERVE_LINE, line)
        if m:
            rows[m.group(1)] = tuple(np.array(json.loads(m.group(i))) for i in (2, 3))
    return rows


def _deploy_exports(torch, np, dev, root):
    """(a) The float flagship, and the committed graph's int8 and
    weight-only executors (a temporary experiment: the flagship's config,
    ``model/`` linked, the asset as ``int8_graph.pkl``), exported at batch
    256 on the card by ``apps.export``; returns {variant: (path, live
    predict function)}."""
    from spef_tpu_torch.apps import export as export_app
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.quant.int8_model import build_int8_forward, build_weight_only_forward

    exp = os.path.join(root, "exp_int8")
    os.makedirs(exp)
    shutil.copy(os.path.join(FLAGSHIP, "config.yaml"), exp)
    os.symlink(os.path.join(FLAGSHIP, "model"), os.path.join(exp, "model"))
    os.symlink(ASSET, os.path.join(exp, "int8_graph.pkl"))
    graph = load_int8_graph(ASSET)
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device=dev)
    float_server, _ = _serve(torch, ["--experiment", FLAGSHIP, "--batch", str(BATCH),
                                     "--device", dev.type])
    out = {}
    for variant, argv, live in (
            ("float", ["--experiment", FLAGSHIP], float_server.predict_fn),
            ("int8", ["--experiment", exp, "--int8"],
             build_predict_fn(None, utils, forward_fn=build_int8_forward(graph, device=dev))),
            ("weight_only", ["--experiment", exp, "--int8", "--weight-only"],
             build_predict_fn(None, utils,
                              forward_fn=build_weight_only_forward(graph, device=dev)))):
        path = os.path.join(root, f"{variant}.spef")
        t0 = time.perf_counter()
        meta = export_app.main([*argv, "--out", path, "--batch", str(BATCH), "--device",
                                dev.type])
        assert meta["variant"] == variant and meta["platforms"] == [dev.type], meta
        log(f"[deploy] export {variant}: {time.perf_counter() - t0:.2f} s (trace, one run, "
            f"save), {os.path.getsize(path) / 1e6:.1f} MB")
        out[variant] = (path, live)
    return out


def _deploy_serve_artifacts(torch, np, dev, still, root, exports):
    """(b) Each artifact served in a fresh process by ``apps.serve
    --artifact --frames-dir`` on the first 256 test frames (the three at
    once); its printed poses against the artifact loaded here (print
    precision), and the loaded artifact against the live engine on the same
    frames; returns the failed gates."""
    from spef_tpu_torch.data.dataset import load_image
    from spef_tpu_torch.deploy import load_exported

    images = os.path.join(still, "test", "images")
    names = sorted(os.listdir(images))[:DEPLOY_FRAMES]
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir)
    for name in names:
        os.symlink(os.path.join(images, name), os.path.join(frames_dir, name))
    frames = np.stack([load_image(os.path.join(frames_dir, n), (240, 384)) for n in names])
    t0 = time.perf_counter()
    procs = {variant: subprocess.Popen(
        [sys.executable, "-m", "spef_tpu_torch.apps.serve", "--artifact", path, "--frames-dir",
         frames_dir, "--device", dev.type], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for variant, (path, _) in exports.items()}
    printed = {}
    for variant, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"apps.serve --artifact {variant} failed:\n{text[-3000:]}")
        printed[variant] = _serve_lines(np, text)
        stats = [line for line in text.splitlines() if line.startswith("latency stats")]
        log(f"[deploy] serve --artifact {variant}.spef --frames-dir ({len(names)} frames, a "
            f"fresh process): {len(printed[variant])} lines; {stats[-1] if stats else ''}")
    log(f"[deploy] the three serve processes: {time.perf_counter() - t0:.2f} s wall")
    failed = []
    _reset_counters()
    for variant, (path, live) in exports.items():
        t0 = time.perf_counter()
        engine = load_exported(path)
        load_s = time.perf_counter() - t0
        got, ms = engine.predict(frames)
        got = {k: v.cpu().numpy() for k, v in got.items()}
        want = {k: v.cpu().numpy() for k, v in live(torch.from_numpy(frames).to(dev)).items()}
        rows = printed[variant]
        assert sorted(rows) == names, (variant, len(rows))
        d_q = max(float(np.abs(rows[n][0] * np.sign(rows[n][0] @ got["ori"][i])
                               - got["ori"][i]).max()) for i, n in enumerate(names))
        d_t = max(float(np.abs(rows[n][1] - got["pos"][i]).max()) for i, n in enumerate(names))
        logp = _max_logp(torch, got, want)
        deg, dist = _pose_gap(np, got, want)
        log(f"[deploy] {variant}.spef: {os.path.getsize(path) / 1e6:.1f} MB, loaded in "
            f"{load_s:.2f} s, a request of {len(names)} {ms:.2f} ms; printed lines vs the loaded "
            f"artifact: max |d q| {d_q:.2e} (up to sign), max |d t| {d_t:.2e} m; artifact vs "
            f"live on {dev.type}: max |d log p| {logp:.3e}, orientation {deg:.5f} deg, "
            f"position {dist:.2e} m")
        tol = FLOAT_LOGP_TOL if variant == "float" else INT8_LOGP_TOL
        if not (d_q <= 1.01e-4 and d_t <= 1.001e-3):
            failed.append(f"{variant}: printed poses {d_q}, {d_t} from the artifact's")
        if not logp <= tol:
            failed.append(f"{variant}: log-PDFs {logp} from the live engine (at most {tol})")
        if variant == "float" and not (deg <= POSE_DEG_TOL and dist <= POSE_M_TOL):
            failed.append(f"float: poses {deg} deg, {dist} m from the live engine (at most "
                          f"{POSE_DEG_TOL}, {POSE_M_TOL})")
    _read_counters("deploy:artifacts", 0, {})  # the exported programs reach no kernel
    return failed


def _stream_in_caller(torch, predict, batches, dev, depth=2):
    """A yardstick for ``serve_stream``'s staging thread: the same ring of
    pinned buffers, copy stream and events, with each batch's copy into its
    buffer made in the caller's thread, between the forwards; yields the
    results in order."""
    import collections

    compute, copy_stream = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    ring = [torch.empty(batches[0].shape, dtype=torch.uint8, pin_memory=True)
            for _ in range(depth)]
    copied, pending = [None] * depth, collections.deque()
    for i, batch in enumerate(batches):
        slot = i % depth
        if copied[slot] is not None:
            copied[slot].synchronize()
        ring[slot].numpy()[...] = batch
        with torch.cuda.stream(copy_stream):
            x = ring[slot].to(dev, non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record(copy_stream)
        compute.wait_event(copied[slot])
        x.record_stream(compute)
        out, done = predict(x), torch.cuda.Event()
        done.record(compute)
        pending.append((out, done))
        if len(pending) >= depth:
            out, done = pending.popleft()
            done.synchronize()
            yield out
    while pending:
        out, done = pending.popleft()
        done.synchronize()
        yield out


def _deploy_stream(torch, np, dev, executor, batches, decode=True):
    """(c) ``serve_stream`` at depth 2 over distinct batches on one
    executor, counters 0 before and read after; each result, in order, bit
    for bit ``PoseServer.predict``'s on its batch; frames/s streamed,
    streamed with the staging in the caller's thread (``_stream_in_caller``)
    and sequential (host clock, results to the host in all three); the host
    synchronizations one predict makes.  ``decode=False`` streams the
    forward alone (the logits), without the decode's ``eigh``."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.serving import PoseServer, serve_stream

    build, per_forward = {"fused": (build_fused_forward, FUSED_LAUNCHES),
                          "carry": (build_int8_carry_forward, CARRY_LAUNCHES)}[executor]
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device=dev)
    fwd = build(load_int8_graph(ASSET), backend="cuda", device=dev)
    if decode:
        predict = build_predict_fn(None, utils, forward_fn=fwd)
    else:
        executor = f"{executor} forward"

        @torch.inference_mode()
        def predict(x):
            return dict(zip(("ori_logits", "pos_logits"), fwd(x)))
    server = PoseServer(predict, (240, 384, 3), max_batch=BATCH, device=dev)
    server.warmup()

    runs = {
        "streamed": lambda: serve_stream(predict, iter(batches), depth=2, device=dev),
        "caller-staged": lambda: _stream_in_caller(torch, predict, batches, dev),
        "sequential": lambda: (server.predict(b)[0] for b in batches),
    }
    # In turns, each twice; the counters read the first streamed run alone.
    seconds, results = {mode: [] for mode in runs}, {}
    for mode in ("sequential", "streamed", "caller-staged", "caller-staged", "streamed",
                 "sequential"):
        if mode == "streamed" and mode not in results:
            _reset_counters()
        t0 = time.perf_counter()
        out = [{k: np.asarray(v.cpu()) if torch.is_tensor(v) else v for k, v in res.items()}
               for res in runs[mode]()]
        seconds[mode].append(time.perf_counter() - t0)
        if mode not in results:
            results[mode] = out
            if mode == "streamed":
                launches = _read_counters(f"deploy:stream {executor}", len(batches),
                                          per_forward)
    for mode in ("streamed", "caller-staged"):
        assert len(results[mode]) == len(batches), (mode, len(results[mode]))
        for i, (a, b) in enumerate(zip(results[mode], results["sequential"])):
            for k in b:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"{mode} {executor}: batch {i} {k} differs from "
                                         f"PoseServer.predict's")
    n = len(batches) * BATCH
    x = torch.from_numpy(batches[0]).to(dev)
    _, syncs = _kernels_and_syncs(torch, lambda: predict(x))
    fps = {mode: ", ".join(f"{n / t:.1f}" for t in ts) for mode, ts in seconds.items()}
    log(f"[deploy] serve_stream depth 2, {executor}: {len(batches)} distinct batches of {BATCH}, "
        f"each bit for bit PoseServer.predict's, in order; frames/s streamed {fps['streamed']} "
        f"vs staged in the caller's thread {fps['caller-staged']} vs sequential "
        f"{fps['sequential']} (in turns: sequential, streamed, caller-staged, caller-staged, "
        f"streamed, sequential; host clock, results to the host); host synchronizations in "
        f"one predict: {syncs or 0}")
    return launches


def _deploy_copies(torch, np, dev, frames):
    """(d) The batch's host-to-device copy, pageable against pinned (CUDA
    events), the staging copy into the pinned buffer (host clock); request
    p50 / p95 at windows 1 and 256 through ``PoseServer`` (pinned staging)
    and through a pageable copy, in turns."""
    pinned = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
    assert pinned.is_pinned()
    t0 = time.perf_counter()
    for _ in range(5):
        pinned.numpy()[...] = frames
    stage_ms = (time.perf_counter() - t0) / 5 * 1e3
    pageable = time_ms(lambda: torch.from_numpy(frames).to(dev), reps=5)
    pinned_ms = time_ms(lambda: pinned.to(dev, non_blocking=True), reps=5)
    mb = frames.nbytes / 1e6
    log(f"[deploy] the {mb:.1f} MB batch to the card: pageable {pageable:.3f} ms "
        f"({mb / pageable:.1f} GB/s), pinned {pinned_ms:.3f} ms ({mb / pinned_ms:.1f} GB/s) "
        f"(CUDA events); the host's copy into the pinned buffer {stage_ms:.3f} ms (host clock)")
    def pageable(server, request):
        """The request path before pinned staging: a pageable copy."""
        t0 = time.perf_counter()
        server.predict_fn(torch.from_numpy(request).to(dev))
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    for label, extra in (("float", []),
                         ("fused", ["--int8-graph", ASSET, "--int8-executor", "fused"])):
        for window in (BATCH, 1):
            server, _ = _serve(torch, ["--experiment", FLAGSHIP, *extra, "--batch", str(window),
                                       "--device", dev.type])
            server.warmup()
            request = np.ascontiguousarray(frames[:window])
            times = {"pinned": [], "pageable": []}
            for mode in ("pageable", "pinned", "pinned", "pageable"):  # in turns, 10 each
                for _ in range(10):
                    times[mode].append(server.predict(request)[1] if mode == "pinned"
                                       else pageable(server, request))
            parts = [f"{mode} p50 {np.percentile(ts, 50):.3f} ms, p95 "
                     f"{np.percentile(ts, 95):.3f}" for mode, ts in times.items()]
            beside = (f"; pageable p50 {PAGEABLE_P50[label]} ms in PERF.md §5"
                      if window == BATCH else "")
            log(f"[deploy] {label} window {window}, 20 requests a path in turns (host clock): "
                f"{'; '.join(parts)}{beside}")


def _deploy_tools(torch, np, dev, root, failed):
    """(e) ``apps.benchmark`` on every path (counters 0 before and read
    after: the int8_cuda path's forwards only), then K1 and K2 at that
    path's own graph and batch against their plain versions (``_hold_path``,
    disagreements into ``failed``); (f) ``apps.nn_stats`` on the flagship's
    shape; returns the benchmark's launches and the checks."""
    import contextlib
    import io

    import spef_tpu_torch.quant.int8_cuda as int8_cuda
    from spef_tpu_torch.apps import benchmark, nn_stats
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA

    out = os.path.join(root, "benchmark.json")
    _reset_counters()
    t0 = time.perf_counter()
    results = benchmark.main(["--paths", *BENCH_PATHS, "--batch", str(BENCH_BATCH), "--img",
                              "240", "384", "--iters", str(BENCH_ITERS), "--json", out,
                              "--device", dev.type])
    # int8_cuda: 3 warm-up and BENCH_ITERS timed forwards
    launches = _read_counters("deploy:benchmark", 3 + BENCH_ITERS, LAYER_LAUNCHES)
    with open(out) as f:
        assert json.load(f) == results
    log(f"[deploy] apps.benchmark --batch {BENCH_BATCH} --img 240 384 --iters {BENCH_ITERS} "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(results)}")
    # Its int8_cuda forward, rebuilt as it built it: the default bit widths,
    # not the boundary recipe of the other phases.
    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                          use_keypoints=False, device=dev)
    graph = benchmark.int8_graph(spe, (240, 384), dev)
    checks = _hold_path(
        torch, "deploy", f"apps.benchmark int8_cuda, batch {BENCH_BATCH}", int8_cuda,
        LAYER_LAUNCHES, lambda backend: int8_cuda.build_cuda_forward(graph, backend=backend,
                                                                     device=dev),
        benchmark.frames(BENCH_BATCH, (240, 384)), dev, failed)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        summary = nn_stats.main(["--img-size", "240", "384"])
    for line in text.getvalue().splitlines():
        if line.startswith(("TOTAL", "Conv2D", "Dense", "BatchNorm", "Bias")):
            log(f"[deploy] nn_stats {line}")
    assert (summary["total_params"], summary["total_macs"]) == (3_805_907, 561_320_704)
    return launches, checks


def phase_deploy_serve(torch, np, dev, still):
    """Deploy and serve on the flagship: (a) exports, (b) the artifacts
    served from a directory of test frames in fresh processes, (c)
    ``serve_stream`` on ``fused`` and ``carry``, (d) pageable against pinned
    copies and request latency, (e) ``apps.benchmark``, (f)
    ``apps.nn_stats``.  Returns ({path: launches}, {path: kernel checks})."""
    root = os.path.join(REPO, "build", f"chip_smoke_deploy_{os.getpid()}")
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        exports = _deploy_exports(torch, np, dev, root)
        failed = _deploy_serve_artifacts(torch, np, dev, still, root, exports)
        del exports
        base = np.random.default_rng(5).integers(0, 256, (BATCH, 240, 384, 3), np.uint8)
        batches = [base ^ np.uint8(i) for i in range(STREAM_BATCHES)]
        launches = {f"stream_{ex}": _deploy_stream(torch, np, dev, ex, batches)
                    for ex in ("fused", "carry")}
        launches["stream_fused_forward"] = _deploy_stream(torch, np, dev, "fused", batches,
                                                          decode=False)
        del batches
        _deploy_copies(torch, np, dev, base)
        launches["benchmark_int8_cuda"], checks = _deploy_tools(torch, np, dev, root, failed)
        log(f"[deploy] phase: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError("deploy gates failed: " + "; ".join(failed))
    return launches, {"benchmark_int8_cuda": checks}


def phase_bench_construction(torch, np, dev):
    """``bench.py``'s construction on the port: a random-init ``_q`` model at
    256x256, the boundary recipe, converted, served by the int8-carry
    executor with the soft-class decode; frames/s at batch 256."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.bitwidth import boundary_bit_width
    from spef_tpu_torch.quant.convert import convert_qat_params
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward

    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device=dev)
    model = import_model("mobilenet_v2_q", "ursonet_q", bit_width=boundary_bit_width(),
                         ori_mode="classification", n_ori_bins=utils.orientation.n_bins,
                         pos_mode="classification", n_pos_bins=utils.position.n_bins,
                         device=dev)
    predict = build_predict_fn(None, utils, forward_fn=build_int8_carry_forward(
        convert_qat_params(model), device=dev))
    frames = torch.from_numpy(np.random.RandomState(1001).randint(
        0, 256, (BATCH, 256, 256, 3), np.uint8)).to(dev)
    for _ in range(3):
        out = predict(frames)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        out = predict(frames)
    torch.cuda.synchronize()
    fps = iters * BATCH / (time.perf_counter() - t0)
    assert out["ori"].shape == (BATCH, 4) and bool(torch.isfinite(out["ori"]).all())
    log(f"[bench] bench.py's construction (random-init mobilenet_v2_q + ursonet_q, "
        f"boundary recipe, int8-carry + decode, 256x256, batch {BATCH}): {fps:.1f} frames/s "
        f"(host clock over {iters} batches on the card)")


# ---------------------------------------------------------------------------
# Phase 15: the host data path
# ---------------------------------------------------------------------------

JPEG_DIR = os.path.join(REPO, "spef_tpu_torch", "assets", "speed_jpeg")
JPEG_REF = os.path.join(REPO, "spef_tpu_torch", "assets", "speed_jpeg_ref.npz")
JPEG_RECORD = os.path.join(REPO, "spef_tpu_torch", "assets", "speed_jpeg_ref.json")
F32_SOFT_TOL, F32_POS_TOL = 1e-4, 1e-3  # phase 3's: a float32 forward on two devices
SERVED_DEG_TOL, SERVED_M_TOL = 10.0, 0.5  # phase 3's: the served bf16 model against float32
JPEG_LINE = r"^(\S+\.(?:png|jpg)): q=(\[[^\]]*\]) t=(\[[^\]]*\])$"
DP_FRAMES = 64  # one step at the flagship's batch
# The weight-only forward on the card against the CPU's on the 8 JPEG frames:
# read at 0.03404 (float32 sums in another order); every layer's float32 sum
# rounded to bf16 before the epilogue moves them by 0.096-0.117 on the CPU
# (tests/test_torch_host_repairs.py holds that above this limit).
WEIGHT_ONLY_LOGIT_TOL = 0.06


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _libjpeg_here():
    """The libjpeg version macros of the headers g++ finds, or why not."""
    import re

    proc = subprocess.run(["g++", "-dM", "-E", "-x", "c++", "-"],
                          input="#include <cstdio>\n#include <jpeglib.h>\n",
                          capture_output=True, text=True)
    found = re.findall(r"#define (JPEG_LIB_VERSION|LIBJPEG_TURBO_VERSION) (\S+)", proc.stdout)
    return ", ".join(f"{k} {v}" for k, v in sorted(found)) or "no jpeglib.h"


def _served_lines(np, argv):
    """``apps.serve`` run with ``argv`` (its ``main``): (its output, {frame:
    (q, t)} of the lines it printed)."""
    import contextlib
    import re

    from spef_tpu_torch.apps import serve

    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        serve.main(argv)
    rows = {}
    for line in tee.text().splitlines():
        m = re.match(JPEG_LINE, line)
        if m:
            rows[m.group(1)] = tuple(np.array(json.loads(m.group(i))) for i in (2, 3))
    return tee.text(), rows


def _host_jpeg(torch, np, dev, failed):
    """(a) The committed JPEG frames; returns (this path's launches, its
    kernel checks)."""
    from spef_tpu_torch import native
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant import int8_fused
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    with open(JPEG_RECORD) as f:
        record = json.load(f)
    names = sorted(record["frames"])
    paths = [os.path.join(JPEG_DIR, n) for n in names]
    assert {n: _sha256(p) for n, p in zip(names, paths)} == record["frames"]
    assert _sha256(JPEG_REF) == record["npz"]
    with np.load(JPEG_REF) as z:
        ref = {k: z[k] for k in z.files}
    lacking = native.missing()
    if lacking:
        frames = ref["decoded"]
        log(f"[host:jpeg] not run: the native loader cannot be built on this host (missing "
            f"{', '.join(lacking)}), so nothing here decodes the {len(names)} JPEG frames; the "
            f"reference's decoded batch (JAX's native loader on the CPU, "
            f"{record['decode']['libjpeg']}) is served instead")
    else:
        t0 = time.perf_counter()
        frames = native.load_batch(paths, 240, 384)
        ms = (time.perf_counter() - t0) * 1e3
        mis = int((frames != ref["decoded"]).sum())
        log(f"[host:jpeg] {len(names)} JPEG frames 1920x1200 -> 240x384 by the native loader "
            f"({ms:.1f} ms, host clock): {mis} of {frames.size} values differ from JAX's "
            f"decoded batch")
        if mis:
            log(f"[host:jpeg] libjpeg here: {_libjpeg_here()}; the reference's: "
                f"{record['decode']['libjpeg']}")
            failed.append(f"JPEG decode: {mis} values differ from JAX's")
        full = native.load_batch(paths, 1200, 1920)
        twin = np.stack([native.resize_bilinear_plain(f, 240, 384) for f in full])
        tmis = int((twin != frames).sum())
        log(f"[host:jpeg] the native resize against its numpy twin: {tmis} mismatches")
        if tmis:
            failed.append(f"native resize: {tmis} values differ from the numpy twin")

    # The float32 flagship on the card against JAX's float32 on these frames.
    model = import_model(params_path=os.path.join(FLAGSHIP, "model", "parameters.msgpack"),
                         ori_mode="classification", n_ori_bins=1232, pos_mode="classification",
                         n_pos_bins=1000, device=dev, compute_dtype=torch.float32)
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device=dev)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        f32 = {k: v.cpu().numpy() for k, v in
               build_predict_fn(model, utils)(torch.from_numpy(frames).to(dev)).items()}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    d_soft = max(float(np.abs(f32[k] - ref[f"{k}_f32"]).max()) for k in ("ori_soft", "pos_soft"))
    d_pos = float(np.abs(f32["pos"] - ref["pos_f32"]).max())
    log(f"[host:jpeg] float32 flagship on the card vs JAX's float32: max |d soft| {d_soft:.3e} "
        f"(at most {F32_SOFT_TOL}), max |d pos| {d_pos:.3e} m (at most {F32_POS_TOL})")
    if not (d_soft < F32_SOFT_TOL and d_pos < F32_POS_TOL):
        failed.append(f"float32 flagship: {d_soft}, {d_pos} from JAX's")

    launches = checks = None
    for label, extra in (("float", []), ("fused", ["--int8-graph", ASSET, "--int8-executor",
                                                     "fused"])):
        argv = ["--experiment", FLAGSHIP, *extra, "--batch", str(len(names))]
        server, _ = _serve(torch, argv)
        server.warmup()
        if label == "fused":
            _reset_counters()
        pose, ms = server.predict(frames)
        if label == "fused":
            launches = _read_counters("host:jpeg fused", 1, FUSED_LAUNCHES)
        if not lacking:
            out, rows = _served_lines(np, argv + ["--frames-dir", JPEG_DIR])
            assert "Decoder: native" in out and sorted(rows) == names, sorted(rows)
            d_q = max(float(np.abs(rows[n][0] * np.sign(rows[n][0] @ pose["ori"][i])
                                   - pose["ori"][i]).max()) for i, n in enumerate(names))
            log(f"[host:jpeg] apps.serve --frames-dir {label}: {len(rows)} lines, max |d q| "
                f"{d_q:.2e} from the same frames' predict (print precision)")
            if not d_q <= 1.01e-4:
                failed.append(f"serve --frames-dir {label}: printed poses {d_q} from predict")
        deg, dist = _pose_gap(np, pose, {"ori": ref["ori_f32"], "pos": ref["pos_f32"]})
        gate = (f"at most {SERVED_DEG_TOL}, {SERVED_M_TOL}" if label == "float" else
                "int8 against float, not gated: its kernels are held below")
        log(f"[host:jpeg] {label} served on the {len(names)} frames ({ms:.2f} ms): poses vs "
            f"JAX's float32, at most {deg:.3f} deg and {dist:.4f} m ({gate})")
        if label == "float" and not (deg < SERVED_DEG_TOL and dist < SERVED_M_TOL):
            failed.append(f"{label}: poses {deg} deg, {dist} m from JAX's float32")
    graph = load_int8_graph(ASSET)
    checks = _hold_path(
        torch, "host", f"fused, the {len(names)} frames", int8_fused, FUSED_LAUNCHES,
        lambda backend: build_fused_forward(graph, backend=backend, device=dev), frames, dev,
        failed)
    return launches, checks, frames


def _dp_subset(still, root):
    """A set of the first ``DP_FRAMES`` frames of each of ``still``'s splits
    (one step, one batch each to evaluate); the images linked."""
    sub = os.path.join(root, "dp_subset", "still")
    for split in ("train", "valid", "test"):
        os.makedirs(os.path.join(sub, split))
        os.symlink(os.path.join(still, split, "images"), os.path.join(sub, split, "images"))
        with open(os.path.join(still, split, "pose.json")) as f:
            labels = json.load(f)[:DP_FRAMES]
        with open(os.path.join(sub, split, "pose.json"), "w") as f:
            json.dump(labels, f)
    return sub


def _host_training(torch, np, still, root, device_augment_fps, failed):
    """(c) The host warp in ``apps.train``, then ``--data-parallel`` at
    world size 1."""
    import contextlib

    from spef_tpu_torch.apps import train as train_app

    cfg = _flagship_config(still, os.path.join(root, "exp_host_warp.yaml"))
    tee = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = train_app.main(["--config", cfg, "--out", os.path.join(root, "host_warp"),
                                 "--epochs", "1"])["exp_host_warp"]
    assert result is not None, "apps.train with the host warp failed (traceback above)"
    assert "yaw-rotation warp: host" in tee.text()
    epoch, warp = result["epochs"][0], result["host_warp"]
    log(f"[host:train] apps.train, ROT_AUGMENT on, no --device-augment (the host warp, decoder "
        f"{result['decoder']}): {time.perf_counter() - t0:.2f} s; {epoch['batches']} steps, "
        f"step p50 {epoch['step_ms_p50']:.3f} ms (CUDA events), {epoch['frames_per_s']:.1f} "
        f"frames/s against {device_augment_fps:.1f} with the device augmentation (phase 10, "
        f"streaming loader), steps {100 * epoch['step_share']:.1f}% of the epoch; the host warp "
        f"({warp['warp']}) {warp['warped']} of {warp['frames']} frames, "
        f"{1e3 * warp['seconds'] / max(warp['warped'], 1):.3f} ms a warped frame (host clock, "
        f"summed over the loader's threads)")

    from spef_tpu_torch.data.augment_host import host_yaw_rotation, warp_backend
    from spef_tpu_torch.data.camera import SPEED_CAMERA

    frame = np.random.RandomState(0).randint(0, 256, (240, 384, 3), np.uint8)
    ori, pos = np.float32([1, 0, 0, 0]), np.float32([0, 0, 10])
    t0 = time.perf_counter()
    for i in range(32):
        host_yaw_rotation(frame, ori, pos, SPEED_CAMERA, -40.0 + 2.5 * i)
    log(f"[host:train] the host warp alone ({warp_backend()}), one thread: "
        f"{(time.perf_counter() - t0) / 32 * 1e3:.3f} ms a 240x384 frame (host clock, 32 "
        f"frames)")

    sub = _dp_subset(still, root)
    cfg = _flagship_config(sub, os.path.join(root, "exp_dp.yaml"))
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    written = {}
    try:
        for label, flag in (("without", []), ("with", ["--data-parallel"]),
                            ("without, again", [])):
            out = os.path.join(root, "dp_" + label.replace(", ", "_"))
            tee = _Tee()
            with contextlib.redirect_stdout(tee):
                result = train_app.main(["--config", cfg, "--out", out, "--epochs", "1"]
                                        + flag)["exp_dp"]
            assert result is not None and result["epochs"][0]["batches"] == 1
            assert "Data-parallel training over" not in tee.text()
            with open(os.path.join(out, "exp_dp", "model", "parameters.msgpack"), "rb") as f:
                written[label] = f.read()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    same = written["with"] == written["without"]
    log(f"[host:train] one step of {DP_FRAMES} with --data-parallel (world size 1) and without, "
        f"cuDNN deterministic: checkpoints {'identical' if same else 'DIFFERENT'} byte for byte "
        f"(two runs without the flag: "
        f"{'identical' if written['without'] == written['without, again'] else 'different'})")
    if not same:
        failed.append("--data-parallel at world size 1 changed the step")


def _host_repairs(torch, np, dev, frames, failed):
    """(d) The decode's host syncs; the weight-only forward on the card."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.quant.int8_model import build_weight_only_forward

    graph = load_int8_graph(ASSET)
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device=dev)
    predict = build_predict_fn(None, utils, forward_fn=build_fused_forward(graph, backend="cuda",
                                                                            device=dev))
    x = torch.from_numpy(frames).to(dev)
    _reset_counters()
    _, syncs = _kernels_and_syncs(torch, lambda: predict(x))
    _read_counters("host:syncs", 3, FUSED_LAUNCHES)
    # Every line outside torch's own install is held to one sync in all (the
    # decode's eigh); a sync inside torch's modules (one was seen at
    # torch/__init__.py, its stream bookkeeping) is printed beside it.
    ours = {k: n for k, n in syncs.items() if not k.startswith("torch/")}
    log(f"[host:decode] host synchronizations in one fused predict: {sum(syncs.values())}, by "
        f"line: {syncs}; on the port's lines {sum(ours.values())} (one expected: the decode's "
        f"eigh)")
    if sum(ours.values()) != 1 or not all(k.startswith("spef_tpu_torch/codec/softclass.py:")
                                          for k in ours):
        failed.append(f"predict synchronizes the host on the port's lines: {ours}")
    card = build_weight_only_forward(graph, device=dev)(x)
    cpu = build_weight_only_forward(graph, device="cpu")(torch.from_numpy(frames))
    d = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu))
    log(f"[host:weight-only] bf16 products with float32 sums on the card against the CPU's, "
        f"{len(frames)} frames: max |d logit| {d:.4g} (at most {WEIGHT_ONLY_LOGIT_TOL})")
    if not d < WEIGHT_ONLY_LOGIT_TOL:
        failed.append(f"weight-only: {d} in logits from the CPU's")


def phase_host_data_path(torch, np, dev, still, root, device_augment_fps):
    """Phase 15; returns ({path: launches}, {path: kernel checks})."""
    from spef_tpu_torch import native
    from spef_tpu_torch.data.dataset import resolve_decoder

    lacking = native.missing()
    log("[host] the native JPEG / PNG loader: "
        + (f"cannot be built here, missing {', '.join(lacking)}" if lacking
           else "g++, jpeglib.h, png.h, libjpeg and libpng present"))
    t0 = time.perf_counter()
    failed = []
    launches, checks, frames = _host_jpeg(torch, np, dev, failed)
    log(f"[host] (b) the loaders' decoder here: {resolve_decoder('auto')} (phase 8's test split "
        f"and phase 10's set went through it)")
    _host_training(torch, np, still, root, device_augment_fps, failed)
    _host_repairs(torch, np, dev, frames, failed)
    log(f"[host] phase: {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("host data path gates failed: " + "; ".join(failed))
    return {"fused_jpeg_frames": launches}, {"fused_jpeg_frames": checks}


# ---------------------------------------------------------------------------
# Phase 16: the viewer, the GUI and the autotuner's plans
# ---------------------------------------------------------------------------

VIEWER_FRAMES = 16
GUI_FRAMES = 8
TUNE_BATCH = BATCH


def _viewer(torch, np, dev, folder, still, out, engine, per_forward, card, failed):
    """``python -m spef_tpu_torch.apps.viewer --n 16 --video`` (its
    ``main``) on one engine, the counters 0 before and read after; one frame
    redrawn on the CPU from the poses it drew, held equal to its PNG."""
    import types

    from spef_tpu_torch.apps import viewer
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.png import read_png
    from spef_tpu_torch.utils.visualize import VisualizePose

    _reset_counters()
    t0 = time.perf_counter()
    records = viewer.main(["--experiment", folder, "--data", still, "--n", str(VIEWER_FRAMES),
                           "--video", "--engine", engine, "--out", out, "--device", str(dev)])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _read_counters(f"viewer:{engine}", len(records), per_forward)
    written = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    lat = [r["latency_ms"] for r in records]
    log(f"[viewer] (a) apps.viewer --n {VIEWER_FRAMES} --video --engine {engine}: "
        f"{len(written)} frames + index.html in {wall:.2f} s; per frame ESA mean "
        f"{np.mean([r['esa_score'] for r in records]):.4f} (ori "
        f"{np.mean([r['ori_error'] for r in records]):.3f} deg, pos "
        f"{np.mean([r['pos_error'] for r in records]):.4f} m), engine latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms (host clock; {card})")
    if len(written) != VIEWER_FRAMES or not os.path.isfile(os.path.join(out, "index.html")):
        failed.append(f"viewer {engine}: {len(written)} frames written")
    rec = records[-1]
    viz = VisualizePose(types.SimpleNamespace(camera=load_camera(still)))
    redrawn = viz.add_visualization(
        np.ascontiguousarray(rec["image"][..., ::-1]), true_pose=rec["true_pose"],
        pred_pose=rec["pred_pose"], temp_pose=rec["temp_pose"], show_true_pose=True,
        show_pred_pose=True, show_temp_pose=True, show_true_keypoints=True,
        show_pred_keypoints=True, show_true_bbox=True, show_pred_bbox=True)
    png = read_png(os.path.join(out, rec["filename"]))[..., ::-1]
    differ = int((png != redrawn).any(-1).sum())
    log(f"[viewer] {engine}: {rec['filename']} redrawn on the CPU from the poses the viewer "
        f"drew: {differ} pixels differ from its PNG (0 expected)")
    if differ:
        failed.append(f"viewer {engine}: {differ} pixels of {rec['filename']} differ from the "
                      f"CPU's redraw")
    return launches, records[0]["image"]


def _gui(torch, np, dev, folder, still, card, failed):
    """(b) ``apps.gui``'s server on an ephemeral port in a thread: the page,
    the state, the engine switched to ``int8-carry``, eight frames with the
    temporal filter on (counters 0 before, read after), a reset."""
    import base64
    import threading
    import urllib.request

    from spef_tpu_torch.apps.gui import GuiBackend, make_server
    from spef_tpu_torch.data.png import decode_png

    backend = GuiBackend(os.path.dirname(folder), still, device=str(dev))
    server = make_server(backend, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, r.read()

    def post(path, obj):
        req = urllib.request.Request(base + path, data=json.dumps(obj).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        status, page = get("/")
        _, body = get("/api/state")
        state = json.loads(body)
        _, state = post("/api/select", {"engine": "int8-carry"})
        post("/api/reset", {})
        _reset_counters()
        frames, wall = [], []
        for i in range(GUI_FRAMES):
            t0 = time.perf_counter()
            _, body = get(f"/api/frame?idx={i}&video=1&overlays=true_pose,pred_pose,temp_pose,"
                          "true_bbox,pred_bbox")
            wall.append((time.perf_counter() - t0) * 1e3)
            frames.append(json.loads(body))
        launches = _read_counters("gui:int8-carry", GUI_FRAMES, CARRY_LAUNCHES)
        _, reset = post("/api/reset", {})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    shapes = {decode_png(base64.b64decode(d["png_b64"])).shape for d in frames}
    lat = [d["latency_ms"] for d in frames]
    log(f"[gui] (b) apps.gui on port {server.server_address[1]}: GET / {status} "
        f"({len(page)} bytes), {len(state['experiments'])} experiment(s), splits "
        f"{state['splits']}, engines {state['engines']}, engine now {state['engine']}; "
        f"{GUI_FRAMES} frames with video on: PNG shapes {sorted(shapes)}, still ESA mean "
        f"{np.mean([d['still']['esa_score'] for d in frames]):.4f}, video ESA mean "
        f"{np.mean([d['video']['esa_score'] for d in frames]):.4f}; engine latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, request p50 {np.percentile(wall, 50):.3f} ms "
        f"(host clock; {card}); reset {reset}")
    if shapes != {(240, 384, 3)} or state["engine"] != "int8-carry" or not reset.get("ok"):
        failed.append(f"gui: PNG shapes {shapes}, engine {state['engine']}, reset {reset}")
    return launches


class _TuningTable:
    """``quant/autotune.py``'s default table, moved to ``path`` for a block
    of this script (``apps.build_int8 --autotune`` writes there) and moved
    back after it."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        import spef_tpu_torch.quant.autotune as autotune

        self.saved, autotune.TUNING_PATH = autotune.TUNING_PATH, self.path

    def __exit__(self, *exc):
        import spef_tpu_torch.quant.autotune as autotune

        autotune.TUNING_PATH = self.saved


def _plan_launches(plan):
    """The kernels one fused forward on ``plan`` launches: K3 for a fused
    stem, K4 for each fused block, K1 for the head."""
    return {"fused_stem": int(plan["stem"] == "fused"),
            "fused_mbconv": plan["blocks"].count("fused"), "int8_matmul_requant": 1}


def _tuner(torch, np, dev, root, card, failed):
    """(c) ``tune_graph`` on the committed flagship graph at batch 256 into a
    table of this run's own; the forward all-fused at the cost model's
    tiles (the default forward, which reads no table), all-fused at the
    tuned tiles and on ``plan_backends``' plan, each held against the plain
    backend (every kernel call by ``check_call``, every kernel its plan
    launches called, the logits within 0.3), timed (CUDA events); the tuned
    tiles' K4 outputs against the default tiles'."""
    import spef_tpu_torch.quant.int8_fused as int8_fused
    from spef_tpu_torch.quant.autotune import device_name, lookup_tile, tune_graph
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    graph = load_int8_graph(ASSET)
    tuned = os.path.join(root, "phase16_tuning.json")
    name = device_name(dev)
    all_fused = {"stem": "fused", "blocks": ["fused"] * len(graph["blocks"])}
    _reset_counters()
    t0 = time.perf_counter()
    table = tune_graph(graph, (240, 384), batch=TUNE_BATCH, verbose=False, device=dev,
                       path=tuned)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches = {"tune_graph": {name: fn.launches for name, fn in _counters().items()}}
    sigs = int8_fused.node_signatures(graph, (240, 384))
    log(f"[tuner] (c) tune_graph, the committed graph at 240x384, batch {TUNE_BATCH}: "
        f"{tune_s:.1f} s, launches {launches['tune_graph']}; per node (CUDA events, a chain of "
        f"10 launches on 3 inputs, median of 5 chains; {card}):")
    for i, sig in enumerate(sigs):
        e = table[sig]
        tile = f"{e['th']}x{e['tw']}" if "th" in e else "-"
        log(f"[tuner]   node {i:2d} {sig}: default {e['default_ms']:.4f} ms, best "
            f"{e['ms']:.4f} ms (tile {tile}), speedup {e['speedup']:.3f}, library form "
            f"{e['xla_ms']:.4f} ms -> {e['backend']}")

    frames = np.random.RandomState(16).randint(0, 256, (TUNE_BATCH, 240, 384, 3), np.uint8)
    x = torch.from_numpy(frames).to(dev)
    # Each forward as build_fused_forward's keywords; the plan it must run.
    planned = int8_fused.plan_backends(graph, (240, 384), path=tuned, device=name)
    forwards = {"all_fused_default_tiles": ({}, all_fused),
                "all_fused_tuned_tiles": ({"plan": all_fused, "tuning": tuned}, all_fused),
                "planned": ({"tuning": tuned}, planned)}
    checks, outs, ms = {}, {}, {}
    for label, (kw, plan) in forwards.items():
        def build(backend, kw=kw):
            return int8_fused.build_fused_forward(graph, backend=backend, device=dev, **kw)
        fwd = build("cuda")
        outs[label] = fwd(x)  # the first call resolves the plan and the tiles
        per_forward = fwd.launches_per_call
        if per_forward != _plan_launches(plan):
            failed.append(f"{label}: the forward resolved {per_forward}, its plan launches "
                          f"{_plan_launches(plan)}")
        _reset_counters()
        fwd(x)
        torch.cuda.synchronize()
        launches[label] = _read_counters(f"tuner:{label}", 1, per_forward)
        ms[label] = time_ms(lambda: fwd(x), reps=5)
        log(f"[tuner] {label}: plan stem {plan['stem']}, blocks "
            f"{''.join('F' if b == 'fused' else 'X' for b in plan['blocks'])} (F fused, "
            f"X library form), forward {ms[label]:.3f} ms at batch {TUNE_BATCH} (CUDA "
            f"events, mean of 5; {card})")
        # The kernels this plan must launch (K1, the head, always).
        names = tuple(n for n, c in _plan_launches(plan).items() if c)
        checks[label] = _hold_path(torch, "tuner", label, int8_fused, names, build,
                                   frames, dev, failed)
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(outs["all_fused_tuned_tiles"], outs["all_fused_default_tiles"]))
    # K4's outputs at the tuned tiles against the default tiles, block by block.
    recs = _recorded_calls(torch, int8_fused, ("fused_mbconv",), lambda: int8_fused.
                           build_fused_forward(graph, backend="cuda", device=dev),
                           frames, dev)["fused_mbconv"]
    mis = total = 0
    for sig, (args, kw) in zip(sigs[1:], recs):
        tile = lookup_tile(sig, tuned, name)
        if tile == (0, 0):
            failed.append(f"the tuned table has no tile of this card for {sig}")
            continue
        a = int8_fused.fused_mbconv(*args, **kw)
        b = int8_fused.fused_mbconv(*args, **kw, tile=tile)
        mis += int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
        total += a.numel()
    torch.cuda.synchronize()
    log(f"[tuner] tuned tiles against the cost model's, all 17 K4 calls of one forward: {mis} "
        f"int8 mismatches of {total} outputs (0 predicted); logits max |d| {d:.4g}; forward "
        f"ms: default tiles {ms['all_fused_default_tiles']:.3f}, tuned tiles "
        f"{ms['all_fused_tuned_tiles']:.3f}, planned {ms['planned']:.3f} ({card})")
    return launches, checks


def phase_viewer_gui_tuner(torch, np, dev, still, folder, root, card):
    """Phase 16; returns ({path: launches}, {path: kernel checks})."""
    import spef_tpu_torch.quant.int8_carry as int8_carry
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    t0 = time.perf_counter()
    failed = []
    launches, checks = {}, {}
    _viewer(torch, np, dev, folder, still, os.path.join(root, "viewer_float"), "float", {},
            card, failed)
    launches["viewer_int8_carry"], frame = _viewer(
        torch, np, dev, folder, still, os.path.join(root, "viewer_carry"), "int8-carry",
        CARRY_LAUNCHES, card, failed)
    graph = load_int8_graph(os.path.join(folder, "int8_graph.pkl"))
    checks["viewer_int8_carry"] = _hold_path(
        torch, "viewer", "int8-carry, one viewer frame", int8_carry,
        ("int8_matmul_requant", "int8_depthwise3x3"),
        lambda backend: int8_carry.build_int8_carry_forward(graph, backend=backend, device=dev),
        frame[None], dev, failed)
    launches["gui_int8_carry"] = _gui(torch, np, dev, folder, still, card, failed)
    tuner_launches, tuner_checks = _tuner(torch, np, dev, root, card, failed)
    launches.update(tuner_launches)
    checks.update(tuner_checks)
    log(f"[viewer] phase 16: {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("viewer / GUI / tuner gates failed: " + "; ".join(failed))
    return launches, checks


# ---------------------------------------------------------------------------
# Inference sharded over every local card
# ---------------------------------------------------------------------------

SHARD_PARTIAL = 10  # frames of the partial request
SHARD_REPS = 8  # requests of the window, timed
SHARD_FLOAT_LOGP_TOL = 1e-3  # float over N cards against one card, log-PDF
SHARD_KP_TOL = 1e-3  # crop-refine keypoints (normalized) over N cards against one card
# (d): the executors that lose over four cards at 256 (PERF.md §6), at a
# window four times larger.
SHARD_WIDE, SHARD_WIDE_EXECUTORS = 4 * BATCH, ("fused", "crop-refine")
SHARD_EXECUTORS = {  # name: (serve arguments, launches a forward)
    "float": (["--experiment", FLAGSHIP], {}),
    "layer": (["--experiment", FLAGSHIP, "--int8-graph", ASSET, "--int8-executor", "layer"],
              LAYER_LAUNCHES),
    "fused": (["--experiment", FLAGSHIP, "--int8-graph", ASSET, "--int8-executor", "fused"],
              FUSED_LAUNCHES),
    "carry": (["--experiment", FLAGSHIP, "--int8-graph", ASSET, "--int8-executor", "carry"],
              CARRY_LAUNCHES),
    "crop-refine": (["--experiment", KP_COARSE, "--crop-refine", KP_FINE, "--ransac"], {}),
}


def _predict_part_ms(torch, server, frames, reps=5):
    """Host-clock ms, medians over ``reps``, with the frames already on the
    server's devices: (the predict function, its launch stage alone, its
    finish stage alone); every device synchronized after each."""
    import statistics

    sharded = server._sharded
    shards = sharded.scatter(torch.from_numpy(frames))
    sharded.synchronize()
    sharded.run(shards)
    sharded.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sharded.run(shards)
        sharded.synchronize()
        t1 = time.perf_counter()
        pose = sharded.launch(shards)
        sharded.synchronize()
        t2 = time.perf_counter()
        sharded.finish(pose)
        sharded.synchronize()
        times.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
    return tuple(statistics.median(t[i] for t in times) for i in range(3))


def _recorded_launches(server):
    """Install a recorder of the server's gathered launch-stage parts (the
    int8 executors' logits, crop-refine's keypoints), as its requests serve
    them; returns (the list they go to, a function that removes it)."""
    sharded = server._sharded
    served, launch = [], sharded.launch

    def record(shards):
        pose = launch(shards)
        served.append(dict(pose))
        return pose

    sharded.launch = record
    return served, lambda: delattr(sharded, "launch")


def _read_counters_by_card(label, mesh, forwards, per_forward):
    """Each card's launch counts since ``_reset_counters``: exactly
    ``per_forward`` for each of its ``forwards``; returns {kernel: {card:
    launches}}."""
    by_card = {name: {f"cuda:{i}": n for i, n in sorted(fn.launches_by_card.items())}
               for name, fn in _counters().items()}
    log(f"[{label}] launches by card over {forwards} forwards a card: {by_card}")
    for name, counts in by_card.items():
        want = ({str(d): per_forward[name] * forwards for d in mesh.devices}
                if per_forward.get(name) else {})
        assert counts == want, (name, counts, want)
    return by_card


def _sharded_gap(torch, np, name, got, want):
    """How far the sharded server's poses are from the one-card server's:
    {what: value}, and the failures of the gates of float and crop-refine
    (the int8 executors are gated by ``_int8_gate``)."""
    failed = []
    if name == "crop-refine":
        gap = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max())
               for k in ("keypoints", "keypoints_coarse", "keypoints_fine", "crop_box")}
        gap["gate_keep_mismatches"] = int((got["gate_keep"] != want["gate_keep"]).sum())
        if max(gap[k] for k in ("keypoints", "keypoints_coarse", "keypoints_fine")) > SHARD_KP_TOL:
            failed.append(f"crop-refine keypoints {gap} beyond {SHARD_KP_TOL}")
    else:
        gap = {"soft_mismatches": int(sum((got[k] != want[k]).sum()
                                          for k in ("ori_soft", "pos_soft"))),
               "max_logp": _max_logp(torch, got, want)}
        if name == "float" and not gap["max_logp"] <= SHARD_FLOAT_LOGP_TOL:
            failed.append(f"float log-PDFs {gap['max_logp']} apart (at most "
                          f"{SHARD_FLOAT_LOGP_TOL})")
    gap["ori_deg"], gap["pos_m"] = _pose_gap(np, got, want)
    return gap, failed


def _int8_gate(torch, np, name, mesh, window, n, got, want, logits, one_logits, failed):
    """The int8 executor's served request (its first ``n`` rows of
    ``window``) over the cards against one card's.  The served logits (the
    requests' own, ``_recorded_launches``) must be bit for bit, and then
    every output too (one decode of the same logits).  Where a card's rows'
    logits differ, that is admitted only as ties: a forward built on that
    card gives those rows the served logits bit for bit and every one of its
    kernel calls meets its contract (``check_call``), and the outputs
    differ only on those rows.  Returns {what: value}; the failures go to
    ``failed``."""
    import spef_tpu_torch.quant.int8_carry as int8_carry
    import spef_tpu_torch.quant.int8_cuda as int8_cuda
    import spef_tpu_torch.quant.int8_fused as int8_fused
    from spef_tpu_torch.ops import fused_block, int8_ops
    from spef_tpu_torch.parallel.mesh import data_sharding
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    keys = ("ori_soft", "pos_soft")
    differ = np.zeros(len(window), bool)
    for k in keys:
        a, b = logits[k].cpu().numpy(), one_logits[k].cpu().numpy()
        differ |= (a != b).reshape(len(a), -1).any(-1)
    out_rows = np.zeros(n, bool)
    for k in want:
        out_rows |= (got[k] != want[k]).reshape(n, -1).any(-1)
    gap = {"logit_rows_differ": int(differ.sum()), "output_rows_differ": int(out_rows.sum()),
           "kernel_ties": 0}
    if (out_rows & ~differ[:n]).any():
        failed.append(f"{name}: {int((out_rows & ~differ[:n]).sum())} rows' outputs differ "
                      f"from one card's on equal logits")
    if not differ.any():
        return gap
    graph = load_int8_graph(ASSET)
    module, build = {"layer": (int8_cuda, int8_cuda.build_cuda_forward),
                     "fused": (int8_fused, int8_fused.build_fused_forward),
                     "carry": (int8_carry, int8_carry.build_int8_carry_forward)}[name]
    names = {"fused": ("fused_stem", "fused_mbconv", "int8_matmul_requant")}.get(
        name, ("int8_matmul_requant", "int8_depthwise3x3"))
    for rows, dev in zip(data_sharding(mesh, len(window)), mesh.devices):
        if not differ[rows].any():
            continue
        part = build(graph, backend="cuda", device=dev)(torch.from_numpy(window[rows]).to(dev))
        if not all(torch.equal(p.cpu(), logits[k][rows].cpu()) for p, k in zip(part, keys)):
            failed.append(f"{name} on {dev}: a forward on its rows does not give the served "
                          f"logits")
        calls = _recorded_calls(torch, module, names,
                                lambda: build(graph, backend="cuda", device=dev),
                                window[rows], dev)
        for kernel, recs in calls.items():
            fn = getattr(fused_block if kernel.startswith("fused") else int8_ops, kernel)
            for args, kw in recs:
                try:
                    gap["kernel_ties"] += check_call(kernel, fn(*args, **kw), args, kw)[0]
                except AssertionError as e:
                    failed.append(f"{name} on {dev}: {e}")
    return gap


def _kernels_off_the_current_card(torch, np, mesh, frames, failed):
    """(a) K1-K4 launched on the mesh's last card while ``cuda:0`` is
    current: one forward of ``layer`` (K1, K2) and of ``fused`` (K3, K4,
    K1) built on that card, at a card's rows, every call held to its plain
    version (``check_call``).  Returns {kernel: {calls, mismatches,
    max_abs_err}}."""
    import spef_tpu_torch.quant.int8_cuda as int8_cuda
    import spef_tpu_torch.quant.int8_fused as int8_fused
    from spef_tpu_torch.ops import fused_block, int8_ops
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    graph = load_int8_graph(ASSET)
    last = mesh.devices[-1]
    rows = frames[:len(frames) // mesh.size]
    checks = {}
    with torch.cuda.device(0):
        calls = _recorded_calls(torch, int8_cuda, ("int8_matmul_requant", "int8_depthwise3x3"),
                                lambda: int8_cuda.build_cuda_forward(graph, device=last),
                                rows, last)
        fused = _recorded_calls(torch, int8_fused, ("fused_stem", "fused_mbconv"),
                                lambda: int8_fused.build_fused_forward(graph, device=last),
                                rows, last)
        calls.update(fused)
        for kernel, recs in calls.items():
            fn = getattr(fused_block if kernel.startswith("fused") else int8_ops, kernel)
            mis_sum, max_err = 0, 0.0
            for args, kw in recs:
                try:
                    a = fn(*args, **kw)
                    torch.cuda.synchronize(last)
                    assert a.device == last, a.device
                    mis, err, _ = check_call(kernel, a, args, kw)
                except AssertionError as e:
                    failed.append(f"(a) {kernel} on {last}: {e}")
                    continue
                mis_sum, max_err = mis_sum + mis, max(max_err, err)
            assert torch.cuda.current_device() == 0
            checks[kernel] = {"card": str(last), "calls": len(recs), "mismatches": mis_sum,
                              "max_abs_err": max_err}
            log(f"[sharded] (a) {kernel} on {last} with cuda:0 current: {len(recs)} calls "
                f"(first input {tuple(recs[0][0][0].shape)}), {mis_sum} mismatches, each a tie "
                f"the rule admits; max |kernel - plain| {max_err:g}")
    return checks


def phase_sharded(torch, np, frames, card):
    """Phase 17: ``PoseServer`` over every visible card (``apps.serve
    --device cuda``) against the one-card server (``--device cuda:0``) for
    each executor; returns ({executor: {"launches": all cards', "by_card":
    each card's}}, (a)'s checks)."""
    from spef_tpu_torch.parallel.mesh import make_local_mesh

    t0 = time.perf_counter()
    mesh = make_local_mesh("cuda")
    n = mesh.size
    log(f"[sharded] mesh of {n} card(s): {[str(d) for d in mesh.devices]} ({card})")
    failed = []
    checks = {}
    if n > 1:
        checks = _kernels_off_the_current_card(torch, np, mesh, frames, failed)
    else:
        log("[sharded] (a) needs two or more cards: one card here, so no kernel runs off the "
            "current one")
    partial = np.zeros_like(frames)
    partial[:SHARD_PARTIAL] = frames[:SHARD_PARTIAL]  # the partial request's padded window
    launches, numbers = {}, {}
    for name, (argv, per_forward) in SHARD_EXECUTORS.items():
        served = {}
        for label, device in (("sharded", "cuda"), ("one", "cuda:0")):
            server, _ = _serve(torch, [*argv, "--batch", str(BATCH), "--device", device])
            assert server.stats()["devices"] == (n if device == "cuda" else 1), server.stats()
            _reset_counters()
            server.warmup()
            logits, remove = _recorded_launches(server)
            window, _ = server.predict(frames)
            request, _ = server.predict(frames[:SHARD_PARTIAL])
            remove()
            for _ in range(SHARD_REPS):
                server.predict(frames)
            if label == "sharded":
                launches[name] = {
                    "launches": _read_counters(f"sharded:{name}", (3 + SHARD_REPS) * n,
                                               per_forward),
                    "by_card": _read_counters_by_card(f"sharded:{name}", mesh, 3 + SHARD_REPS,
                                                      per_forward)}
            served[label] = {"server": server, "window": window, "request": request,
                             "logits": logits}
        got, want = served["sharded"], served["one"]
        gap, gate = _sharded_gap(torch, np, name, got["window"], want["window"])
        gap_partial, gate_partial = _sharded_gap(torch, np, name, got["request"],
                                                 want["request"])
        failed += gate + gate_partial
        if name in ("layer", "fused", "carry"):
            for what, win, rows, g in (("window", frames, BATCH, gap),
                                       ("request", partial, SHARD_PARTIAL, gap_partial)):
                i = 0 if what == "window" else 1
                g.update(_int8_gate(torch, np, name, mesh, win, rows, got[what], want[what],
                                    got["logits"][i], want["logits"][i], failed))
        log(f"[sharded] {name}: {n} card(s) against one card, window {BATCH}: {gap}; request "
            f"of {SHARD_PARTIAL}: {gap_partial}")
        # (c) the numbers: requests, and the predict (and its two stages)
        # over the cards against one card, at the window and at a card's rows.
        sharded, one = got["server"], want["server"]
        fps = BATCH * SHARD_REPS / (sum(list(sharded._latencies)[-SHARD_REPS:]) / 1e3)
        one_fps = BATCH * SHARD_REPS / (sum(list(one._latencies)[-SHARD_REPS:]) / 1e3)
        part_ms, launch_ms, finish_ms = _predict_part_ms(torch, sharded, frames)
        one_ms, one_launch_ms, one_finish_ms = _predict_part_ms(torch, one, frames)
        shard_ms = (_predict_part_ms(torch, one, frames[:BATCH // n])[1] if n > 1
                    else one_launch_ms)
        # How far the cards' forwards ran at once: 1 all at once, 0 one
        # after another.
        overlap = ((n * shard_ms - launch_ms) / ((n - 1) * shard_ms)) if n > 1 else None
        numbers[name] = {
            "cards": n, "frames_s": fps, "one_card_frames_s": one_fps,
            "request_p50_ms": sharded.stats()["p50_ms"],
            "one_card_request_p50_ms": one.stats()["p50_ms"],
            "predict_ms": part_ms, "one_card_predict_ms": one_ms,
            "launch_ms": launch_ms, "one_card_launch_ms": one_launch_ms,
            "one_card_launch_ms_at_a_cards_rows": shard_ms,
            "finish_ms": finish_ms, "one_card_finish_ms": one_finish_ms,
            "forwards_overlap": overlap}
        log(f"[sharded] {name}: {n} card(s) {fps:.1f} frames/s, request p50 "
            f"{numbers[name]['request_p50_ms']:.3f} ms, predict {part_ms:.3f} ms (launch "
            f"{launch_ms:.3f}, finish {finish_ms:.3f}); one card {one_fps:.1f} frames/s, p50 "
            f"{numbers[name]['one_card_request_p50_ms']:.3f} ms, predict {one_ms:.3f} ms "
            f"(launch {one_launch_ms:.3f} at {BATCH}, {shard_ms:.3f} at {BATCH // n}; finish "
            f"{one_finish_ms:.3f}); host clock, medians; overlap of the cards' forwards "
            f"{'n/a' if overlap is None else f'{overlap:.3f}'}")
        del served, got, want, sharded, one
    wide = np.concatenate([frames] * (SHARD_WIDE // BATCH))
    for name in SHARD_WIDE_EXECUTORS:
        # (d) the window of SHARD_WIDE: numbers only (the gates above hold
        # the same code at 256).
        row = {"cards": n, "window": SHARD_WIDE}
        for label, device in (("", "cuda"), ("one_card_", "cuda:0")):
            server, _ = _serve(torch, [*SHARD_EXECUTORS[name][0], "--batch", str(SHARD_WIDE),
                                       "--device", device])
            server.warmup()
            for _ in range(SHARD_REPS // 2):
                server.predict(wide)
            lat = list(server._latencies)
            row[f"{label}frames_s"] = SHARD_WIDE * len(lat) / (sum(lat) / 1e3)
            (row[f"{label}predict_ms"], row[f"{label}launch_ms"],
             row[f"{label}finish_ms"]) = _predict_part_ms(torch, server, wide, reps=3)
            del server
        numbers[f"{name}_{SHARD_WIDE}"] = row
        log(f"[sharded] (d) {name} at {SHARD_WIDE}: {row}")
    log(f"[sharded] numbers: {json.dumps(numbers)}")
    log(f"[sharded] phase 17: {time.perf_counter() - t0:.1f} s on {n} card(s)")
    if failed:
        raise AssertionError("sharded serving gates failed: " + "; ".join(failed))
    return launches, checks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    import numpy as np

    import spef_tpu_torch  # noqa: F401 - fails here when run outside the repo

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = phase_card_and_build()
    log(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    phase_variants(torch, dev)
    frames = np.random.RandomState(0).randint(0, 256, (BATCH, 240, 384, 3), np.uint8)
    phase_float(torch, np, dev, frames)
    layer = phase_int8(torch, np, dev, frames, "layer")
    fused = phase_int8(torch, np, dev, frames, "fused")
    log_executor_distance(np, layer, fused)
    qmodel, graph, amaxes = phase_build(torch, np, dev)
    exp_dir = os.path.join(REPO, "build", f"chip_smoke_qat_experiment_{os.getpid()}")
    try:
        write_qat_experiment(np, qmodel, graph, amaxes, exp_dir)
        del qmodel
        carry_launches = phase_carry(torch, np, dev, frames, exp_dir, graph)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    split_root = os.path.join(REPO, "build", f"chip_smoke_dspeed_{os.getpid()}")
    try:
        still, valid_still = write_eval_splits(split_root)
        accuracy_launches, batches = phase_accuracy(torch, np, dev, still, valid_still)
        phase_keypoints(torch, np, dev, still, batches)
        del batches
        deploy_launches, deploy_checks = phase_deploy_serve(torch, np, dev, still)
    finally:
        shutil.rmtree(split_root, ignore_errors=True)
    temporal_root = os.path.join(REPO, "build", f"chip_smoke_temporal_{os.getpid()}")
    try:
        temporal_launches, temporal_checks = phase_temporal(
            torch, np, dev, write_scenarios(temporal_root), card)
    finally:
        shutil.rmtree(temporal_root, ignore_errors=True)
    phase_bench_construction(torch, np, dev)
    layer_launches, fused_launches = layer[0], fused[0]
    # K1 and K2 are on three paths: their rows keep the layer executor's
    # counts (their times are of those calls); the others are beside them.
    launches = {name: layer_launches[name] or fused_launches[name] for name in KERNELS}
    rows = phase_kernels(torch, dev, frames, launches, graph)
    train_root = os.path.join(REPO, "build", f"chip_smoke_train_{os.getpid()}")
    try:
        still, cfg, device_augment_fps = phase_training(torch, np, dev, train_root)
        build_launches, build_folder = phase_deploy_build(torch, np, dev, still, cfg, train_root,
                                                         card)
        host_launches, host_checks = phase_host_data_path(torch, np, dev, still, train_root,
                                                          device_augment_fps)
        viewer_launches, viewer_checks = phase_viewer_gui_tuner(torch, np, dev, still,
                                                                build_folder, train_root, card)
    finally:
        shutil.rmtree(train_root, ignore_errors=True)
    sharded_launches, sharded_checks = phase_sharded(torch, np, frames, card)
    for row in rows:
        if row["name"] == "int8_matmul_requant":
            row["launches_fused_path"] = fused_launches["int8_matmul_requant"]
        if row["name"] in CARRY_LAUNCHES:
            # serve --int8-executor carry --batch 256, 9 forwards (phase_carry)
            row["launches_carry_path"] = carry_launches[row["name"]]
        # the test split's evaluation by each executor (phase_accuracy)
        row["launches_accuracy_path"] = {
            name: counts[row["name"]] for name, counts in accuracy_launches.items()
            if counts[row["name"]]}
        # the 11 scenarios through the fused executor, one scenario streamed
        # through the carry (phase_temporal)
        row["launches_temporal_path"] = {
            path: counts[row["name"]] for path, counts in temporal_launches.items()
            if counts[row["name"]]}
        # ... and held against the plain version at those paths' batches
        row["temporal_path_check"] = {
            path: checks[row["name"]] for path, checks in temporal_checks.items()
            if row["name"] in checks}
        # serve_stream over 16 batches on fused and carry, and
        # apps.benchmark's int8_cuda path (phase_deploy_serve)
        row["launches_deploy_path"] = {
            path: counts[row["name"]] for path, counts in deploy_launches.items()
            if counts[row["name"]]}
        # ... the benchmark's int8_cuda calls held against the plain version
        row["deploy_path_check"] = {
            path: checks[row["name"]] for path, checks in deploy_checks.items()
            if row["name"] in checks}
        # the committed JPEG frames through the fused executor (phase 15)
        row["launches_host_path"] = {
            path: counts[row["name"]] for path, counts in host_launches.items()
            if counts[row["name"]]}
        row["host_path_check"] = {
            path: checks[row["name"]] for path, checks in host_checks.items()
            if row["name"] in checks}
        # the viewer and the GUI on int8-carry; the tuner and its three
        # forwards at batch 256 (phase 16)
        row["launches_viewer_gui_tuner_path"] = {
            path: counts[row["name"]] for path, counts in viewer_launches.items()
            if counts[row["name"]]}
        row["viewer_gui_tuner_path_check"] = {
            path: checks[row["name"]] for path, checks in viewer_checks.items()
            if row["name"] in checks}
        # each executor served over every card (phase 17): the launches of
        # all cards, and each card's as its counter read them
        row["launches_sharded_path"] = {
            path: {"launches": counts["launches"][row["name"]],
                   "by_card": counts["by_card"][row["name"]]}
            for path, counts in sharded_launches.items() if counts["launches"][row["name"]]}
        # ... and launched on the last card while cuda:0 is current (two or
        # more cards)
        if row["name"] in sharded_checks:
            row["sharded_path_check"] = sharded_checks[row["name"]]
        if row["name"] in CARRY_LAUNCHES:
            # the graph apps.build_int8 wrote, one request of 64 frames
            # through carry and layer (phase_deploy_build)
            row["launches_build_path"] = {
                name: counts[row["name"]] for name, counts in build_launches.items()}
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
