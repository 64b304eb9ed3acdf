"""The port's tracing (``utils/profiling.py``) and the spans and counters it
places at the layers' boundaries.

  * With no profiler, ``span`` and ``timed`` give one shared null context
    and ``count`` counts nothing; from many threads at once, no count is
    lost.
  * Under ``torch.profiler``: a small float predict function records
    ``spef.predict.launch`` then ``spef.predict.finish``, with the decode's
    ``spef.decode.eigh`` and ``spef.decode.pos`` inside the finish; a train
    step records ``spef.augment`` and the four ``spef.train.*`` stages in
    order inside the step; the serving stream's staging thread counts its
    copies, bytes and waits (its pinning replaced by plain host tensors on
    the CPU; the pinned ring itself in the ``cuda`` case).
  * ``trace`` records a span made on a second thread.
"""

import contextlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from spef_tpu_torch.utils import profiling

torch.set_num_threads(1)

HW = (32, 32)


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _spans(prof, prefix="spef."):
    """(name, start, end) of the spans the host recorded whose names start
    with ``prefix``, by start (not their copies on the device's timeline)."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefix) and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_without_a_profiler_spans_are_one_null_context_and_nothing_counts():
    assert not profiling.tracing()
    assert profiling.span("serve.predict") is profiling.span("train.backward")
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    assert profiling.timed("stage.copy", 10) is profiling.span("x")
    with profiling.timed("stage.copy", 10):
        profiling.count("serve.event_syncs")
    profiling.count_time("stage.queued", 10)
    assert profiling.counters() == {}


def test_counters_count_only_while_a_profiler_runs():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing()
        profiling.count("a")
        profiling.count("a", 4)
        with profiling.timed("b"):
            pass
        with profiling.timed("c", 7):
            pass
        profiling.count_time("c", 3, 5)
        got = profiling.counters()
    profiling.count("a")
    profiling.count_time("c", 3, 5)
    assert got["a"] == 5 and got["b"] == 1 and got["b_ns"] >= 0
    assert got["c"] == 2 and got["c_ns"] >= 3 and got["c_bytes"] == 12
    assert sorted(got) == ["a", "b", "b_ns", "c", "c_bytes", "c_ns"]
    got["a"] = 0  # a copy
    assert profiling.counters()["a"] == 5
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_counts_from_many_threads_are_not_lost():
    threads, n = 4 * (os.cpu_count() or 1), 2000

    def work():
        for _ in range(n):
            profiling.count("x")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert profiling.counters() == {"x": threads * n}


def _float_predict(pos_mode="classification"):
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model

    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                          pos_mode=pos_mode, n_pos_bins_per_dim=4, use_keypoints=False,
                          device="cpu")
    model = import_model("small_mobile", "ursonet", ori_mode="classification",
                         n_ori_bins=spe.orientation.n_bins, pos_mode=pos_mode,
                         n_pos_bins=spe.position.n_bins, img_size=HW, seed=5, device="cpu",
                         compute_dtype=torch.float32)
    return build_predict_fn(model, spe), spe, model


def _frames(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3), np.uint8)


def test_predict_records_launch_then_finish_with_the_decode_inside():
    fn, _, _ = _float_predict()
    images = torch.from_numpy(_frames(2, 0))
    want = fn(images)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = fn(images)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["spef.predict.launch", "spef.predict.finish",
                                     "spef.decode.eigh", "spef.decode.pos"]
    launch, finish, eigh, pos = spans
    assert launch[2] <= finish[1]
    assert _inside(eigh, finish) and _inside(pos, finish) and eigh[2] <= pos[1]
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if eigh[1] <= e.start_ns() <= eigh[2]}
    assert "aten::linalg_eigh" in names


def test_train_step_records_augment_and_its_four_stages_in_order():
    from spef_tpu_torch.data.augment import train_augment
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state, train_update

    _, spe, model = _float_predict()
    opt, sched = import_optimizer(model.parameters(), 1e-3, "Adam")
    state = create_train_state(model, opt, sched)
    gen = torch.Generator().manual_seed(0)
    rs = np.random.RandomState(1)
    images = torch.from_numpy(rs.rand(2, *HW, 3).astype(np.float32))
    q = torch.nn.functional.normalize(torch.from_numpy(rs.randn(2, 4).astype(np.float32)), dim=-1)
    pos = torch.tensor([[0.5, -0.3, 12.0], [-1.0, 0.8, 20.0]])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("test.step"):
            images, q, pos = train_augment(gen, images, q, pos, SPEED_CAMERA, rot_augment=True,
                                           other_augment=True)
            loss, _ = train_update(state, images, spe.encode_targets(q, pos), spe,
                                   SPELoss("classification", "classification"), gen,
                                   clip_batchnorm=True)
    assert torch.isfinite(loss) and state.step == 1
    (step,) = _spans(prof, "test.step")
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["spef.augment", "spef.train.forward", "spef.train.loss",
                                     "spef.train.backward", "spef.train.optimizer"]
    assert all(_inside(s, step) for s in spans)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_trace_records_a_span_made_on_a_second_thread(tmp_path):
    def work():
        with profiling.span("test.worker"):
            torch.ones(4).sum()

    with profiling.trace(str(tmp_path)) as prof:
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=60)
        with profiling.span("test.main"):
            torch.ones(4).sum()
    assert not worker.is_alive()
    spans = {e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("spef.")}
    assert sorted(spans) == ["spef.test.main", "spef.test.worker"]
    assert any(e.key == "aten::sum" for e in prof.key_averages())
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"spef.test.main", "spef.test.worker"} <= names


class _Copied:
    """A stand-in for the copy's CUDA event, already complete."""

    def synchronize(self):
        pass


def test_stager_counts_its_windows_bytes_and_waits(monkeypatch):
    """Every wait and copy is counted with its time, and the bytes with the
    copies; the pull is a span only."""
    import spef_tpu_torch.serving as serving

    monkeypatch.setattr(serving, "_pinned", lambda shape, dtype: torch.from_numpy(
        np.empty(shape, dtype)))
    batches = [_frames(2, 10 + i) for i in range(3)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        stager = serving._Stager(iter(batches), depth=2)
        try:
            for i, batch in enumerate(batches):
                slot, buf = stager.next()
                np.testing.assert_array_equal(buf.numpy(), batch)
                stager.release(slot, _Copied())
            assert stager.next() is None
        finally:
            stager.close()
        got = profiling.counters()
    assert not stager._thread.is_alive()
    assert got["stage.copy"] == got["stage.slot_wait"] == got["stage.queued"] == 3
    assert got["stage.copy_bytes"] == 3 * batches[0].nbytes
    for key in ("stage.slot_wait_ns", "stage.copy_ns", "stage.queued_ns"):
        assert got[key] >= 0, key
    assert sorted(got) == ["stage.copy", "stage.copy_bytes", "stage.copy_ns", "stage.queued",
                           "stage.queued_ns", "stage.slot_wait", "stage.slot_wait_ns"]


def test_the_stream_on_the_cpu_spans_each_predict():
    from spef_tpu_torch.serving import serve_stream

    fn, _, _ = _float_predict(pos_mode="regression")
    batches = [_frames(2, 20 + i) for i in range(3)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = list(serve_stream(fn, batches, depth=2, device="cpu"))
    assert len(outs) == 3
    names = [s[0] for s in _spans(prof)]
    assert names.count("spef.serve.predict") == 3
    assert names.count("spef.predict.finish") == 3 and "spef.decode.pos" not in names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stream's pinned ring and side stream")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_stream_on_the_card_stages_three_windows(card):
    from spef_tpu_torch.serving import serve_stream

    batches = [_frames(4, 30 + i) for i in range(3)]

    def predict(x):
        with profiling.span("test.predict"):
            return {"sum": x.float().sum((1, 2, 3))}

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        outs = [o["sum"].cpu() for o in serve_stream(predict, batches, depth=2, device=card)]
        got = profiling.counters()
    for out, batch in zip(outs, batches):
        np.testing.assert_array_equal(out.numpy(), batch.astype(np.float32).sum((1, 2, 3)))
    assert got["stage.copy"] == got["stage.queued"] == 3
    assert got["stage.copy_bytes"] == 3 * batches[0].nbytes
    assert got["serve.event_syncs"] == 3
    names = [s[0] for s in _spans(prof)]
    for name in ("spef.serve.wait_staged", "spef.serve.h2d", "spef.serve.predict",
                 "spef.serve.wait_done"):
        assert names.count(name) == (4 if name == "spef.serve.wait_staged" else 3), name
