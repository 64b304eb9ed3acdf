"""Port parity: ``spef_tpu_torch.temporal.report`` against
``spef_tpu.temporal.report``.

  * ``sequence_metrics`` on the same random truth, still and video poses and
    distances: every statistic within a relative 1e-5 (float32 Euler angles
    on both sides, numpy statistics).
  * ``write_workbooks``: the same CSV files as JAX's (pandas ``to_csv``) on
    the same statistics, cell by cell and byte for byte; no ``.xlsx`` on
    either side here (no Excel engine is installed).
  * ``sequence_figures``: the same nine file names in the same folder.
  * Without matplotlib, ``sequence_figures`` raises an ``ImportError`` that
    names ``--plots``; the workbooks need no matplotlib.
"""

import csv
import os
import sys

import numpy as np
import pytest

from spef_tpu.temporal import report as jreport
from spef_tpu_torch.temporal import report

T = 30


def _case(seed, video=True):
    rs = np.random.RandomState(seed)

    def quats(scale):
        q = np.array([0.5, 0.5, 0.5, 0.5]) + rs.randn(T, 4) * scale
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)

    truth_o, truth_p = quats(0.3), rs.randn(T, 3).astype(np.float32) + [0, 0, 12]
    args = (truth_o, truth_p, quats(0.3), truth_p + rs.randn(T, 3).astype(np.float32) * 0.3)
    kwargs = {}
    if video:
        kwargs = {"video_ori": quats(0.3),
                  "video_pos": truth_p + rs.randn(T, 3).astype(np.float32) * 0.2,
                  "ori_distance": rs.rand(T).astype(np.float32),
                  "pos_distance": rs.rand(T).astype(np.float32)}
    return args, kwargs


@pytest.mark.parametrize("video", [True, False])
def test_sequence_metrics_match_jax(video):
    args, kwargs = _case(0, video)
    got, want = report.sequence_metrics(*args, **kwargs), jreport.sequence_metrics(*args, **kwargs)
    for g, w in zip(got, want):  # still, video, distances
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0, err_msg=k)
    assert bool(got[1]) == video and bool(got[2]) == video


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_workbooks_match_jax_cell_by_cell(tmp_path):
    books = {"still": {}, "video": {}, "dist": {}}
    for i, (seq, video) in enumerate((("S", True), ("TIR", True), ("CAR", False))):
        args, kwargs = _case(i + 1, video)
        books["still"][seq], books["video"][seq], books["dist"][seq] = \
            jreport.sequence_metrics(*args, **kwargs)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    report.write_workbooks(mine, books["still"], books["video"], books["dist"])
    jreport.write_workbooks(theirs, books["still"], books["video"], books["dist"])
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names
    assert "video_metrics_CAR.csv" not in names and len(names) == 7
    for name in names:
        got, want = _read(os.path.join(mine, name)), _read(os.path.join(theirs, name))
        assert len(got) == 6 and got[0][0] == "", name
        assert got == want, name
        with open(os.path.join(mine, name), "rb") as f, open(os.path.join(theirs, name),
                                                             "rb") as g:
            assert f.read() == g.read(), name


def test_figure_names_match_jax(tmp_path):
    args, kwargs = _case(4)
    got = report.sequence_figures(str(tmp_path / "port"), "TITR", *args, dpi=20, **kwargs)
    want = jreport.sequence_figures(str(tmp_path / "jax"), "TITR", *args, dpi=20, **kwargs)
    assert os.path.basename(got) == os.path.basename(want) == "TITR"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert len(os.listdir(got)) == 9


def test_figures_without_matplotlib_name_the_flag(tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    args, kwargs = _case(5)
    with pytest.raises(ImportError, match="--plots needs matplotlib"):
        report.sequence_figures(str(tmp_path), "S", *args, **kwargs)
    assert not (tmp_path / "S").exists()
    report.write_workbooks(str(tmp_path), *(dict(S=m) for m in report.sequence_metrics(
        *args, **kwargs)))
    assert (tmp_path / "still_metrics_S.csv").exists()
