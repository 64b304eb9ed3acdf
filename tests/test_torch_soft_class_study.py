"""Port parity of the soft-classification codec study:
``spef_tpu_torch.apps.soft_class_study`` against ``spef_tpu.apps.soft_class_study``
on the CPU, function by function on poses made with numpy, the grid study
as a whole, and the two CLIs' output trees.

Tolerances: both packages encode and decode in float32; the orientation
decode's 4x4 ``eigh`` rounds apart, more where a flat PDF makes the top
eigenvalues nearly equal (the grid's poles).  Mean round-trip errors within
1e-3 deg and 1e-5 m, frame-to-frame PDF distances within 1e-5; the grid's
per-pose errors within 0.1 deg and 1e-4 m (their means within 1e-3 deg and
1e-5 m); the range filter and the statistics are the same numpy code (exact
on the same errors).  The CLI's random orientations come from a ``torch.Generator``
where JAX uses ``PRNGKey``: the two apps' orientation numbers differ, their
position numbers (numpy draws) and the tumble's PDF distances do not.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spef_tpu.apps.soft_class_study as jax_app
import spef_tpu_torch.apps.soft_class_study as port_app

torch.set_num_threads(1)


def _poses(n=64, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    p = np.stack([rng.uniform(-8, 8, n), rng.uniform(-6, 6, n), rng.uniform(3, 33, n)],
                 -1).astype(np.float32)
    return q, p


@pytest.mark.parametrize("n_bins,smooth", [(6, 3), (8, 2), (12, 3), (16, 5)])
def test_roundtrip_errors_match_jax(n_bins, smooth):
    q, p = _poses(seed=n_bins)
    assert port_app.ori_roundtrip_error(n_bins, smooth, torch.from_numpy(q)) == pytest.approx(
        jax_app.ori_roundtrip_error(n_bins, smooth, jnp.asarray(q)), abs=1e-3)
    assert port_app.pos_roundtrip_error(n_bins, 50 * smooth, torch.from_numpy(p)) == \
        pytest.approx(jax_app.pos_roundtrip_error(n_bins, 50 * smooth, jnp.asarray(p)), abs=1e-5)
    got = port_app.pdf_frame_distances(n_bins, smooth, torch.from_numpy(q[:24]))
    want = jax_app.pdf_frame_distances(n_bins, smooth, jnp.asarray(q[:24]))
    assert got.shape == want.shape == (23,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


GRIDS = {
    "orientation": ({"z": (-180.0, 180.0), "y": (-90.0, 90.0), "x": (-180.0, 180.0)}, 45.0,
                    [2, 3], {"z": (-180.0, 180.0), "y": (-85.0, 85.0), "x": (-180.0, 180.0)},
                    0.1, 1e-3),
    "position": ({"z": (-2.0, 40.0), "y": (-12.0, 12.0), "x": (-16.0, 16.0)}, 4.0, [100, 150],
                 {"z": (3.0, 35.0), "y": (-10.0, 10.0), "x": (-10.0, 10.0)}, 1e-4, 1e-5),
}


@pytest.mark.parametrize("pose_type", sorted(GRIDS))
def test_grid_sweep_filter_and_statistics_match_jax(pose_type):
    pose_range, step, smooths, usable, tol, mean_tol = GRIDS[pose_type]
    want, axes = jax_app.grid_sweep(pose_type, [6, 8], smooths, pose_range, step)
    got, got_axes = port_app.grid_sweep(pose_type, [6, 8], smooths, pose_range, step,
                                        device="cpu")
    assert got.shape == want.shape and sorted(got_axes) == sorted(axes)
    for k in axes:
        np.testing.assert_array_equal(got_axes[k], axes[k])
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert abs(got - want).mean() <= mean_tol

    cut, cut_axes = port_app.filter_usable_range(want, axes, usable)
    jcut, jcut_axes = jax_app.filter_usable_range(want, axes, usable)
    np.testing.assert_array_equal(cut, jcut)
    stats, jstats = port_app.error_statistics(cut), jax_app.error_statistics(jcut)
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], jstats[k])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_writes_jax_tree_and_numbers(tmp_path):
    argv = ["--n-poses", "32", "--ori-bins", "6", "8", "--ori-smooth", "3",
            "--pos-bins", "8", "--pos-smooth", "100", "150"]
    port_app.main(["--out", str(tmp_path / "port"), "--device", "cpu", *argv])
    jax_app.main(["--out", str(tmp_path / "jax"), *argv])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "ori_roundtrip_heatmap.png", "pos_roundtrip_heatmap.png", "soft_class_results.json"]
    got = json.load(open(tmp_path / "port" / "soft_class_results.json"))
    want = json.load(open(tmp_path / "jax" / "soft_class_results.json"))
    assert sorted(got) == sorted(want) == ["ori", "pdf_distance", "pos"]
    assert sorted(got["ori"]) == sorted(want["ori"])
    assert all(0 < v < 30 for v in got["ori"].values())  # another draw of orientations
    for k, v in want["pos"].items():
        assert got["pos"][k] == pytest.approx(v, abs=1e-5), k
    for k, v in want["pdf_distance"].items():
        assert got["pdf_distance"][k] == pytest.approx(v, rel=1e-4), k


def test_grid_study_cli_matches_jax(tmp_path):
    """The grid study as a whole: the same figures and arrays, its summary
    within the grid's tolerances."""
    argv = ["--grid", "--ori-bins", "6", "8", "--ori-smooth", "2", "3",
            "--pos-bins", "6", "8", "--pos-smooth", "100", "150",
            "--grid-step-deg", "60", "--grid-step-m", "6"]
    port_app.main(["--out", str(tmp_path / "port"), "--device", "cpu", *argv])
    jax_app.main(["--out", str(tmp_path / "jax"), *argv])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for tag, tol in (("ori", 0.1), ("pos", 1e-4)):
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"{tag}_grid_errors.npy"),
                                   np.load(tmp_path / "jax" / f"{tag}_grid_errors.npy"),
                                   rtol=0, atol=tol)
    got = json.load(open(tmp_path / "port" / "grid_study.json"))
    want = json.load(open(tmp_path / "jax" / "grid_study.json"))
    assert sorted(got) == sorted(want) == ["orientation", "position"]
    for pose_type, tol in (("orientation", 0.1), ("position", 1e-4)):
        for stat, cells in want[pose_type].items():
            assert sorted(got[pose_type][stat]) == sorted(cells)
            for cell, v in cells.items():
                assert got[pose_type][stat][cell] == pytest.approx(v, abs=tol), (stat, cell)
