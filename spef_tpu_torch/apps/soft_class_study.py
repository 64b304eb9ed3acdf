"""Soft-classification codec study, on one GPU.

Counterpart of ``spef_tpu.apps.soft_class_study``: sweeps (n_bins_per_dim x
smooth_factor) over a set of poses, or with ``--grid`` over a pose grid,
and measures the encode -> decode round-trip error of the orientation and
position codecs (``codec/softclass.py``), plus the frame-to-frame PDF L2
distances used to tune the temporal filter's alpha; writes the results as
JSON and the figures (matplotlib, imported only where a figure is drawn).
Each (n_bins, smooth) cell encodes and decodes the whole pose set at once.

The JAX package draws its random orientations with ``PRNGKey(seed)``; the
port draws them with a ``torch.Generator`` seeded the same way, so the two
apps' pose sets (and their numbers) differ, while each function gives the
JAX function's result on the same poses.  The grid study has no random
draws.

Usage:
    python -m spef_tpu_torch.apps.soft_class_study --out experiments/soft_class \\
        [--n-poses 512] [--ori-bins 8 10 12 16] [--ori-smooth 1 2 3 4 5] [--grid] \\
        [--device cuda]

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

__all__ = ["ori_roundtrip_error", "pos_roundtrip_error", "pdf_frame_distances", "grid_sweep",
           "filter_usable_range", "error_statistics", "plot_smooth_lines", "plot_pose_heatmap",
           "plot_3d_scatter", "plot_heatmap", "run_grid_study", "main"]


def ori_roundtrip_error(n_bins: int, smooth: float, quats: torch.Tensor) -> float:
    """Mean encode -> decode angle error (degrees) of the orientation codec
    on ``quats (N, 4)``."""
    from spef_tpu_torch.codec.softclass import OrientationSoftClassification
    from spef_tpu_torch.pose.rotations import quat_angle

    codec = OrientationSoftClassification.create(n_bins, smooth, delete_unused_bins=True,
                                                 device=quats.device)
    dec, _ = codec.decode(codec.encode(quats))
    return float(torch.rad2deg(torch.mean(quat_angle(quats, dec))))


def pos_roundtrip_error(n_bins: int, smooth: float, poss: torch.Tensor) -> float:
    """Mean encode -> decode distance (metres) of the position codec on
    ``poss (N, 3)``."""
    from spef_tpu_torch.codec.softclass import PositionSoftClassification

    codec = PositionSoftClassification.create(n_bins, smooth, device=poss.device)
    dec = codec.decode(codec.encode(poss))
    return float(torch.mean(torch.linalg.norm(dec - poss, dim=-1)))


def pdf_frame_distances(n_bins: int, smooth: float, quats_seq: torch.Tensor) -> np.ndarray:
    """L2 distance between consecutive-frame encodings (alpha tuning)."""
    from spef_tpu_torch.codec.softclass import OrientationSoftClassification

    codec = OrientationSoftClassification.create(n_bins, smooth, delete_unused_bins=True,
                                                 device=quats_seq.device)
    pdfs = codec.encode(quats_seq)
    return torch.linalg.norm(pdfs[1:] - pdfs[:-1], dim=-1).cpu().numpy()


def grid_sweep(pose_type: str, n_bins: list, smooths: list, pose_range: dict,
               step: float, device="cuda") -> tuple:
    """Full (n_bins x smooth x pose-grid) round-trip error sweep, one batched
    encode / decode a cell.

    Returns (errors[nb, ns, nz, ny, nx], axes dict).  For orientation the
    grid axes are (yaw, pitch, roll) degrees; for position (z, y, x) metres.
    """
    from spef_tpu_torch.codec.softclass import (
        OrientationSoftClassification,
        PositionSoftClassification,
    )
    from spef_tpu_torch.pose.rotations import euler2quat, quat_angle

    zs = np.arange(pose_range["z"][0], pose_range["z"][1] + step, step)
    ys = np.arange(pose_range["y"][0], pose_range["y"][1] + step, step)
    xs = np.arange(pose_range["x"][0], pose_range["x"][1] + step, step)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    grid = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1).astype(np.float32)

    if pose_type == "orientation":
        # grid columns are (roll, pitch, yaw) = (x, y, z) axes.
        poses = euler2quat(torch.from_numpy(grid[:, ::-1].copy()).to(device))
    else:
        poses = torch.from_numpy(grid).to(device)

    errors = np.zeros((len(n_bins), len(smooths), len(zs), len(ys), len(xs)))
    for i, b in enumerate(n_bins):
        for j, s in enumerate(smooths):
            if pose_type == "orientation":
                codec = OrientationSoftClassification.create(b, s, delete_unused_bins=True,
                                                             device=device)
                dec, _ = codec.decode(codec.encode(poses))
                err = torch.rad2deg(quat_angle(poses, dec))
            else:
                codec = PositionSoftClassification.create(
                    b, s,
                    min_lim=(pose_range["x"][0], pose_range["y"][0], pose_range["z"][0]),
                    max_lim=(pose_range["x"][1], pose_range["y"][1], pose_range["z"][1]),
                    device=device,
                )
                dec = codec.decode(codec.encode(poses))
                err = torch.linalg.norm(dec - poses, dim=-1)
            errors[i, j] = err.cpu().numpy().reshape(len(zs), len(ys), len(xs))
    return errors, {"z": zs, "y": ys, "x": xs}


def filter_usable_range(errors, axes, usable: dict):
    """Restrict the error tensor to the usable pose sub-range."""
    masks = {k: (axes[k] >= usable[k][0]) & (axes[k] <= usable[k][1]) for k in axes}
    out = errors[:, :, masks["z"]][:, :, :, masks["y"]][:, :, :, :, masks["x"]]
    return out, {k: axes[k][m] for k, m in masks.items()}


def error_statistics(errors) -> dict:
    """min / max / mean / std / median over the pose grid."""
    ax = (2, 3, 4)
    return {
        "min": errors.min(axis=ax), "max": errors.max(axis=ax),
        "mean": errors.mean(axis=ax), "std": errors.std(axis=ax),
        "median": np.median(errors, axis=ax),
    }


# EN / FR figure-label sets (the JAX package's).
_L10N = {
    "en": {
        "roundtrip": "round-trip error",
        "smooth": "smooth factor",
        "bins": "bins/dim",
        "vs_smooth": "{pose} error vs smooth factor",
        "grid_stat": "{pose} round-trip {stat} [{unit}]",
        "pose_heat": "{pose} error over (z, y), {label}",
        "scatter": "{pose} error, {label}",
        "pose_names": {"orientation": "orientation", "position": "position"},
        "stat_names": {"mean": "mean", "median": "median", "std": "std",
                       "min": "min", "max": "max"},
    },
    "fr": {
        "roundtrip": "erreur aller-retour",
        "smooth": "facteur de lissage",
        "bins": "classes/dim",
        "vs_smooth": "erreur de {pose} selon le facteur de lissage",
        "grid_stat": "erreur de {pose} aller-retour ({stat}) [{unit}]",
        "pose_heat": "erreur de {pose} sur (z, y), {label}",
        "scatter": "erreur de {pose}, {label}",
        "pose_names": {"orientation": "orientation", "position": "position"},
        "stat_names": {"mean": "moyenne", "median": "médiane",
                       "std": "écart-type", "min": "min", "max": "max"},
    },
}


def plot_smooth_lines(stats, n_bins, smooths, unit, title, path, lang="en"):
    """Error vs smooth factor, one line per n_bins, mean with std band."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for i, b in enumerate(n_bins):
        m, s = stats["mean"][i], stats["std"][i]
        ax.plot(smooths, m, marker="o", label=f"{b} bins/dim")
        ax.fill_between(smooths, m - s, m + s, alpha=0.15)
    ax.set_xlabel(_L10N[lang]["smooth"])
    ax.set_ylabel(f"{_L10N[lang]['roundtrip']} [{unit}]")
    ax.set_title(title)
    ax.legend(fontsize=9)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_pose_heatmap(errors_cell, axes, dims, unit, title, path):
    """Error heatmap over two pose dims, mean over the third."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = ("z", "y", "x")
    keep = [order.index(d) for d in dims]
    reduce_dim = [i for i in range(3) if i not in keep][0]
    mat = errors_cell.mean(axis=reduce_dim)
    if keep[0] > keep[1]:
        mat = mat.T
    fig, ax = plt.subplots(figsize=(7, 5))
    ext = [axes[dims[1]][0], axes[dims[1]][-1], axes[dims[0]][0], axes[dims[0]][-1]]
    im = ax.imshow(mat, aspect="auto", origin="lower", cmap="viridis", extent=ext)
    ax.set_xlabel(dims[1])
    ax.set_ylabel(dims[0])
    ax.set_title(title)
    fig.colorbar(im, label=unit)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_3d_scatter(errors_cell, axes, unit, title, path, max_points=4000):
    """3D pose-space error scatter (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    Z, Y, X = np.meshgrid(axes["z"], axes["y"], axes["x"], indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    err = errors_cell.ravel()
    if len(err) > max_points:
        idx = np.random.RandomState(0).choice(len(err), max_points, replace=False)
        pts, err = pts[idx], err[idx]
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=err, s=4, cmap="viridis")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title(title)
    fig.colorbar(sc, label=unit, shrink=0.6)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_heatmap(matrix, xs, ys, xlabel, ylabel, title, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    im = ax.imshow(matrix, aspect="auto", origin="lower", cmap="viridis")
    ax.set_xticks(range(len(xs)), [str(x) for x in xs])
    ax.set_yticks(range(len(ys)), [str(y) for y in ys])
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    for i in range(len(ys)):
        for j in range(len(xs)):
            ax.text(j, i, f"{matrix[i, j]:.2f}", ha="center", va="center",
                    color="w", fontsize=8)
    fig.colorbar(im)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def run_grid_study(args):
    """The grid study: grid sweep -> usable-range filter -> stats -> heatmaps
    per stat + smooth-line plots + pose-space heatmap + 3D scatter, for ori
    and pos."""
    out = args.out
    configs = {
        "orientation": {
            "bins": args.ori_bins, "smooths": args.ori_smooth, "unit": "deg",
            "range": {"z": (-180.0, 180.0), "y": (-90.0, 90.0), "x": (-180.0, 180.0)},
            "usable": {"z": (-180.0, 180.0), "y": (-85.0, 85.0), "x": (-180.0, 180.0)},
            "step": args.grid_step_deg,
        },
        "position": {
            "bins": args.pos_bins, "smooths": args.pos_smooth, "unit": "m",
            # the position codec's limits / the D-SPEED visibility range
            "range": {"z": (-2.0, 40.0), "y": (-12.0, 12.0), "x": (-16.0, 16.0)},
            "usable": {"z": (3.0, 35.0), "y": (-10.0, 10.0), "x": (-10.0, 10.0)},
            "step": args.grid_step_m,
        },
    }
    lang = getattr(args, "language", "en")
    sfx = "" if lang == "en" else f"_{lang}"
    summary = {}
    for pose_type, c in configs.items():
        tag = pose_type[:3]
        errors, axes = grid_sweep(pose_type, c["bins"], c["smooths"], c["range"], c["step"],
                                  device=getattr(args, "device", "cuda"))
        np.save(os.path.join(out, f"{tag}_grid_errors.npy"), errors)
        usable, uaxes = filter_usable_range(errors, axes, c["usable"])
        stats = error_statistics(usable)
        summary[pose_type] = {
            stat: {f"bins={b},smooth={s}": float(stats[stat][i, j])
                   for i, b in enumerate(c["bins"]) for j, s in enumerate(c["smooths"])}
            for stat in stats
        }
        L = _L10N[lang]
        pname = L["pose_names"][pose_type]
        for stat in ("mean", "median", "std", "min", "max"):
            plot_heatmap(stats[stat].T, c["bins"], c["smooths"],
                         L["bins"], L["smooth"],
                         L["grid_stat"].format(pose=pname,
                                               stat=L["stat_names"][stat],
                                               unit=c["unit"]),
                         os.path.join(out, f"{tag}_grid_{stat}_heatmap{sfx}.png"))
        plot_smooth_lines(stats, c["bins"], c["smooths"], c["unit"],
                          L["vs_smooth"].format(pose=pname),
                          os.path.join(out, f"{tag}_smooth_lines{sfx}.png"),
                          lang=lang)
        # best (bins, smooth) cell by mean error: pose-space views
        bi, bj = np.unravel_index(np.argmin(stats["mean"]), stats["mean"].shape)
        cell = usable[bi, bj]
        label = f"bins={c['bins'][bi]}, smooth={c['smooths'][bj]}"
        plot_pose_heatmap(cell, uaxes, ("z", "y"), c["unit"],
                          L["pose_heat"].format(pose=pname, label=label),
                          os.path.join(out, f"{tag}_pose_heatmap{sfx}.png"))
        plot_3d_scatter(cell, uaxes, c["unit"],
                        L["scatter"].format(pose=pname, label=label),
                        os.path.join(out, f"{tag}_3d_scatter{sfx}.png"))
        print(f"{pose_type}: best {label} "
              f"mean={stats['mean'][bi, bj]:.3f}{c['unit']} "
              f"median={stats['median'][bi, bj]:.3f}")
    with open(os.path.join(out, "grid_study.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"Grid study saved to {out}")


def main(argv=None):
    from spef_tpu_torch.pose.rotations import (euler2quat, generate_orientation,
                                               multiply_quaternions)

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default="experiments/soft_class")
    parser.add_argument("--n-poses", type=int, default=512)
    parser.add_argument("--ori-bins", type=int, nargs="*", default=[8, 10, 12, 16])
    parser.add_argument("--ori-smooth", type=float, nargs="*", default=[1, 2, 3, 4, 5])
    parser.add_argument("--pos-bins", type=int, nargs="*", default=[8, 10, 12, 16])
    parser.add_argument("--pos-smooth", type=float, nargs="*", default=[50, 100, 150, 200])
    parser.add_argument("--seed", type=int, default=1001)
    parser.add_argument("--grid", action="store_true",
                        help="full pose-grid sweep + stats + line/heatmap/3D figure suite")
    parser.add_argument("--language", default="en", choices=sorted(_L10N),
                        help="figure label language (EN and FR figure sets)")
    parser.add_argument("--grid-step-deg", type=float, default=30.0)
    parser.add_argument("--grid-step-m", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the study on the CPU")

    os.makedirs(args.out, exist_ok=True)

    if args.grid:
        run_grid_study(args)
        return
    quats = generate_orientation(torch.Generator().manual_seed(args.seed), args.n_poses)
    quats = quats.to(device)
    rng = np.random.RandomState(args.seed)
    poss = torch.from_numpy(
        np.stack([rng.uniform(-8, 8, args.n_poses), rng.uniform(-6, 6, args.n_poses),
                  rng.uniform(3, 33, args.n_poses)], axis=-1).astype(np.float32)
    ).to(device)

    results = {"ori": {}, "pos": {}}
    ori_mat = np.zeros((len(args.ori_smooth), len(args.ori_bins)))
    for i, s in enumerate(args.ori_smooth):
        for j, b in enumerate(args.ori_bins):
            err = ori_roundtrip_error(b, s, quats)
            ori_mat[i, j] = err
            results["ori"][f"bins={b},smooth={s}"] = err
            print(f"ori bins={b:3d} smooth={s:5.1f}: roundtrip err {err:7.3f} deg")

    pos_mat = np.zeros((len(args.pos_smooth), len(args.pos_bins)))
    for i, s in enumerate(args.pos_smooth):
        for j, b in enumerate(args.pos_bins):
            err = pos_roundtrip_error(b, s, poss)
            pos_mat[i, j] = err
            results["pos"][f"bins={b},smooth={s}"] = err
            print(f"pos bins={b:3d} smooth={s:5.1f}: roundtrip err {err:7.3f} m")

    plot_heatmap(ori_mat, args.ori_bins, args.ori_smooth, "bins/dim", "smooth factor",
                 "Orientation codec round-trip error [deg]",
                 os.path.join(args.out, "ori_roundtrip_heatmap.png"))
    plot_heatmap(pos_mat, args.pos_bins, args.pos_smooth, "bins/dim", "smooth factor",
                 "Position codec round-trip error [m]",
                 os.path.join(args.out, "pos_roundtrip_heatmap.png"))

    # PDF frame-to-frame distance trace for a synthetic tumble (alpha tuning).
    dq = euler2quat(torch.tensor([0.24, 0.107, 0.215]))
    seq = [torch.tensor([1.0, 0.0, 0.0, 0.0])]
    for _ in range(199):
        seq.append(multiply_quaternions(seq[-1], dq))
    dist = pdf_frame_distances(12, 3, torch.stack(seq).to(device))
    results["pdf_distance"] = {
        "mean": float(dist.mean()), "std": float(dist.std()),
        "suggested_alpha": float(np.log(2) / max(dist.mean(), 1e-9)),
    }
    print(f"frame-to-frame PDF L2: mean={dist.mean():.4f} std={dist.std():.4f} "
          f"(alpha for w=0.5: {results['pdf_distance']['suggested_alpha']:.2f})")

    with open(os.path.join(args.out, "soft_class_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"Saved results + heatmaps to {args.out}")


if __name__ == "__main__":
    main()
