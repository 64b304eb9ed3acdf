"""Bit-width experiment sweep generator.

Counterpart of ``spef_tpu.apps.generate_bitwidth_experiments`` (pure
Python): writes ``exp_N/`` directories (``config.yaml`` + ``bit_width.json``)
sweeping per-layer weight / activation bit widths for mixed-precision QAT:

  * uniform sweeps of each component's bit width (expansion / depthwise /
    projection weights and activations, first / last conv, FC, shared act)
    over {8, 6, 4, 3, 2, 1};
  * one-layer-at-a-time ablations: a single block's expansion / depthwise /
    projection weights at 1 bit (or activations at 3 bits) while the rest
    stays at 8.

Usage:
    python -m spef_tpu_torch.apps.generate_bitwidth_experiments --out path/configs \\
        [--config base.yaml] [--n-blocks 17]
"""

from __future__ import annotations

import argparse
import os
from typing import List


def _base(n_blocks: int) -> dict:
    return {
        "image": 8,
        "first_conv": (8, 8),
        "last_conv": (8, 8),
        "fully_connected": (8, 8),
        "shared_act": 8,
        "pooling": 8,
        "inverted_residual": [[(8, 8), (8, 8), (8,)] for _ in range(n_blocks)],
    }


def build_sweep(n_blocks: int = 17) -> List[dict]:
    sweeps: List[dict] = []
    widths = (8, 6, 4, 3, 2, 1)

    # Uniform sweeps per component.
    for w in widths:
        for which in ("expand_w", "expand_a", "dw_w", "dw_a", "proj_w",
                      "first", "last", "fc", "shared"):
            bw = _base(n_blocks)
            if which == "expand_w":
                bw["inverted_residual"] = [[(w, 8), (8, 8), (8,)] for _ in range(n_blocks)]
            elif which == "expand_a":
                bw["inverted_residual"] = [[(8, w), (8, 8), (8,)] for _ in range(n_blocks)]
            elif which == "dw_w":
                bw["inverted_residual"] = [[(8, 8), (w, 8), (8,)] for _ in range(n_blocks)]
            elif which == "dw_a":
                bw["inverted_residual"] = [[(8, 8), (8, w), (8,)] for _ in range(n_blocks)]
            elif which == "proj_w":
                bw["inverted_residual"] = [[(8, 8), (8, 8), (w,)] for _ in range(n_blocks)]
            elif which == "first":
                bw["first_conv"] = (w, w)
            elif which == "last":
                bw["last_conv"] = (w, w)
            elif which == "fc":
                bw["fully_connected"] = (w, 8)
            elif which == "shared":
                bw["shared_act"] = w
            sweeps.append(bw)

    def one_at(block_idx, triple, skip_first_expand=False):
        rows = []
        start = 1 if skip_first_expand else 0
        for y in range(start, n_blocks):
            rows.append(triple if y == block_idx else [(8, 8), (8, 8), (8,)])
        if skip_first_expand:
            rows = [[(None, None), (8, 8), (8,)]] + rows
        return rows

    # One-block-at-a-time 1-bit weight ablations.
    for x in range(1, n_blocks):  # expansion (block 0 has no expansion conv)
        bw = _base(n_blocks)
        bw["inverted_residual"] = one_at(x, [(1, 8), (8, 8), (8,)], skip_first_expand=True)
        sweeps.append(bw)
    for x in range(n_blocks):  # depthwise weights
        bw = _base(n_blocks)
        bw["inverted_residual"] = one_at(x, [(8, 8), (1, 8), (8,)])
        sweeps.append(bw)
    for x in range(n_blocks):  # projection weights
        bw = _base(n_blocks)
        bw["inverted_residual"] = one_at(x, [(8, 8), (8, 8), (1,)])
        sweeps.append(bw)
    # 3-bit activation ablations.
    for x in range(1, n_blocks):
        bw = _base(n_blocks)
        bw["inverted_residual"] = one_at(x, [(8, 3), (8, 8), (8,)], skip_first_expand=True)
        sweeps.append(bw)
    for x in range(n_blocks):
        bw = _base(n_blocks)
        bw["inverted_residual"] = one_at(x, [(8, 8), (8, 3), (8,)])
        sweeps.append(bw)

    return sweeps


def main(argv=None):
    from spef_tpu_torch.config.train_config import load_config, save_config
    from spef_tpu_torch.quant.bitwidth import save_bit_width

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True)
    parser.add_argument("--config", default=None, help="base config.yaml")
    parser.add_argument("--n-blocks", type=int, default=17)
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    cfg.MODEL.QUANTIZATION = True
    cfg.MODEL.BACKBONE.NAME = "mobilenet_v2_q"
    cfg.MODEL.HEAD.NAME = "ursonet_q"

    sweeps = build_sweep(args.n_blocks)
    for idx, bw in enumerate(sweeps):
        folder = os.path.join(args.out, f"exp_{idx}")
        os.makedirs(folder, exist_ok=True)
        save_bit_width(folder, bw)
        save_config(cfg, os.path.join(folder, "config.yaml"))
    print(f"Wrote {len(sweeps)} experiments to {args.out}")


if __name__ == "__main__":
    main()
