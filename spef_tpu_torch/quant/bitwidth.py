"""bit_width.json load/save — a copy of ``spef_tpu.quant.bitwidth``.

The reference's ``load_bit_width`` / ``save_bit_width`` schema: values are
stringified Python literals (tuples; the ``inverted_residual`` key is a
list of stringified per-block lists) parsed with ``ast.literal_eval``, so
files written by either package load in the other unchanged.

Schema (the reference's ``backbone/mobilenet_v2.py`` and ``head/ursonet.py``):

    {
      "image": 8,
      "first_conv": (w, a),
      "last_conv": (w, a),
      "shared_act": b,
      "inverted_residual": [[(w1, a1), (w2, a2), (w3,)], ...],  # per block
      "fully_connected": (w, b),   # optional, head
      "pooling": b,                # optional, head
    }
"""

from __future__ import annotations

import ast
import json
import os
import warnings
from typing import Optional

__all__ = ["load_bit_width", "save_bit_width", "default_bit_width",
           "experiment_model_names", "boundary_bit_width"]


def load_bit_width(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            content = json.load(f)
    except FileNotFoundError:
        warnings.warn(
            f"Bit width path {path} not found.\n"
            "The default bit_width defined in the code of the model is used"
        )
        return None
    for key, value in content.items():
        if key == "inverted_residual":
            content[key] = [ast.literal_eval(v) for v in value]
        else:
            content[key] = ast.literal_eval(str(value))
    return content


def save_bit_width(save_folder: str, bit_width: dict, name: str = "bit_width.json") -> str:
    if bit_width is None:
        raise ValueError("save_bit_width: no bit_width given")
    os.makedirs(save_folder, exist_ok=True)
    str_bw = {
        key: str(value) if key != "inverted_residual" else [str(line) for line in value]
        for key, value in bit_width.items()
    }
    path = os.path.join(save_folder, name)
    with open(path, "w") as f:
        json.dump(str_bw, f, indent=4)
    return path


def default_bit_width(n_blocks: int = 17, w: int = 3, a: int = 3, shared: int = 4) -> dict:
    """The reference's default mixed-precision recipe: 8-bit image, (w, a)
    everywhere, first block's expand conv unquantized (None, None)."""
    blocks = [[(w, a), (w, a), (w,)] for _ in range(n_blocks)]
    blocks[0] = [(None, None), (w, a), (w,)]
    return {
        "image": 8,
        "first_conv": (w, a),
        "last_conv": (w, a),
        "shared_act": shared,
        "inverted_residual": blocks,
        "fully_connected": (8, 8),
        "pooling": 8,
    }


def boundary_bit_width(n_blocks: int = 17, w: int = 8, shared: int = 8) -> dict:
    """Boundary-only recipe: int8 activations BETWEEN blocks, real-valued
    (bf16) activations inside them — the deployed recipe.  The int8 carries
    between blocks keep the bandwidth win; the interior grids, whose round
    and clip cost arithmetic on the 6x-expanded hidden tensor, are dropped.
    """
    blocks = [[(w, None), (w, None), (w,)] for _ in range(n_blocks)]
    blocks[0] = [(None, None), (w, None), (w,)]
    return {
        "image": 8,
        "first_conv": (w, 8),
        "last_conv": (w, 8),
        "shared_act": shared,
        "inverted_residual": blocks,
        "fully_connected": (8, 8),
        "pooling": 8,
    }


def experiment_model_names(exp_dir: str, backbone_name: str, head_name: str):
    """Resolve (backbone, head, bit_width) for an experiment checkpoint.

    A ``model/bit_width.json`` marks a QAT checkpoint: the saved parameters
    belong to the quantized module variants, so the configured float names
    map to their ``_q`` forms.
    """
    bw_path = os.path.join(exp_dir, "model", "bit_width.json")
    if not os.path.isfile(bw_path):
        return backbone_name, head_name, None

    def q_name(name: str) -> str:
        name = name.replace("_pytorch", "").replace("_brevitas", "")
        return name if name.endswith("_q") else name + "_q"

    return q_name(backbone_name), q_name(head_name), load_bit_width(bw_path)
