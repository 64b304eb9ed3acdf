"""Float -> QAT warm-start parameter copy — counterpart of
``spef_tpu.quant.warmstart`` (the reference's ``copy_state_dict``).

Float and quantized models have differently named parameter trees, so
weights are copied by *category and order* (convolution kernels in order,
BN scale / bias / mean / var, dense kernels / biases) rather than by key.
Both trees are flax-layout variable trees (nested dicts of numpy arrays, as
``models.wrapper.flax_variables`` and ``read_flax_msgpack`` give them), and
both are walked in JAX's flattening order: dict keys sorted, so that
``block_10`` comes before ``block_2`` in both and the order matches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["copy_params"]

# Leaf-name categories, mirroring the reference's key list
# ["weight", "bias", "running_mean", "running_var"].
_CATEGORIES = ("kernel", "scale", "bias", "mean", "var")


def _leaves(tree: Any, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs in ``jax.tree_util`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _flatten_by_category(tree) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    out: Dict[str, List[Tuple[str, np.ndarray]]] = {c: [] for c in _CATEGORIES}
    for path, leaf in _leaves(tree):
        name = path[-1]
        if name == "log2_scale":  # quantizer parameter, no float counterpart
            continue
        for cat in _CATEGORIES:
            if name == cat or name.endswith("_" + cat):
                out[cat].append(("/".join(path), np.asarray(leaf)))
                break
    return out


def copy_params(src_variables: Any, dst_variables: Any, strict_shapes: bool = True) -> Any:
    """Copy src leaves into dst by category order; returns a new dst tree.

    Leaves whose shapes disagree are skipped (unless ``strict_shapes``,
    which raises), e.g. a float head with other output bins.
    """
    src_cats = _flatten_by_category(src_variables)
    dst_cats = _flatten_by_category(dst_variables)

    replacements: Dict[str, np.ndarray] = {}
    for cat in _CATEGORIES:
        src_list = src_cats[cat]
        for i, (dst_name, dst_leaf) in enumerate(dst_cats[cat]):
            if i >= len(src_list):
                break
            src_name, src_leaf = src_list[i]
            if src_leaf.shape != dst_leaf.shape:
                if strict_shapes:
                    raise ValueError(f"shape mismatch copying {src_name} {src_leaf.shape} -> "
                                     f"{dst_name} {dst_leaf.shape}")
                continue
            replacements[dst_name] = src_leaf

    def rebuild(tree: Any, path: Tuple[str, ...] = ()) -> Any:
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in tree.items()}
        full = "/".join(path)
        if full in replacements:
            return np.asarray(replacements[full], dtype=np.asarray(tree).dtype)
        return tree

    return rebuild(dst_variables)
