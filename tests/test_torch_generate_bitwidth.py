"""Port parity of the bit-width sweep generator:
``spef_tpu_torch.apps.generate_bitwidth_experiments`` against
``spef_tpu.apps.generate_bitwidth_experiments``.  Pure Python on both sides,
so exact: the same sweep lists, the same directory tree, byte-identical
``bit_width.json`` files and ``config.yaml`` files that parse to the same
values in both packages' config loaders.
"""

import os

import pytest

import spef_tpu.apps.generate_bitwidth_experiments as jax_app
import spef_tpu_torch.apps.generate_bitwidth_experiments as port_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth",
                               "config.yaml")


@pytest.mark.parametrize("n_blocks", [17, 4, 1])
def test_build_sweep_matches_jax(n_blocks):
    got = port_app.build_sweep(n_blocks)
    assert got == jax_app.build_sweep(n_blocks)
    assert len(got) == 54 + 5 * n_blocks - 2  # uniform sweeps, then one-block ablations


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("base", [None, FLAGSHIP_CONFIG])
def test_cli_writes_jax_tree(tmp_path, base):
    from spef_tpu.config.train_config import load_config as jax_load
    from spef_tpu_torch.config.train_config import load_config

    extra = ["--config", base] if base else []
    port_app.main(["--out", str(tmp_path / "port"), "--n-blocks", "4", *extra])
    jax_app.main(["--out", str(tmp_path / "jax"), "--n-blocks", "4", *extra])
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    assert len(files) == 2 * len(jax_app.build_sweep(4))
    for rel in files:
        mine, theirs = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.endswith("bit_width.json"):
            assert mine.read_bytes() == theirs.read_bytes(), rel
        else:
            got, want = load_config(str(mine)), jax_load(str(theirs))
            assert got == want, rel
            assert got.MODEL.QUANTIZATION is True and got.MODEL.BACKBONE.NAME == "mobilenet_v2_q"
