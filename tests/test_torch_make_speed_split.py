"""``spef_tpu_torch.apps.make_speed_split`` against
``spef_tpu.apps.make_speed_split`` (``tests/test_apps_cli.py``): the same
flags, the same printed lines and the same files, byte for byte, for a
random split (seeds and validation fractions) and for the bundled reference
split; a dataset without ``train.json`` is refused.
"""

import json

import pytest

from spef_tpu.apps.make_speed_split import main as jax_main
from spef_tpu_torch.apps.make_speed_split import main

NAMES = ("train_no_valid.json", "valid.json")


def _dataset(root, n=20):
    root.mkdir()
    entries = [{"filename": f"img{i:06d}.jpg", "q_vbs2tango": [1.0, 0.0, 0.0, 0.0],
                "r_Vo2To_vbs_true": [0.0, 0.0, 10.0 + i]} for i in range(n)]
    (root / "train.json").write_text(json.dumps(entries))
    return root


def _run(fn, root, argv, capsys):
    fn(["--dataset", str(root), *argv])
    return capsys.readouterr().out, {n: (root / n).read_bytes() for n in NAMES}


@pytest.mark.parametrize("argv", [["--random", "--valid-fraction", "0.25"],
                                  ["--random", "--seed", "7"],
                                  ["--random", "--valid-fraction", "0.5", "--seed", "3"],
                                  []])
def test_same_split_as_jax(tmp_path, capsys, argv):
    mine = _run(main, _dataset(tmp_path / "mine"), argv, capsys)
    theirs = _run(jax_main, _dataset(tmp_path / "theirs"), argv, capsys)
    assert mine == theirs
    train, valid = (json.loads(mine[1][n]) for n in NAMES)
    if argv:
        assert len({e["filename"] for e in train + valid}) == 20  # a disjoint cover
    else:
        assert (len(train), len(valid)) == (10200, 1800)


def test_missing_train_json_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="train.json not found"):
        main(["--dataset", str(tmp_path), "--random"])
