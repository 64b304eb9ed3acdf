"""Port parity at the flagship's size: the port's deployed int8 executor
``quant/int8_carry.py::build_int8_carry_forward`` (plain backends, on the
CPU) against the JAX package's ``spef_tpu.quant.int8_carry`` on the
committed flagship graph (boundary recipe) at 240x384, on 16 rendered frames
in the dataset's channel order (RGB: ``render_frame(...)[..., ::-1]``).

``tests/test_torch_int8_carry.py`` holds the two bit for bit at 48x64, where
no tie of the boundary recipe flips.  At 240x384 the real-valued depthwise
outputs are summed over K up to 960 in float32 by the projections, in the
port's k order and in XLA's, and a few block outputs land one int8 step
apart; the pooled integers then move the logits.  Stated bounds: the logits
within 0.3, the decoded orientations within 1.5 degrees (up to quaternion
sign) and the positions within 0.1 m, frame by frame.  Seen on this graph
and these frames: 0.2564 in the logits, 0.497 degrees, 0.0833 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spef_tpu.quant.int8_carry import build_int8_carry_forward as jax_carry_forward
from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
from spef_tpu_torch.quant.int8_graph import load_int8_graph
from test_torch_int8_asset import ASSET, _pose, _synthetic_frames

torch.set_num_threads(1)


def test_carry_matches_jax_carry_on_flagship_frames():
    graph = load_int8_graph(ASSET)
    frames = _synthetic_frames(16, seed=1001)
    got = build_int8_carry_forward(graph, backend="plain", device="cpu")(torch.from_numpy(frames))
    want = jax.jit(jax_carry_forward(graph))(jnp.asarray(frames))
    d_logit = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        d_logit = max(d_logit, float(np.abs(g.numpy() - np.asarray(w)).max()))
    pose, jpose = _pose(got), _pose(want)
    dot = (pose["ori"] * jpose["ori"]).sum(-1).abs().clamp(max=1.0)
    ang = torch.rad2deg(2 * torch.arccos(dot)).numpy()
    dist = torch.linalg.vector_norm(pose["pos"] - jpose["pos"], dim=-1).numpy()
    print(f"carry vs JAX carry, 16 frames: max |d logit| {d_logit:.4f}, "
          f"max {ang.max():.3f} deg, max {dist.max():.4f} m")
    assert d_logit < 0.3, d_logit
    assert ang.max() < 1.5 and dist.max() < 0.1, (ang.max(), dist.max())
