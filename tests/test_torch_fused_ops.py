"""Port parity: the plain K3/K4 of spef_tpu_torch against the JAX fused kernels.

The JAX side runs ``fused_stem`` / ``fused_mbconv`` in Pallas interpret mode
on the CPU, on the padded layout (``pad_act`` / ``unpad_act``), with explicit
tiles so that the TPU tuning table is never read; the shapes the TPU kernel
refuses (odd height at stride 2, a width off a multiple of 8) run through
``int8_fused._xla_block``, as the JAX executor sends them.  The port side goes
through the operand folding of ``quant/int8_fused.py`` (``stem_operands``,
``mbconv_operands``) and the CPU wrappers, so the folding is held too.
Inputs come from numpy seeds.

Blocks whose interiors are on grids are compared bit for bit.  With a
float32 hidden tensor or a real-valued depthwise output (the boundary
recipe) the JAX interpret kernel, compiled by XLA's CPU backend, contracts
``acc + tap * w`` and ``acc * mult + bias`` into fused multiply-adds and
sums the projection in its own order; the port rounds each product and sums
in k order.  Stated tolerance there: at most one int8 step, on at most 0.5%
of the outputs.  One such case runs on inputs whose every product and
partial sum is exact (small integers, power-of-two multipliers), where
order and fusing cannot matter: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.ops.pallas.fused_block import fused_mbconv as jax_mbconv
from spef_tpu.ops.pallas.fused_block import fused_stem as jax_stem
from spef_tpu.ops.pallas.fused_block import pad_act, unpad_act
from spef_tpu.quant.int8_fused import _xla_block
from spef_tpu_torch.ops.fused_block import (
    fused_mbconv,
    fused_mbconv_plain,
    fused_stem,
    fused_stem_plain,
)
from spef_tpu_torch.quant.int8_fused import mbconv_operands, stem_operands

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_jax(tree):
    """numpy array leaves -> jax arrays; Python scalars stay (control flow)."""
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, tree)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _stem(seed, cout, act_step, act_qmax):
    rng = np.random.RandomState(seed)
    return {"w_int": rng.randint(-8, 8, (3, 3, 3, cout)).astype(np.int8),
            "mult_core": (rng.rand(cout) * 2e-2).astype(np.float32),
            "bias": (rng.randn(cout) * 0.05).astype(np.float32),
            "stride": 2, "groups": 1, "act_step": act_step, "act_qmax": act_qmax}


@pytest.mark.parametrize("grid", ["int8_values", "uint8_bits"])
def test_plain_k3_bit_exact(grid):
    step, qmax = (0.004, 127.0) if grid == "int8_values" else (0.001, 255.0)
    stem = _stem(1, 16, step, qmax)
    images = np.random.RandomState(2).randint(0, 256, (2, 32, 48, 3), np.uint8)
    want = np.asarray(unpad_act(
        jax_stem(jnp.asarray(images), _to_jax(stem), tile_oh=8, interpret=True), 24, 16))
    args, kw = stem_operands(stem)
    got = fused_stem(_t(images), *args, **kw).numpy()
    assert got.shape == want.shape == (2, 16, 24, 16) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size > 16  # a spread of values
    if grid == "uint8_bits":  # the bits regime (q > 127) is really exercised
        assert (got < 0).mean() > 0.01
    else:
        assert (got < 0).sum() == 0


def test_plain_k3_odd_size_matches_a_direct_convolution():
    """Odd height and width (the TPU kernel refuses them): the plain K3
    against the definition, a 3x3 stride-2 pad-1 convolution of the integer
    pixels in float64."""
    stem = _stem(3, 8, 0.004, 127.0)
    images = np.random.RandomState(4).randint(0, 256, (1, 9, 13, 3), np.uint8)
    args, kw = stem_operands(stem)
    got = fused_stem_plain(_t(images), *args, **kw).numpy()
    x = torch.from_numpy(images).double().permute(0, 3, 1, 2)
    w = torch.from_numpy(stem["w_int"]).double().permute(3, 2, 0, 1)
    acc = torch.nn.functional.conv2d(x, w, stride=2, padding=1).permute(0, 2, 3, 1).float()
    y = acc * (torch.from_numpy(stem["mult_core"]) / 255.0) + torch.from_numpy(stem["bias"])
    q = torch.clamp(torch.round(torch.clamp_min(y, 0) * np.float32(1.0 / 0.004)), 0, 127)
    assert got.shape == (1, 5, 7, 8)
    np.testing.assert_array_equal(got, q.numpy().astype(np.int8))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

IN_STEP = 0.05
EXACT_IN_STEP = 0.0625
SHARED = {"step": 0.07, "qmax": 127.0, "qmin": -128.0}


def _block(seed, cin=32, ch=64, cout=32, stride=1, expand=True, residual=False,
           hidden_grid=True, dw_grid=True, exact=False):
    """A converted-graph block entry (numpy leaves) in the form of
    tests/test_int8_pallas.py.  ``exact``: small integer weights and
    power-of-two multipliers, so every product and partial sum is exact."""
    rng = np.random.RandomState(seed)
    lim = 4 if exact else 8

    def layer(shape, n, mult, stride=1, groups=1):
        return {"w_int": rng.randint(-lim, lim, shape).astype(np.int8),
                "mult_core": (np.full(n, mult, np.float32) if exact
                              else (rng.rand(n) * mult).astype(np.float32)),
                "bias": ((rng.randint(-8, 8, n) / 8.0).astype(np.float32) if exact
                         else (rng.randn(n) * 0.05).astype(np.float32)),
                "stride": stride, "groups": groups}

    blk = {"use_residual": residual, "input_quant": True, "expand_ratio": ch // cin,
           "shared_step": SHARED["step"], "shared_qmax": SHARED["qmax"]}
    if expand:
        # exact: with EXACT_IN_STEP, m1 = mult_core * in_step = 1/8.
        blk["expand"] = layer((1, 1, cin, ch), ch, 2.0 if exact else 0.1)
        if hidden_grid:
            blk["expand"].update(act_step=0.045, act_qmax=255.0)
    blk["depthwise"] = layer((3, 3, 1, ch), ch, 0.25 if exact else 0.1, stride=stride, groups=ch)
    if dw_grid:
        blk["depthwise"].update(act_step=0.03, act_qmax=255.0)
    blk["project"] = layer((1, 1, ch, cout), cout, 0.125 if exact else 0.05)
    return blk


def _input(seed, shape, unsigned=False, exact=False):
    rng = np.random.RandomState(seed)
    lo, hi = (-128, 128) if unsigned else ((-8, 8) if exact else (-64, 64))
    return rng.randint(lo, hi, shape).astype(np.int8)


def _grids(blk, out_step):
    out_grid = {"step": out_step, "qmax": 127.0, "qmin": -128.0}
    return out_grid, (SHARED if blk["use_residual"] else None)


def _port(x, blk, out_grid, shared, unsigned, fn=fused_mbconv, in_step=IN_STEP):
    wts, kw = mbconv_operands(blk, in_step, out_grid, shared, unsigned)
    return fn(_t(x), wts, **kw).numpy()


def _jax_kernel(x, blk, out_grid, shared, unsigned, in_step=IN_STEP):
    _, h, w, _ = x.shape
    stride = blk["depthwise"]["stride"]
    cout = blk["project"]["w_int"].shape[-1]
    out = jax_mbconv(pad_act(jnp.asarray(x)), _to_jax(blk), in_step=in_step, out_grid=out_grid,
                     shared_grid=shared, logical_hw=(h, w), tile_oh=4, tile_b=2,
                     interpret=True, in_unsigned=unsigned)
    return np.asarray(unpad_act(out, w // stride, cout))


def _within_one_step(got, want, share=0.005):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= share, (diff.max(), (diff > 0).mean())


GRID_CASES = {
    # name: (block kwargs, out_step, in_unsigned)
    "expand_s1_residual_ratio": (dict(residual=True), 0.06, False),
    "expand_s1_residual_same_step": (dict(residual=True), SHARED["step"], False),
    "expand_s1_no_residual": (dict(), 0.06, False),
    "expand_s2": (dict(stride=2), 0.06, False),
    "expand_s1_in_unsigned": (dict(), 0.06, True),
    "expand_s2_in_unsigned": (dict(stride=2), 0.06, True),
    "no_expand_s1": (dict(expand=False, ch=32, cout=16), 0.06, False),
    "no_expand_s2_in_unsigned": (dict(expand=False, ch=32, cout=16, stride=2), 0.06, True),
    "no_expand_s1_residual": (dict(expand=False, ch=32, residual=True), 0.06, False),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_plain_k4_grid_interiors_bit_exact(case):
    kwargs, out_step, unsigned = GRID_CASES[case]
    blk = _block(11, **kwargs)
    x = _input(12, (4, 16, 16, 32), unsigned)
    out_grid, shared = _grids(blk, out_step)
    want = _jax_kernel(x, blk, out_grid, shared, unsigned)
    got = _port(x, blk, out_grid, shared, unsigned)
    assert got.shape == want.shape and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size > 16  # a spread of values, not a saturated tensor


FLOAT_CASES = {
    "float_hidden_dw_grid_s1": (dict(hidden_grid=False), 0.06),
    "hidden_grid_real_dw_s1_residual": (dict(dw_grid=False, residual=True), 0.06),
    "boundary_s1_residual": (dict(hidden_grid=False, dw_grid=False, residual=True), 0.06),
    "boundary_s2": (dict(hidden_grid=False, dw_grid=False, stride=2), 0.06),
    "boundary_no_expand_s1": (dict(expand=False, ch=32, cout=16, dw_grid=False), 0.06),
}


@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_plain_k4_float_interiors_within_one_step(case):
    """Float32 hidden tensor and / or real-valued depthwise output: at most
    one int8 step on at most 0.5% of the outputs (fused multiply-adds and the
    projection's summation order on the JAX side; see the module docstring)."""
    kwargs, out_step = FLOAT_CASES[case]
    blk = _block(21, **kwargs)
    x = _input(22, (4, 16, 16, 32))
    out_grid, shared = _grids(blk, out_step)
    want = _jax_kernel(x, blk, out_grid, shared, False)
    got = _port(x, blk, out_grid, shared, False)
    assert got.shape == want.shape
    _within_one_step(got, want)
    assert np.unique(got).size > 16


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_k4_boundary_exact_sums_bit_exact(stride):
    """The boundary recipe (no hidden grid, no depthwise grid) on inputs
    whose products and partial sums are all exact in float32: neither a
    fused multiply-add nor the summation order can change a bit."""
    blk = _block(31, stride=stride, residual=stride == 1, hidden_grid=False, dw_grid=False,
                 exact=True)
    x = _input(32, (4, 16, 16, 32), exact=True)
    out_grid, shared = _grids(blk, 0.5)
    if shared is not None:
        shared = {"step": 1.0, "qmax": 127.0, "qmin": -128.0}
    want = _jax_kernel(x, blk, out_grid, shared, False, in_step=EXACT_IN_STEP)
    got = _port(x, blk, out_grid, shared, False, in_step=EXACT_IN_STEP)
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size > 16


REFUSED_CASES = {
    # shapes the TPU kernel refuses, which the JAX executor sends to XLA:
    # (input shape, block kwargs, in_unsigned, share of outputs one step off)
    "odd_height_s2_grids": ((2, 15, 24, 32), dict(stride=2), False, 0.005),
    "width_12_s1_residual_grids": ((2, 16, 12, 32), dict(residual=True), False, 0.005),
    "width_12_s2_in_unsigned_grids": ((2, 16, 12, 32), dict(stride=2), True, 0.005),
    "odd_height_s2_boundary": ((2, 15, 24, 32), dict(stride=2, hidden_grid=False,
                                                     dw_grid=False), False, 0.05),
}


@pytest.mark.parametrize("case", sorted(REFUSED_CASES))
def test_plain_k4_shapes_the_tpu_kernel_refuses(case):
    """Against ``_xla_block``, which divides by the steps where the kernels
    multiply by their reciprocals: at most one int8 step on at most 0.5% of
    the outputs.  Under the boundary recipe ``_xla_block`` is another
    function than the fused kernel the port follows: it rounds the ungridded
    hidden tensor to bf16 (2^-9 relative) where the kernel keeps float32.
    Stated tolerance there: one step on at most 5% of the outputs (2.5%
    seen)."""
    shape, kwargs, unsigned, share = REFUSED_CASES[case]
    blk = _block(41, **kwargs)
    x = _input(42, shape, unsigned)
    out_grid, shared = _grids(blk, 0.06)
    want, step = _xla_block(jnp.asarray(x), _to_jax(blk), IN_STEP, out_grid,
                            in_unsigned=unsigned)
    got = _port(x, blk, out_grid, shared, unsigned)
    stride = blk["depthwise"]["stride"]
    assert got.shape == (shape[0], (shape[1] - 1) // stride + 1, (shape[2] - 1) // stride + 1, 32)
    assert got.shape == want.shape and step == out_grid["step"]
    _within_one_step(got, np.asarray(want), share)
    assert np.unique(got).size > 16


def test_wrappers_take_plain_version_on_cpu_without_counting():
    """On CPU tensors the wrappers run the plain versions and launch nothing."""
    before = (fused_stem.launches, fused_mbconv.launches)
    stem = _stem(51, 8, 0.004, 127.0)
    images = _t(np.random.RandomState(52).randint(0, 256, (1, 8, 8, 3), np.uint8))
    args, kw = stem_operands(stem)
    torch.testing.assert_close(fused_stem(images, *args, **kw),
                               fused_stem_plain(images, *args, **kw), rtol=0, atol=0)
    blk = _block(53, cin=8, ch=16, cout=8, residual=True)
    x = _input(54, (1, 6, 5, 8))
    out_grid, shared = _grids(blk, 0.06)
    a = _port(x, blk, out_grid, shared, False)
    b = _port(x, blk, out_grid, shared, False, fn=fused_mbconv_plain)
    np.testing.assert_array_equal(a, b)
    assert (fused_stem.launches, fused_mbconv.launches) == before


def test_k4_refuses_what_it_does_not_take():
    blk = _block(61, cin=8, ch=16, cout=8)
    out_grid, _ = _grids(blk, 0.06)
    wts, kw = mbconv_operands(blk, IN_STEP, out_grid)
    x = _t(_input(62, (1, 4, 4, 8)))
    with pytest.raises(ValueError):
        fused_mbconv(x.float(), wts, **kw)  # not int8
    with pytest.raises(ValueError):
        fused_mbconv(x, wts, **{**kw, "stride": 3})
    with pytest.raises(ValueError):  # a residual across a stride
        fused_mbconv(x, wts, **{**kw, "use_residual": True, "stride": 2})
    with pytest.raises(ValueError):  # a bits-carry residual
        fused_mbconv(x, wts, **{**kw, "use_residual": True, "in_unsigned": True})
    with pytest.raises(ValueError):
        fused_mbconv(x[..., :4].contiguous(), wts, **kw)  # Cin mismatch
    with pytest.raises(ValueError):
        mbconv_operands({**blk, "use_residual": True}, IN_STEP, out_grid)  # no shared grid
