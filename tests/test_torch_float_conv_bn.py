"""The float forward's fused conv kernels (``ops/bf16_conv_bn.py``) and the
dispatch of eval-mode ``ConvBnAct`` onto them.

On the CPU: the kernels' plain twins against today's ``ConvBnAct`` /
``InvertedResidual`` (bit for bit where every order of the conv's sum gives
the same sum and the BatchNorm's terms are exact; within the BatchNorm's
multiply-add rounding otherwise), the dispatch rule read from the
``forward.conv_fused`` / ``forward.conv_plain`` counters, and the packed
operands' cache.  The CPU runs the fused path only where a test adds it to
``layers._KERNEL_DEVICES`` (the wrappers then run the twins).

On the card (marked ``cuda``; ``python -m pytest -m cuda
tests/test_torch_float_conv_bn.py``): each kernel at every flagship layer
shape against a float32 conv + BatchNorm, no further from it than cuDNN's
conv and today's epilogue plus one bf16 ulp, the depthwise kernel bit for
bit with its twin, and the flagship forward fused against plain.
"""

import copy

import numpy as np
import pytest
import torch

from spef_tpu_torch.models import layers
from spef_tpu_torch.models.layers import BatchNorm, ConvBnAct, InvertedResidual
from spef_tpu_torch.models.mobilenet_v2 import MOBILENET_V2_SETTINGS, MobileNetV2
from spef_tpu_torch.ops.bf16_conv_bn import (bf16_conv1x1_bn, bf16_conv1x1_bn_plain,
                                             bf16_depthwise3x3_bn, bf16_depthwise3x3_bn_plain,
                                             bn_terms, pack_conv1x1_weights,
                                             pack_depthwise_weights)
from spef_tpu_torch.utils import profiling

# var + eps is 4.0 exactly in float32: sqrt 2, so scale = weight / 2 is exact.
VAR_EXACT = float(np.float32(4.0) - np.float32(1e-5))


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """Eval-mode convs on the CPU take the fused path (the kernels' twins)."""
    monkeypatch.setattr(layers, "_KERNEL_DEVICES", ("cuda", "cpu"))


def _ints(g, shape, lo, hi):
    return torch.randint(lo, hi + 1, shape, generator=g).float()


def _exact_bn(bn: BatchNorm, g) -> None:
    """Integer-valued BatchNorm terms: scale 1 or 2, integer shift."""
    c = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(2.0 * _ints(g, (c,), 1, 2))
        bn.bias.copy_(_ints(g, (c,), -3, 3))
        bn.running_mean.copy_(_ints(g, (c,), -2, 2))
        bn.running_var.fill_(VAR_EXACT)


def _random_bn(bn: BatchNorm, g) -> None:
    c = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)


def _integer_conv(m: ConvBnAct, g, exact_bn=True) -> ConvBnAct:
    with torch.no_grad():
        m.conv.weight.copy_(_ints(g, m.conv.weight.shape, -2, 2))
    (_exact_bn if exact_bn else _random_bn)(m.bn, g)
    return m.eval()


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    return x_nhwc.permute(0, 3, 1, 2)


def _twin(m: ConvBnAct, x_nchw: torch.Tensor, residual=None) -> torch.Tensor:
    """The twin of ``m``'s kernel on NCHW input, NCHW out."""
    scale, shift = bn_terms(m.bn.weight, m.bn.bias, m.bn.running_mean, m.bn.running_var, m.bn.eps)
    x = x_nchw.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    if m.conv.kernel_size == (1, 1):
        b, h, w, c = x.shape
        res = None if residual is None else \
            residual.permute(0, 2, 3, 1).reshape(b * h * w, -1).to(torch.bfloat16)
        y = bf16_conv1x1_bn_plain(x.view(-1, c), pack_conv1x1_weights(m.conv.weight), scale,
                                  shift, m.activation, res).view(b, h, w, -1)
    else:
        y = bf16_depthwise3x3_bn_plain(x, pack_depthwise_weights(m.conv.weight), scale, shift,
                                       m.conv.stride[0], m.activation)
    return y.permute(0, 3, 1, 2)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (the smallest normal's below it)."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


# --- the twins against today's ConvBnAct / InvertedResidual ----------------------------------


@pytest.mark.parametrize("cin,cout,relu", [(16, 96, True), (24, 16, False), (40, 33, True)])
def test_conv1x1_twin_is_conv_bn_act_bit_for_bit(cin, cout, relu):
    """Integer operands (every order sums them alike, above 256 so the conv's
    bf16 rounding matters) and exact BatchNorm terms: the twin is today's
    eval output bit for bit."""
    g = torch.Generator().manual_seed(cin + cout)
    m = _integer_conv(ConvBnAct(cin, cout, kernel_size=1, activation=relu, generator=g), g)
    x = _nchw(_ints(g, (2, 5, 7, cin), -20, 20)).to(torch.bfloat16)
    with torch.no_grad():
        want = m(x)
    got = _twin(m, x)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert want.float().abs().max() > 256  # the sums do round to bf16


@pytest.mark.parametrize("stride,hw", [(1, (6, 9)), (2, (7, 10)), (2, (8, 8))])
def test_depthwise_twin_is_conv_bn_act_bit_for_bit(stride, hw):
    g = torch.Generator().manual_seed(stride * 100 + hw[0])
    c = 24
    m = _integer_conv(ConvBnAct(c, c, kernel_size=3, stride=stride, groups=c, generator=g), g)
    x = _nchw(_ints(g, (2, *hw, c), -30, 30)).to(torch.bfloat16)
    with torch.no_grad():
        want = m(x)
    got = _twin(m, x)
    assert got.shape == want.shape and torch.equal(got, want)
    assert want.float().abs().max() > 256


@pytest.mark.parametrize("kind", ["1x1", "dw3x3"])
def test_twins_with_real_batchnorm_terms_differ_only_by_its_multiply_add(kind):
    """Random running statistics: the twins round ``c * scale`` and then the
    add, where the CPU's BatchNorm fuses the two (one rounding); the outputs
    differ at most by that rounding and one bf16 ulp, and rarely."""
    g = torch.Generator().manual_seed(7)
    c = 32
    m = ConvBnAct(c, 48, kernel_size=1, generator=g) if kind == "1x1" else \
        ConvBnAct(c, c, kernel_size=3, groups=c, generator=g)
    m = _integer_conv(m, g, exact_bn=False)
    x = _nchw(_ints(g, (2, 9, 11, c), -20, 20)).to(torch.bfloat16)
    with torch.no_grad():
        want = m(x).float()
        conv = torch.nn.functional.conv2d(x.float(), m.conv.weight.to(torch.bfloat16).float(),
                                          None, m.conv.stride, m.conv.padding,
                                          groups=m.conv.groups).to(torch.bfloat16).float()
    got = _twin(m, x).float()
    scale, _ = bn_terms(m.bn.weight, m.bn.bias, m.bn.running_mean, m.bn.running_var, m.bn.eps)
    room = _bf16_ulp(want) + 2.0 ** -23 * (conv * scale[:, None, None]).abs()
    assert ((got - want).abs() <= room).all()
    assert (got != want).float().mean() < 0.01


def test_inverted_residual_twins_are_the_block_bit_for_bit(kernels_on_cpu):
    """A stride-1 block with its identity skip: the fused path (expand,
    depthwise, project + residual, each a twin) is the plain block bit for
    bit on integer activations (every layer's output stays integer)."""
    g = torch.Generator().manual_seed(3)
    blk = InvertedResidual(16, 16, stride=1, expand_ratio=6, generator=g).eval()
    for m in (blk.expand, blk.depthwise, blk.project):
        with torch.no_grad():
            m.conv.weight.copy_(_ints(g, m.conv.weight.shape, -1, 1))
        _exact_bn(m.bn, g)
    x = _nchw(_ints(g, (2, 6, 8, 16), -2, 2)).contiguous(memory_format=torch.channels_last) \
        .to(torch.bfloat16)
    with torch.enable_grad():
        want = blk(x)  # grad enabled: the plain path
    with torch.no_grad():
        got = blk(x)
    assert blk.use_residual and torch.equal(got, want.detach())
    assert got.is_contiguous(memory_format=torch.channels_last)


# --- dispatch, read from the counters ----------------------------------------------------------


def _counted(model, x, grad=False):
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.set_grad_enabled(grad):
            out = model(x)
        got = profiling.counters()
    profiling.reset_counters()
    return out, {k: v for k, v in got.items() if k.startswith("forward.conv_")}


@pytest.fixture(scope="module")
def mobilenet():
    g = torch.Generator().manual_seed(11)
    model = MobileNetV2(generator=g)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            _random_bn(m, g)
    return model.eval()


def test_flagship_backbone_fuses_every_conv_but_the_stem(kernels_on_cpu, mobilenet):
    """51 eval convs fused, the stem plain, a forward; the fused backbone's
    output is the plain one's within the conv's rounding."""
    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(1))
    n_convs = 1 + sum(n * (2 if t == 1 else 3) for t, _, n, _ in MOBILENET_V2_SETTINGS) + 1
    assert n_convs == 52
    fused, counts = _counted(mobilenet, x)
    assert counts == {"forward.conv_fused": 51, "forward.conv_plain": 1}
    plain, counts = _counted(mobilenet, x, grad=True)
    assert counts == {"forward.conv_plain": 52}
    plain = plain.detach().float()
    assert (fused.float() - plain).abs().max() <= 0.02 * plain.abs().max()


@pytest.mark.parametrize("case", ["train_mode", "grad_enabled", "cpu", "float32"])
def test_dispatch_takes_the_plain_path(case, kernels_on_cpu, monkeypatch, mobilenet):
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    model = mobilenet
    if case == "cpu":
        monkeypatch.setattr(layers, "_KERNEL_DEVICES", ("cuda",))
    if case == "float32":
        model = MobileNetV2(compute_dtype=torch.float32,
                            generator=torch.Generator().manual_seed(4)).eval()
    launches = (bf16_conv1x1_bn.launches, bf16_depthwise3x3_bn.launches)
    if case == "train_mode":
        model = copy.deepcopy(mobilenet).train()
        _, counts = _counted(model, x)
        assert counts == {}  # the counters count eval calls only
    else:
        _, counts = _counted(model, x, grad=case == "grad_enabled")
        assert counts == {"forward.conv_plain": 52}
    assert (bf16_conv1x1_bn.launches, bf16_depthwise3x3_bn.launches) == launches


def test_stem_and_a_1x1_with_stride_are_plain(kernels_on_cpu):
    g = torch.Generator().manual_seed(5)
    stem = ConvBnAct(3, 32, kernel_size=3, stride=2, padding=1, generator=g).eval()
    strided = ConvBnAct(8, 8, kernel_size=1, stride=2, generator=g).eval()
    dense3 = ConvBnAct(8, 8, kernel_size=3, generator=g).eval()
    no_bn = ConvBnAct(8, 8, kernel_size=1, batchnorm=False, generator=g).eval()
    x = torch.rand(1, 3, 8, 8, generator=g)
    assert _counted(stem, x)[1] == {"forward.conv_plain": 1}
    x = torch.rand(1, 8, 8, 8, generator=g).to(torch.bfloat16)
    for m in (strided, dense3, no_bn):
        assert _counted(m, x)[1] == {"forward.conv_plain": 1}
    assert _counted(ConvBnAct(8, 8, kernel_size=1, generator=g).eval(), x)[1] == \
        {"forward.conv_fused": 1}


@pytest.mark.parametrize("case", ["1x1_width", "dw3x3_width", "misaligned"])
def test_convs_off_the_kernels_16_byte_grid_are_plain(case, kernels_on_cpu):
    """The kernels move 16 bytes a copy: a channel count that is not a
    multiple of 8, or an input off a 16-byte boundary, runs the unfused path."""
    g = torch.Generator().manual_seed(12)
    if case == "dw3x3_width":
        m = ConvBnAct(12, 12, kernel_size=3, groups=12, generator=g)
    else:
        m = ConvBnAct(16, 20 if case == "1x1_width" else 16, kernel_size=1, generator=g)
    cin = m.conv.in_channels
    x = torch.rand(2 * 5 * 6 * cin + 1, generator=g).to(torch.bfloat16)
    x = x[1:] if case == "misaligned" else x[:-1]  # 2 bytes past the allocation's start
    x = x.view(2, 5, 6, cin).permute(0, 3, 1, 2)
    assert (x.data_ptr() % 16 != 0) == (case == "misaligned")
    assert _counted(m.eval(), x)[1] == {"forward.conv_plain": 1}


# --- the packed operands' cache -----------------------------------------------------------------


def _fused_eval(m, x):
    with torch.no_grad():
        return m.eval()(x)


@pytest.mark.parametrize("kind", ["1x1", "dw3x3"])
def test_an_optimizer_step_repacks(kind, kernels_on_cpu):
    """An eval after a train step (SGD on the weights, BatchNorm's running
    statistics moved) runs on the new weights: equal to a fresh copy's."""
    g = torch.Generator().manual_seed(9)
    m = ConvBnAct(16, 16, kernel_size=1, generator=g) if kind == "1x1" else \
        ConvBnAct(16, 16, kernel_size=3, groups=16, generator=g)
    x = torch.randn(2, 16, 6, 6, generator=g).to(torch.bfloat16)
    before = _fused_eval(m, x)
    packed = m._kernel_cache[1]["w"]
    opt = torch.optim.SGD(m.parameters(), lr=0.5)
    m.train()
    m(x).float().square().mean().backward()
    opt.step()
    after = _fused_eval(m, x)
    fresh = copy.deepcopy(m)
    fresh._kernel_cache = None
    assert m._kernel_cache[1]["w"] is not packed
    assert not torch.equal(after, before)
    assert torch.equal(after, _fused_eval(fresh, x))


def test_load_state_dict_repacks(kernels_on_cpu):
    g = torch.Generator().manual_seed(10)
    a = InvertedResidual(16, 16, stride=1, expand_ratio=6, generator=g).eval()
    b = InvertedResidual(16, 16, stride=1, expand_ratio=6, generator=g).eval()
    for blk in (a, b):
        for m in blk.modules():
            if isinstance(m, BatchNorm):
                _random_bn(m, g)
    x = torch.randn(2, 16, 6, 6, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        a(x)
        want = b(x)
        a.load_state_dict(b.state_dict())
        assert torch.equal(a(x), want)


# --- on the card -------------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    return torch.device("cuda")


def _flagship_convs():
    """(in, out, kernel, stride, relu, residual, H, W) of every fused conv of
    the flagship at 240x384: the input size each sees."""
    out, h, w, cin = [], 120, 192, 32
    for t, c, n, s in MOBILENET_V2_SETTINGS:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            if t != 1:
                out.append((cin, hidden, 1, 1, True, False, h, w))
            out.append((hidden, hidden, 3, stride, True, False, h, w))
            h, w = (h - 1) // stride + 1, (w - 1) // stride + 1
            out.append((hidden, c, 1, 1, False, stride == 1 and cin == c, h, w))
            cin = c
    out.append((cin, 1280, 1, 1, True, False, h, w))
    return out


FLAGSHIP_CONVS = _flagship_convs()


def _f32_reference(m: ConvBnAct, x: torch.Tensor, residual) -> torch.Tensor:
    """float32 conv (TF32 off) of the bf16 operands, float32 BatchNorm, ReLU
    and residual, no rounding to bf16."""
    conv = torch.nn.functional.conv2d(x.float(), m.conv.weight.to(torch.bfloat16).float(), None,
                                      m.conv.stride, m.conv.padding, groups=m.conv.groups)
    y = torch.nn.functional.batch_norm(conv, m.bn.running_mean, m.bn.running_var, m.bn.weight,
                                       m.bn.bias, False, 0.0, m.bn.eps)
    if m.activation:
        y = torch.relu(y)
    return y if residual is None else residual.float() + y


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,stride,relu,res,h,w", sorted(set(FLAGSHIP_CONVS)))
def test_kernel_at_flagship_shape_is_no_further_from_float32_than_cudnn(
        dev, cin, cout, k, stride, relu, res, h, w):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(cin * 7 + cout * 3 + h)
    groups = cin if k == 3 else 1
    m = ConvBnAct(cin, cout, kernel_size=k, stride=stride, groups=groups, activation=relu,
                  generator=g)
    _random_bn(m.bn, g)
    m = m.to(dev).eval()
    x = torch.relu(torch.randn(2, cin, h, w, generator=g)).to(dev, torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    residual = None
    if res:
        residual = torch.randn(2, cout, h, w, generator=g).to(dev, torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
    launches = bf16_conv1x1_bn.launches if k == 1 else bf16_depthwise3x3_bn.launches
    with torch.no_grad():
        fused = m(x, residual)
        with torch.enable_grad():
            plain = m(x, residual).detach()
        ref = _f32_reference(m, x, residual)
    torch.cuda.synchronize()
    assert (bf16_conv1x1_bn.launches if k == 1 else bf16_depthwise3x3_bn.launches) == launches + 1
    assert fused.dtype == torch.bfloat16 and fused.shape == plain.shape
    err_fused = (fused.float() - ref).abs().max().item()
    err_plain = (plain.float() - ref).abs().max().item()
    ulp = _bf16_ulp(ref.abs().max()).item()
    assert err_fused <= err_plain + ulp, (err_fused, err_plain, ulp)
    if k == 3:  # the depthwise kernel is its twin bit for bit
        assert torch.equal(fused.cpu(), _twin(m.cpu(), x.cpu()))


@pytest.mark.cuda
def test_flagship_forward_fused_against_plain(dev):
    """The trained flagship at batch 8: the fused forward's log-PDFs within a
    quarter of the float cell's limits (ori 1.0, pos 0.6) of the plain
    forward's, on every bin the plain one gives at least 1e-6."""
    from spef_tpu_torch.models.wrapper import import_model

    model = import_model("mobilenet_v2", "ursonet", residual=True, ori_mode="classification",
                         n_ori_bins=1232, pos_mode="classification", n_pos_bins=1000,
                         params_path="experiments/train_synth/exp_dspeed_synth/model/"
                                     "parameters.msgpack", device="cuda")
    x = torch.rand(8, 240, 384, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    launches = bf16_conv1x1_bn.launches, bf16_depthwise3x3_bn.launches
    with torch.inference_mode():
        fused = model(x)
    with torch.enable_grad():
        plain = model(x)
    assert bf16_conv1x1_bn.launches - launches[0] == 34
    assert bf16_depthwise3x3_bn.launches - launches[1] == 17
    for got, want, limit in ((fused[0], plain[0], 1.0), (fused[1], plain[1], 0.6)):
        lg = torch.log_softmax(got.float(), -1)
        lw = torch.log_softmax(want.detach().float(), -1)
        keep = lw.exp() >= 1e-6
        gap = (lg - lw).abs()[keep].max().item()
        assert gap <= 0.25 * limit, gap


def _integer_operands(kind, shape, dev, relu, residual):
    """Integer-valued activations and weights (every order of the conv's sum
    gives the same sum) with real BatchNorm terms."""
    g = torch.Generator().manual_seed(sum(shape) + 7 * relu + residual)
    ints = lambda *sh: torch.randint(-8, 9, sh, generator=g).float()  # noqa: E731
    if kind == "1x1":
        m, k, n = shape
        x = ints(m, k)
        w = pack_conv1x1_weights(ints(n, k, 1, 1))
    else:
        n = shape[-1]
        x = ints(*shape)
        w = pack_depthwise_weights(ints(n, 1, 3, 3))
    scale, shift = torch.rand(n, generator=g) + 0.5, torch.randn(n, generator=g)
    res = (torch.randn(shape[0], n, generator=g) * 4).to(dev, torch.bfloat16) if residual else None
    return x.to(dev, torch.bfloat16), w.to(dev), scale.to(dev), shift.to(dev), res


@pytest.mark.cuda
@pytest.mark.parametrize("shape,relu,residual", [
    ((5000, 16, 96), True, False), ((4097, 24, 144), True, False), ((777, 96, 24), False, True),
    ((1000, 144, 32), False, False), ((333, 576, 160), False, False),
    ((2000, 960, 320), False, False), ((513, 320, 1280), True, False), ((100, 40, 40), True, True),
])
def test_conv1x1_kernel_is_its_twin_on_integer_operands(dev, shape, relu, residual):
    x, w, scale, shift, res = _integer_operands("1x1", shape, dev, relu, residual)
    got = bf16_conv1x1_bn(x, w, scale, shift, relu, res)
    torch.cuda.synchronize()
    assert torch.equal(got, bf16_conv1x1_bn_plain(x, w, scale, shift, relu, res))


@pytest.mark.cuda
def test_wrappers_refuse_operands_off_the_16_byte_grid(dev):
    """A channel count off a multiple of 8, or an operand off a 16-byte
    boundary, raises before a launch."""
    scale, shift = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    w = pack_conv1x1_weights(torch.ones(16, 12, 1, 1)).to(dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        bf16_conv1x1_bn(torch.ones(64, 12, dtype=torch.bfloat16, device=dev), w, scale, shift)
    w = pack_conv1x1_weights(torch.ones(16, 16, 1, 1)).to(dev)
    x = torch.ones(64 * 16 + 1, dtype=torch.bfloat16, device=dev)[1:].view(64, 16)
    with pytest.raises(ValueError, match="16-byte"):
        bf16_conv1x1_bn(x, w, scale, shift)
    x = torch.ones(1, 4, 4, 12, dtype=torch.bfloat16, device=dev)
    wd = pack_depthwise_weights(torch.ones(12, 1, 3, 3)).to(dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        bf16_depthwise3x3_bn(x, wd, scale[:12].contiguous(), shift[:12].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,stride,relu", [
    ((2, 120, 192, 32), 1, True), ((2, 120, 192, 96), 2, True), ((3, 15, 24, 384), 1, False),
    ((2, 8, 12, 960), 1, True), ((2, 15, 24, 576), 2, True), ((2, 7, 9, 16), 1, True),
    ((1, 9, 7, 24), 2, True),
])
def test_depthwise_kernel_is_its_twin_bit_for_bit(dev, shape, stride, relu):
    x, w, scale, shift, _ = _integer_operands("dw3x3", shape, dev, relu, False)
    x = (x.float() * torch.rand(shape, device=dev)).to(torch.bfloat16)  # real values
    got = bf16_depthwise3x3_bn(x, w, scale, shift, stride, relu)
    torch.cuda.synchronize()
    assert torch.equal(got, bf16_depthwise3x3_bn_plain(x, w, scale, shift, stride, relu))
