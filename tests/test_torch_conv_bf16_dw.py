"""The port's ``conv2d`` on bf16 depthwise convs on the CPU.

torch's CPU convolution computes the weight gradient of a bf16 depthwise
conv (``groups == C``) in channels_last memory wrongly when the row
dilation is above 1 (rel-max 1.2-1.6 against an f64 run, NaN or 1e35 at
d=8, at 1 thread and at 8); the same conv on NCHW tensors is right.
``esn_tpu_torch.ops.convolution.conv2d`` takes that case (a CPU tensor,
bf16, depthwise, row dilation above 1) through NCHW copies and hands the
result back in x's memory format. The weight here is laid out as a model's
is after ``build_model`` (a ``Conv`` moved to channels_last: its (C, 1,
kh, kw) weight has channels_last strides and counts as contiguous too).
"""
import copy
from functools import partial

import pytest
import torch

from esn_tpu_torch.models import build_model
from esn_tpu_torch.nn import Conv, Dropout
from esn_tpu_torch.ops import convolution as C
from esn_tpu_torch.train import losses as L
from esn_tpu_torch.train.step import make_train_step

# bf16 has an 8-bit significand: a gradient summed in f32 from bf16 inputs
# lies ~3e-3 (rel-max) from the f64 one here (read 2.5e-3 to 4.1e-3 over
# these cases, both dilation axes, 1 and 8 threads)
BF16_REL = 1e-2
# (N, C, H, W), kernel, dilation: the row-dilated cases that were wrong,
# then the column-dilated and undilated ones, which were right before too
ROW_DILATED = [((2, 32, 24, 48), (3, 3), (2, 2)),
               ((2, 32, 24, 48), (3, 3), (4, 4)),
               ((2, 32, 24, 48), (3, 1), (2, 1)),
               ((2, 16, 48, 96), (3, 3), (8, 8)),
               ((2, 64, 96, 192), (3, 1), (4, 1))]
COLUMN_DILATED = [((2, 32, 24, 48), (1, 3), (1, 2)),
                  ((2, 32, 24, 48), (3, 3), (1, 2)),
                  ((2, 64, 96, 192), (1, 3), (1, 4)),
                  ((2, 32, 24, 48), (3, 3), (1, 1))]


@pytest.fixture(params=[1, 8], ids=["1thread", "8threads"])
def threads(request):
    n = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(n)


def _model_conv(c, kernel, dilation, rng):
    """A depthwise ``Conv`` with seeded weights in channels_last, as
    ``build_model`` leaves a model's."""
    pad = tuple(d * (k // 2) for k, d in zip(kernel, dilation))
    conv = Conv(c, c, kernel, padding=pad, dilation=dilation, groups=c,
                bias=False)
    conv.reset_parameters(rng)
    return conv.to(memory_format=torch.channels_last)


def _conv_grads(conv, x, go, dtype):
    """Output, dx and dW of ``conv`` run through the port's ``conv2d`` in
    ``dtype`` (f64 runs on an f64 copy)."""
    m = copy.deepcopy(conv).to(torch.float64 if dtype == torch.float64
                               else torch.float32)
    xx = x.to(dtype).contiguous(memory_format=torch.channels_last)
    xx.requires_grad_()
    y = m(xx)
    y.backward(go.to(dtype).contiguous(memory_format=torch.channels_last))
    return y, xx.grad.double(), m.weight.grad.double()


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("shape, kernel, dilation",
                         ROW_DILATED + COLUMN_DILATED,
                         ids=[f"{k[0]}x{k[1]}-d{d[0]}x{d[1]}-c{s[1]}"
                              for s, k, d in ROW_DILATED + COLUMN_DILATED])
def test_bf16_depthwise_gradients_match_f64(shape, kernel, dilation,
                                            threads):
    """bf16 channels_last depthwise conv through the port's ``conv2d``:
    dW, dx and the output within BF16_REL (rel-max) of an f64 run, at 1
    and 8 intra-op threads; the output stays channels_last."""
    gen = torch.Generator().manual_seed(0)
    conv = _model_conv(shape[1], kernel, dilation, gen)
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    x = torch.randn(shape, generator=gen)
    go = torch.randn(shape, generator=gen)
    y64, dx64, dw64 = _conv_grads(conv, x, go, torch.float64)
    y, dx, dw = _conv_grads(conv, x, go, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert bool(torch.isfinite(dw).all())
    assert _rel_max(dw, dw64) <= BF16_REL
    assert _rel_max(dx, dx64) <= BF16_REL
    assert _rel_max(y.detach().double(), y64.detach()) <= BF16_REL


@pytest.mark.parametrize("channels_last", [True, False],
                         ids=["channels_last", "nchw"])
def test_workaround_keeps_memory_format_and_values(channels_last):
    """The NCHW route hands back x's memory format, and the same values as
    the plain ``F.conv2d`` forward in bf16 (bit for bit: the same NCHW
    conv); the route is taken only for a CPU bf16 depthwise conv with a
    row dilation above 1."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 16, 20, 28), generator=gen).to(torch.bfloat16)
    w = torch.randn((16, 1, 3, 3), generator=gen).to(torch.bfloat16)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    y = C.conv2d(x, w, padding=2, dilation=2, groups=16)
    assert y.is_contiguous(memory_format=torch.channels_last) == channels_last
    want = torch.nn.functional.conv2d(x.contiguous(), w.contiguous(),
                                      padding=2, dilation=2, groups=16)
    assert torch.equal(y, want)
    take = C._cpu_bf16_row_dilated_depthwise
    assert take(x, 16, 2) and take(x, 16, (2, 1))
    assert not take(x, 16, 1) and not take(x, 16, (1, 2))
    assert not take(x, 4, 2) and not take(x.float(), 16, 2)
    assert not take(x.double(), 16, (4, 1))


STEP_HW = (64, 128)
# One train step at 2x3x64x128 (smooth seeded images, random labels) on 8
# threads, bf16 against f32: the same model, batch and loss, dropout off;
# three repeats of the step (the wrong dW gave NaN, inf or ~1e33 at random
# repeats). Per model: the loss within STEP_LOSS_REL of f32's, the
# gradient over all leaves within STEP_GRAD_REL rel-L2 and at least
# STEP_GRAD_COS cosine of f32's, where those hold anything. Random-weight
# bf16 gradients are ill-conditioned, so these bound finiteness and
# direction, not accuracy (the per-conv test above holds that):
# - ESPNetv2: against an f64 run its bf16 gradient reads 0.36 rel-L2
#   (cosine 0.94) where its f32 one reads 6.7e-3; against f32: loss
#   1.5e-4, gradient 0.37, cosine 0.933.
# - FPENet: a single train-mode FPE block's bf16 gradient already lies
#   0.11 (median leaf) from f64, where its f32 one lies 5e-7, and the
#   whole model's 1.1 (median leaf; cosine to f32's 0.14): no direction to
#   hold, only finiteness and the loss (read 2.3e-3).
STEP_BOUNDS = {"espnetv2": (2e-3, 0.6, 0.8), "fpenet": (1e-2, None, None)}


@pytest.mark.parametrize("arch", sorted(STEP_BOUNDS))
def test_bf16_train_step_is_finite_and_near_f32(arch):
    loss_rel, grad_rel, grad_cos = STEP_BOUNDS[arch]
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        gen = torch.Generator().manual_seed(1)
        low = torch.randn((2, 3, STEP_HW[0] // 16, STEP_HW[1] // 16),
                          generator=gen)
        x = (torch.nn.functional.interpolate(low, size=STEP_HW,
                                             mode="bilinear")
             + 0.1 * torch.randn((2, 3, *STEP_HW), generator=gen))
        lab = torch.randint(0, 19, (2, *STEP_HW), generator=gen,
                            dtype=torch.int32)
        base = build_model(arch, 19, device="cpu")
        for m in base.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0

        def step(dtype):
            m = copy.deepcopy(base)
            fused, method = L.fused_resize_ce_spec(m, "ce")
            loss = partial(fused or L.cross_entropy, num_classes=19)
            run = make_train_step(m, loss, torch.optim.SGD(m.parameters(),
                                                           lr=0.0),
                                  compute_dtype=dtype, fwd_method=method)
            value = float(run({"image": x, "label": lab})["loss"])
            return value, torch.cat([p.grad.double().flatten()
                                     for p in m.parameters()])

        loss32, g32 = step(torch.float32)
        for _ in range(3):
            loss16, g16 = step(torch.bfloat16)
            assert bool(torch.isfinite(g16).all())
            assert abs(loss16 - loss32) <= loss_rel * abs(loss32)
            if grad_rel is not None:
                assert float((g16 - g32).norm() / g32.norm()) <= grad_rel
                assert float(g16 @ g32 / (g16.norm() * g32.norm())) \
                    >= grad_cos
    finally:
        torch.set_num_threads(n)
