"""The frozen reference models against ``esn_tpu_torch`` on the CPU, at a
small size, on the same weights (this test imports both; the reference
files import neither the program nor JAX)."""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from esn_tpu_torch.models import build_model
from esn_tpu_torch.train.losses import resize_cross_entropy
from perfbench import bench
from perfbench.reference import layers as L
from perfbench.yardstick import shapes
from perfbench.yardstick.weights import make_weights

ARCHS = ["fastscnn", "cgnet"]


def pair(arch, seed=5):
    """The reference and the program in f64 on the benchmark's weights,
    with non-trivial running statistics."""
    ref = bench.reference_module(arch).build(19)
    w = make_weights(ref, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for k in w:
        if k.endswith("running_mean"):
            w[k] = 0.1 * torch.randn(w[k].shape, generator=g)
        if k.endswith("running_var"):
            w[k] = 0.5 + torch.rand(w[k].shape, generator=g)
    ref.load_state_dict(w)
    port = build_model(arch, 19, device="cpu")
    port.load_state_dict(w)
    return ref.double(), port.double()


def keep_all(ref, port):
    """Dropout off on both sides (the masks are compared on the card)."""
    for m in ref.modules():
        if isinstance(m, L.Dropout):
            m.rate = 0.0
    for m in port.modules():
        if hasattr(m, "rate"):
            m.rate = 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_agree(arch, train):
    """f64 in training; f32 in eval, where the program's fused blocks
    (their plain versions on the CPU) take f32 alone: the two sum in
    other orders, 1e-5 of the largest logit."""
    ref, port = pair(arch)
    keep_all(ref, port)
    dtype = torch.float64 if train else torch.float32
    ref.to(dtype)
    port.to(dtype)
    x = torch.randn(2, 3, 128, 256, generator=torch.Generator()
                    .manual_seed(1), dtype=dtype)
    ref.train(train)
    port.train(train)
    with torch.no_grad():
        a = ref.logits_lowres(x)
        b = port.logits_lowres(x.contiguous(memory_format=torch.channels_last))
    tol = 1e-9 if train else 1e-5
    assert float((a - b).abs().max()) <= tol * float(a.abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_agree(arch):
    """One weighted-CE step's loss and every gradient, f64: the
    reference's upsample + cross-entropy against the program's fused
    resize-CE route (its plain version on the CPU)."""
    ref, port = pair(arch)
    keep_all(ref, port)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 128, 256, generator=gen, dtype=torch.float64)
    y = torch.randint(0, 19, (2, 128, 256), generator=gen)
    y[:, 60:68] = 255
    cw = 1 + torch.rand(19, generator=gen, dtype=torch.float64)
    ref.train()
    port.train()
    lr = F.cross_entropy(ref(x), y, weight=cw, ignore_index=255)
    lr.backward()
    z = port.logits_lowres(x.contiguous(memory_format=torch.channels_last))
    lp = resize_cross_entropy(z.permute(0, 2, 3, 1), y.int(), num_classes=19,
                              class_weights=cw, ignore_index=255)
    lp.backward()
    assert abs(float((lr - lp).detach())) <= 1e-10 * abs(float(lr.detach()))
    pp = dict(port.named_parameters())
    norms = sorted(float(p.grad.norm()) for p in ref.parameters())
    median = norms[len(norms) // 2]
    for k, p in ref.named_parameters():
        g, h = p.grad, pp[k].grad
        # a leaf whose gradient is round-off (a shift the next BN removes)
        # is held to the median leaf's scale
        assert float((g - h).norm()) <= 1e-7 * max(float(g.norm()),
                                                   median), k


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_count_as_recorded(arch):
    cfg = next(c for c in bench.load_benchmark()["configs"]
               if c["name"].startswith(arch))
    import json
    recorded = json.loads((bench.ROOT / cfg["file"]).read_text())
    model = shapes.meta_model(bench.reference_module(arch).build, 19)
    assert sum(p.numel() for p in model.parameters()) == \
        recorded["parameters"]


def test_fp8_numerics_round():
    """The control's rounding: an e4m3 value keeps 3 mantissa bits."""
    q = L.Numerics("fp8")
    t = torch.linspace(-3, 3, 1001)
    err = (q(t) - t).abs() / t.abs().clamp(min=1e-3)
    assert 0.01 < float(err[t.abs() > 0.1].max()) <= 2.0 ** -4
