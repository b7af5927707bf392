"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. This file imports neither JAX nor the reference package, so it runs
on a machine without JAX; ``tests/conftest.py`` imports JAX, so skip it
there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The same checks at the main path's full shapes are ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from esn_tpu_torch.models import build_model
from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train.step import make_predict_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    # f32 plain versions in full f32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _dsconv_args(seed, n, h, w, ci, co, dtype, device):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return (t(rng.randn(n, h, w, ci)).to(dtype), t(rng.randn(3, 3, ci) * 0.3),
            t(rng.rand(ci) + 0.5), t(rng.randn(ci) * 0.1),
            t(rng.randn(ci, co) * 0.2), t(rng.rand(co) + 0.5),
            t(rng.randn(co) * 0.1))


@pytest.mark.parametrize("dtype, atol, rtol", [
    (torch.float32, 1e-4, 1e-4),       # both sum in f32, in other orders
    (torch.bfloat16, 5e-2, 2e-2),      # output rounds to bf16; plain rounds
])                                     # its depthwise result too
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape, co, acts", [
    ((2, 16, 16, 32), 48, ("relu", "relu")),
    ((1, 9, 15, 24), 16, ("relu6", "none")),       # odd H/W
    ((2, 17, 33, 128), 128, ("relu", "relu6")),    # 128 -> 128, > 48 KB smem
])
def test_dsconv_kernel_matches_plain(cuda, shape, co, acts, stride, dtype,
                                     atol, rtol):
    args = _dsconv_args(0, *shape, co, dtype, cuda)
    kw = dict(stride=stride, act1=acts[0], act2=acts[1])
    before = K.LAUNCHES["dsconv"]
    got = K.fused_dsconv(*args, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["dsconv"] == before + 1
    want = K.dsconv_ref(*args, **kw)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_dsconv_wrapper_raises_on_cuda(cuda):
    args = _dsconv_args(1, 1, 8, 8, 8, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_dsconv(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(TypeError, match="dtype"):
        K.fused_dsconv(args[0].half(), *args[1:])
    with pytest.raises(RuntimeError, match="forward-only"):
        K.fused_dsconv(args[0].requires_grad_(), *args[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, r", [((2, 8, 24, 19), 8),
                                      ((1, 5, 7, 19), 3), ((2, 6, 6, 2), 2)])
def test_resize_argmax_kernel_matches_plain(cuda, shape, r, dtype):
    """Equal to the plain version except where the two classes' f32
    upsampled logits lie within the rounding gap (1e-5 for f32; for bf16
    the plain version rounds them to bf16, one ulp <= 2^-7 of the value)."""
    y = torch.from_numpy(np.random.RandomState(2).randn(*shape)
                         .astype(np.float32)).to(cuda, dtype)
    before = K.LAUNCHES["resize_argmax"]
    got = K.resize_argmax(y, r)
    torch.cuda.synchronize()
    assert K.LAUNCHES["resize_argmax"] == before + 1
    want = K.resize_argmax_ref(y, r)
    assert got.shape == want.shape and got.dtype == torch.int32
    n, h, w, c = shape
    up = torch.nn.functional.interpolate(
        y.permute(0, 3, 1, 2).float(), size=(h * r, w * r), mode="bilinear",
        align_corners=False)
    a = up.gather(1, got.long()[:, None])[:, 0]
    b = up.gather(1, want.long()[:, None])[:, 0]
    gap = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    tol = gap * torch.clamp(torch.maximum(a.abs(), b.abs()), min=1.0)
    assert bool(((a - b).abs() <= tol).all())


def test_resize_argmax_first_max(cuda):
    got = K.resize_argmax(torch.zeros((1, 4, 8, 6), device=cuda), 2)
    assert bool((got == 0).all())


def test_fastscnn_predict_on_cuda_matches_cpu(cuda):
    """f32 predict through both kernels on the card == the CPU's predict
    through the plain versions, except at near-ties (rate <= 1e-4)."""
    model = build_model("fastscnn", 19,
                        generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.RandomState(3)
                              .randn(2, 3, 128, 256).astype(np.float32))
    want = make_predict_step(model)(images)
    before = dict(K.LAUNCHES)
    got = make_predict_step(model.to(cuda))(images.to(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["dsconv"] == before["dsconv"] + 4
    assert K.LAUNCHES["resize_argmax"] == before["resize_argmax"] + 1
    assert got.shape == want.shape and got.dtype == torch.int32
    assert (got.cpu() != want).float().mean() <= 1e-4
