"""The port's losses and the plain version of its resize-CE kernel against
the JAX reference, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages in
f32. The reference's Pallas resize-CE kernel runs in interpret mode, as
its own tests run it (``tests/test_pallas_resize_ce.py``). The CUDA
kernel itself is held against the same plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esn_tpu.ops.pallas.resize_ce import resize_ce_sums as jax_resize_ce_sums
from esn_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from esn_tpu.train import losses as JL

from esn_tpu_torch.ops import kernels as K
from esn_tpu_torch.train import losses as L

# value: f32 sums over up to 16K pixels, taken in other orders;
# gradient rel-L2: as tests/test_pallas_resize_ce.py
LOSS_ATOL, GRAD_REL = 1e-5, 1e-4

CASES = [
    # (B, h, w, C, r, eps, weighted): tests/test_pallas_resize_ce.py's
    # cases, then odd h and w at r = 3
    (2, 8, 16, 19, 8, 0.0, True),
    (1, 4, 8, 5, 8, 0.1, False),
    (1, 8, 8, 11, 4, 0.0, True),
    (2, 16, 32, 19, 2, 0.1, True),
    (1, 24, 16, 19, 8, 0.0, True),
    (2, 5, 7, 19, 3, 0.0, True),
]


def _case(B, h, w, C, r, weighted, seed=None):
    rng = np.random.RandomState(B * h + C if seed is None else seed)
    z = rng.randn(B, h, w, C).astype(np.float32)
    lab = rng.randint(0, C + 1, (B, h * r, w * r)).astype(np.int32)
    lab[lab == C] = 255                      # sprinkle ignore pixels
    cw = (rng.rand(C) + 0.5).astype(np.float32) if weighted else None
    return z, lab, cw


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _port_loss_and_grad(fn, z, *args, **kw):
    zt = torch.from_numpy(z).requires_grad_()
    loss = fn(zt, *args, **kw)
    loss.backward()
    return float(loss.detach()), zt.grad.numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_resize_ce():
    """The reference's fused value-and-grad (Pallas, interpret mode) and
    its materialized CE(resize_bilinear(z)), each traced once per shape."""
    cache = {}

    def get(kind, shape, r, eps, weighted):
        key = (kind, shape, r, eps, weighted)
        if key not in cache:
            H, W = shape[1] * r, shape[2] * r
            C = shape[3]

            def fused(zz, lab, cw):
                s, n = jax_resize_ce_sums(zz, lab, cw, r=r, ignore_index=255,
                                          label_smoothing=eps,
                                          interpret=True)
                return s / jnp.maximum(n, 1e-8)

            def materialized(zz, lab, cw):
                full = jax_resize_bilinear(zz, (H, W))
                return JL.cross_entropy(full, lab, num_classes=C,
                                        class_weights=cw, ignore_index=255,
                                        label_smoothing=eps)

            fn = fused if kind == "fused" else materialized
            cache[key] = jax.jit(jax.value_and_grad(fn))
        return cache[key]
    return get


@pytest.mark.parametrize("B,h,w,C,r,eps,weighted", CASES)
def test_resize_ce_ref_matches_reference(jax_resize_ce, B, h, w, C, r, eps,
                                         weighted):
    """Port plain version: value and dz against the reference's Pallas
    kernel (interpret) and its materialized CE(resize_bilinear(z))."""
    z, lab, cw = _case(B, h, w, C, r, weighted)

    def port(zt):
        s, n = K.resize_ce_sums_ref(zt, _t(lab), _t(cw), r=r,
                                    ignore_index=255, label_smoothing=eps)
        return s / torch.clamp(n, min=1e-8)

    got, dz = _port_loss_and_grad(port, z)
    jargs = (jnp.asarray(z), jnp.asarray(lab),
             None if cw is None else jnp.asarray(cw))
    for kind in ("fused", "materialized"):
        want, jdz = jax_resize_ce(kind, z.shape, r, eps, weighted)(*jargs)
        assert abs(got - float(want)) <= LOSS_ATOL, (kind, got, float(want))
        assert _rel(dz, np.asarray(jdz)) <= GRAD_REL, kind


def test_resize_ce_sums_are_sums():
    """(S, N) separately: N is the summed class weight of the valid
    pixels, S / N the loss."""
    z, lab, cw = _case(1, 4, 6, 7, 2, True, seed=11)
    s, n = K.resize_ce_sums_ref(_t(z), _t(lab), _t(cw), r=2)
    valid = lab != 255
    assert float(n) == pytest.approx(float(cw[lab[valid]].sum()), rel=1e-6)
    want = float(JL.cross_entropy(
        jax_resize_bilinear(jnp.asarray(z), (8, 12)), jnp.asarray(lab),
        num_classes=7, class_weights=jnp.asarray(cw)))
    assert float(s / n) == pytest.approx(want, abs=LOSS_ATOL)


def test_resize_ce_all_ignored_is_finite():
    z = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 4, 5)
                         .astype(np.float32)).requires_grad_()
    lab = torch.full((1, 16, 16), 255, dtype=torch.int32)
    loss = L.resize_cross_entropy(z, lab, num_classes=5)
    loss.backward()
    assert float(loss.detach()) == 0.0 and float(z.grad.abs().max()) == 0.0


def test_resize_ce_wrapper_takes_plain_version_on_cpu():
    z, lab, cw = _case(1, 3, 5, 4, 2, True, seed=3)
    before = dict(K.LAUNCHES)
    got = K.resize_ce_sums(_t(z), _t(lab), _t(cw), r=2, label_smoothing=0.1)
    want = K.resize_ce_sums_ref(_t(z), _t(lab), _t(cw), r=2,
                                label_smoothing=0.1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.LAUNCHES == before          # no kernel launched on the CPU


def test_resize_ce_wrapper_rejects_what_it_cannot_run():
    z, lab, cw = (_t(a) for a in _case(1, 3, 5, 4, 2, True, seed=4))
    with pytest.raises(ValueError, match="labels"):
        K.resize_ce_sums(z, lab[:, :-1], cw, r=2)
    with pytest.raises(ValueError, match="r=17"):
        K.resize_ce_sums(z, lab, cw, r=17)
    with pytest.raises(ValueError, match="class_weights"):
        K.resize_ce_sums(z, lab, cw[:3], r=2)
    # a device with no kernel raises; it never falls back to the CPU
    with pytest.raises(ValueError, match="no kernel for device"):
        K.resize_ce_sums(z.to("meta"), lab.to("meta"), cw.to("meta"), r=2)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [True, False])
def test_cross_entropy_matches_reference(eps, weighted):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 11, 6).astype(np.float32) * 2
    lab = rng.randint(0, 8, (2, 9, 11)).astype(np.int32)
    lab[lab == 7] = 255                  # ignored; 6 is out of range
    cw = (rng.rand(6) + 0.5).astype(np.float32) if weighted else None
    got, dx = _port_loss_and_grad(L.cross_entropy, x, _t(lab),
                                  num_classes=6, class_weights=_t(cw),
                                  label_smoothing=eps)
    jfn = lambda xx: JL.cross_entropy(
        xx, jnp.asarray(lab), num_classes=6, label_smoothing=eps,
        class_weights=None if cw is None else jnp.asarray(cw))
    want, jdx = jax.value_and_grad(jfn)(jnp.asarray(x))
    assert abs(got - float(want)) <= LOSS_ATOL
    assert _rel(dx, np.asarray(jdx)) <= GRAD_REL


@pytest.mark.parametrize("min_kept", [None, 5, 300])
def test_ohem_kept_mask_and_value_match_reference(min_kept):
    """The kept mask is identical to the reference's (its exact radix
    k-th smallest against torch.kthvalue, on the reference's own
    per-pixel probabilities), and the loss and gradient agree."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 10, 12, 5).astype(np.float32) * 3
    lab = rng.randint(0, 6, (2, 10, 12)).astype(np.int32)
    lab[lab == 5] = 255
    cw = (rng.rand(5) + 0.5).astype(np.float32)
    total = lab.size
    k = min(max(total // 16, 1) if min_kept is None else min_kept, total)
    nll, _, valid = JL._per_pixel_ce(jnp.asarray(x), jnp.asarray(lab), 5, 255)
    p = jnp.where(valid, jnp.exp(-nll), 2.0).reshape(-1)
    want_mask = np.asarray((p <= jnp.maximum(JL.kth_smallest(p, k), 0.7))
                           & valid.reshape(-1))
    got_mask = L.ohem_kept_mask(torch.from_numpy(np.array(nll)),
                                torch.from_numpy(np.array(valid)), 0.7, k)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert 0 < want_mask.sum() <= valid.sum()
    # the port's own probabilities pick the same pixels
    pnll, _, pvalid = L._per_pixel_ce(_t(x), _t(lab), 5, 255)
    np.testing.assert_array_equal(
        L.ohem_kept_mask(pnll, pvalid, 0.7, k).numpy(), want_mask)
    got, dx = _port_loss_and_grad(L.ohem_cross_entropy, x, _t(lab),
                                  num_classes=5, class_weights=_t(cw),
                                  min_kept=min_kept)
    want, jdx = jax.value_and_grad(lambda xx: JL.ohem_cross_entropy(
        xx, jnp.asarray(lab), num_classes=5, class_weights=jnp.asarray(cw),
        min_kept=min_kept))(jnp.asarray(x))
    assert abs(got - float(want)) <= LOSS_ATOL
    assert _rel(dx, np.asarray(jdx)) <= GRAD_REL


@pytest.mark.parametrize("z_hw, lab_hw", [
    ((4, 6), (10, 15)),      # non-integer scale
    ((4, 6), (8, 18)),       # anisotropic
    ((4, 6), (4, 6)),        # r = 1
    ((2, 3), (34, 51)),      # r = 17, above the kernel's range
])
def test_resize_cross_entropy_other_scales_take_materialized_path(z_hw,
                                                                  lab_hw):
    rng = np.random.RandomState(7)
    z = rng.randn(2, *z_hw, 5).astype(np.float32)
    lab = rng.randint(0, 5, (2, *lab_hw)).astype(np.int32)
    cw = (rng.rand(5) + 0.5).astype(np.float32)
    before = dict(K.LAUNCHES)
    got, dz = _port_loss_and_grad(L.resize_cross_entropy, z, _t(lab),
                                  num_classes=5, class_weights=_t(cw))
    want, jdz = jax.value_and_grad(lambda zz: JL.cross_entropy(
        jax_resize_bilinear(zz, lab_hw), jnp.asarray(lab), num_classes=5,
        class_weights=jnp.asarray(cw)))(jnp.asarray(z))
    assert abs(got - float(want)) <= LOSS_ATOL
    assert _rel(dz, np.asarray(jdz)) <= GRAD_REL
    assert K.LAUNCHES == before


def test_resize_cross_entropy_integer_scale_uses_resize_ce_sums(monkeypatch):
    calls = []

    def spy(*args, **kw):
        calls.append(kw["r"])
        return K.resize_ce_sums_ref(*args, **kw)

    monkeypatch.setattr(K, "resize_ce_sums", spy)
    z, lab, cw = _case(1, 3, 4, 5, 4, True, seed=8)
    L.resize_cross_entropy(_t(z), _t(lab), num_classes=5,
                           class_weights=_t(cw))
    assert calls == [4]


def test_build_loss_and_fused_spec():
    from esn_tpu_torch.models import build_model
    ce = L.build_loss("ce", num_classes=3)
    x = torch.zeros((1, 2, 2, 3))
    lab = torch.zeros((1, 2, 2), dtype=torch.int32)
    assert float(ce(x, lab)) == pytest.approx(np.log(3))
    assert L.build_loss("label_smoothing").keywords == {"label_smoothing": 0.1}
    with pytest.raises(KeyError):
        L.build_loss("focal")
    model = build_model("fastscnn", 4, device="cpu")
    for name, eps in (("ce", 0.0), ("label_smoothing", 0.1)):
        fn, method = L.fused_resize_ce_spec(model, name)
        assert method == "logits_lowres"
        assert fn.func is L.resize_cross_entropy
        assert fn.keywords == {"label_smoothing": eps}
    assert L.fused_resize_ce_spec(model, "ohem") == (None, None)
    assert L.fused_resize_ce_spec(torch.nn.Identity(), "ce") == (None, None)
