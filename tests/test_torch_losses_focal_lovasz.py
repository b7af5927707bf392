"""The port's focal and Lovász losses (``esn_tpu_torch/train/losses.py``)
against the JAX package's, on the CPU: ``focal_loss``, ``lovasz_softmax``
(by sorting) and ``lovasz_softmax_hist`` (by counting), value and
gradient with respect to the logits, and the port's hist version against
its sort version.

Inputs come from numpy seeds, f32 on both sides. Tolerances are derived
or stated beside their readings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from esn_tpu.train import losses as JL
from esn_tpu_torch.models import build_model
from esn_tpu_torch.train import losses as L

C = 7
IGNORE = 255
U32 = 2.0 ** -24
# bf16 keeps 8 significant bits: rounding to nearest moves a value by at
# most 2^-8 of itself (the reference rounds its hist coefficients so)
U_BF16 = 2.0 ** -8


def _logits(seed, b=2, h=24, w=40, c=C, scale=2.0, ties=False):
    """Seeded NHWC logits and labels with ignored pixels and class 3
    absent; with ``ties`` every pixel of the left half is copied to the
    right half (logits and label), so each error ties with its copy's."""
    rng = np.random.RandomState(seed)
    z = (rng.randn(b, h, w, c) * scale).astype(np.float32)
    lab = rng.randint(0, c + 1, (b, h, w)).astype(np.int32)
    lab[lab == c] = IGNORE
    lab[lab == 3] = 4
    if ties:
        z[:, :, w // 2:] = z[:, :, :w // 2]
        lab[:, :, w // 2:] = lab[:, :, :w // 2]
    cw = (rng.rand(c) + 0.5).astype(np.float32)
    return z, lab, cw


def _jax(name, z, lab, **kw):
    fn = JL.build_loss(name)
    v, g = jax.value_and_grad(lambda zz: fn(
        zz, jnp.asarray(lab), num_classes=z.shape[-1], **kw))(jnp.asarray(z))
    return float(v), np.asarray(g)


def _port(name, z, lab, **kw):
    zt = torch.from_numpy(z).requires_grad_()
    loss = L.build_loss(name)(zt, torch.from_numpy(lab),
                              num_classes=z.shape[-1], **kw)
    loss.backward()
    return float(loss.detach()), zt.grad.numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# focal: f32 sums over ~2K pixels and exp/log of other libraries; read up
# to 9.2e-7 (value) and 1.05e-6 (gradient rel-L2)
FOCAL_REL = 1e-5


@pytest.mark.parametrize("gamma,weighted", [(2.0, True), (0.0, True),
                                            (2.0, False)])
def test_focal_matches_the_reference(gamma, weighted):
    z, lab, cw = _logits(0)
    kw = dict(gamma=gamma)
    v0, g0 = _jax("focal", z, lab, class_weights=jnp.asarray(cw) if weighted
                  else None, **kw)
    v, g = _port("focal", z, lab, class_weights=torch.from_numpy(cw)
                 if weighted else None, **kw)
    assert abs(v - v0) <= FOCAL_REL * abs(v0)
    assert _rel(g, g0) <= FOCAL_REL


def test_focal_at_gamma_0_is_cross_entropy():
    """(1 - p)^0 is 1 exactly, and the gamma term's backward adds zeros:
    the value and the gradient are cross_entropy's bit for bit."""
    z, lab, cw = _logits(1)
    kw = dict(class_weights=torch.from_numpy(cw))
    v, g = _port("focal", z, lab, gamma=0.0, **kw)
    v0, g0 = _port("ce", z, lab, **kw)
    assert v == v0
    np.testing.assert_array_equal(g, g0)


def _lovasz_oracle(z, lab):
    """The sorted Lovász-Softmax in f64 numpy (a stable sort of each
    class's errors, descending), and the absolute sum of its terms over
    the present classes' count."""
    c = z.shape[-1]
    p = np.exp(z.astype(np.float64) - z.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).reshape(-1, c)
    lab = lab.reshape(-1)
    valid = lab != IGNORE
    total = terms = 0.0
    present = 0
    for k in range(c):
        fg = ((lab == k) & valid).astype(np.float64)
        if not fg.any():
            continue
        e = np.abs(fg - p[:, k]) * valid
        order = np.argsort(-e, kind="stable")
        es, fs = e[order], fg[order]
        gts = fs.sum()
        jac = 1 - (gts - np.cumsum(fs)) / (gts + np.cumsum(1 - fs))
        grad = np.concatenate([jac[:1], np.diff(jac)])
        total += es @ grad
        terms += np.abs(es * grad).sum()
        present += 1
    return total / max(present, 1), terms / max(present, 1)


@pytest.mark.parametrize("ties", [False, True])
def test_lovasz_matches_the_reference(ties):
    """Value: within 1e-6 relative of an f64 oracle (the port sums in f32
    pairwise; read 5.7e-8), and within the f32 summation bound of the
    reference's (n 2^-24 times the terms' absolute sum, n the pixels, any
    summation order, for either side; read at 0.24% of it: the
    reference's f32 dot lies 6.0e-7 from the oracle here, 1.4e-5 at
    2x64x96). Gradient: within 1e-5 rel-L2 of the reference's (read
    1.3e-7). With ties, both sorts are stable, so each pixel of a tie
    block takes the reference's place and gradient; the tie blocks'
    gradient sums (a pixel and its copy) agree too."""
    z, lab, cw = _logits(2, ties=ties)
    v0, g0 = _jax("lovasz", z, lab)
    v, g = _port("lovasz", z, lab, class_weights=torch.from_numpy(cw))
    exact, terms = _lovasz_oracle(z, lab)
    n = lab.size
    assert abs(v - exact) <= 1e-6 * abs(exact)
    assert abs(v - v0) <= 2 * n * U32 * terms
    assert _rel(g, g0) <= 1e-5
    if ties:
        half = z.shape[2] // 2
        blocks, blocks0 = (a[:, :, :half] + a[:, :, half:] for a in (g, g0))
        assert _rel(blocks, blocks0) <= 1e-5


@pytest.mark.parametrize("name", ["lovasz", "lovasz_hist"])
def test_lovasz_with_every_pixel_ignored_is_zero(name):
    z, lab, _ = _logits(3)
    lab[:] = IGNORE
    for v, g in (_jax(name, z, lab), _port(name, z, lab)):
        assert v == 0.0
        assert not g.any()


def _hist_gradient_bound(z, lab, coef, present):
    """Per element, how far the reference's hist gradient with respect to
    the logits may lie from the port's: the reference rounds each
    coefficient to bf16 (at most U_BF16 of it), and d e_c / d z_k =
    ±p_c (δ_ck - p_k), so |Δg_k| <= Σ_c p_c |δ_ck - p_k| U_BF16 |coef_c|
    over the present classes' count."""
    c = z.shape[-1]
    p = np.exp(z.astype(np.float64) - z.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).reshape(-1, c)
    jac = p[:, :, None] * np.abs(np.eye(c)[None] - p[:, None, :])
    bound = np.einsum("ncj,nc->nj", jac, U_BF16 * np.abs(coef))
    return bound.reshape(z.shape) / max(int(present.sum()), 1)


@pytest.mark.parametrize("ties", [False, True])
def test_lovasz_hist_matches_the_reference(ties):
    """The port gathers the f32 coefficient of each pixel's key, the
    reference its bf16 rounding (``losses.py:447-449``): the value within
    (U_BF16 + n 2^-24) of the terms' sum Σ e·coef (each term moves by at
    most U_BF16 of itself, plus either side's f32 sum over n pixels), the
    gradient per element within ``_hist_gradient_bound`` plus 1e-6 of its
    largest (the f32 chain). Read: the value 4.8e-4 and 5.7e-4 relative
    (0.12 and 0.14 of its bound); the gradient's worst element at 0.99
    and 0.91 of its bound (one pixel whose dominant class's coefficient
    rounds by nearly the most bf16 allows)."""
    z, lab, _ = _logits(4, ties=ties)
    v0, g0 = _jax("lovasz_hist", z, lab)
    v, g = _port("lovasz_hist", z, lab)
    errors, fg, valid = L._lovasz_errors(torch.from_numpy(z),
                                         torch.from_numpy(lab), C, IGNORE)
    coef, present = L._lovasz_hist_coefficients(errors, fg, valid, 4096)
    npresent = max(int(present.sum()), 1)
    terms = float((errors * coef).abs().sum()) / npresent
    assert abs(v - v0) <= (U_BF16 + 2 * lab.size * U32) * terms + 1e-7
    bound = _hist_gradient_bound(z, lab, coef.numpy(), present.numpy())
    assert np.all(np.abs(g - g0) <= bound + 1e-6 * np.abs(g0).max())


@pytest.mark.parametrize("scale,ties", [(2.0, False), (2.0, True),
                                        (0.05, False)])
def test_lovasz_hist_lies_within_its_bound_of_the_sort(scale, ties):
    """The port's hist version against its sort version on the same
    logits (chip_smoke.lovasz_hist_vs_sort derives the bounds): the value
    within the key's quantisation, the gradient's rel-L2 within the bound
    from each bucket's spread of Jaccard increments, the sums over each
    bucket's tie block within LOVASZ_BLOCK_ABS. Small logits (scale 0.05)
    put many pixels in a bucket. Read: gradient rel-L2 0.087 and 0.049
    against bounds of 0.46 and 0.38; at scale 0.05 4.0e-6 against 0 (no
    bucket mixes foreground and background, so the sorted increments are
    constant within each: the f32 noise, under LOVASZ_SUM_REL); block
    sums within 2.8e-9."""
    z, lab, _ = _logits(5, b=2, h=32, w=48, c=19, scale=scale, ties=ties)
    zt, labt = torch.from_numpy(z), torch.from_numpy(lab)
    v_sort, g_sort = _port("lovasz", z, lab)
    v_hist, g_hist = _port("lovasz_hist", z, lab)
    gaps = chip_smoke.lovasz_hist_vs_sort(torch, zt, labt, classes=19)
    assert abs(v_hist - v_sort) <= (gaps["value_bound"]
                                    + chip_smoke.LOVASZ_SUM_REL * v_sort)
    assert (np.linalg.norm(g_hist - g_sort) <= gaps["grad_l2_bound"]
            + chip_smoke.LOVASZ_SUM_REL * np.linalg.norm(g_sort))
    assert gaps["block_sum_gap"] <= chip_smoke.LOVASZ_BLOCK_ABS


def test_lovasz_ignores_class_weights_and_the_registry_routes():
    """The Lovász losses take class weights and ignore them, as the
    reference's; none of the three new losses takes the fused resize-CE
    route, so a resize-tail model trains them on its full logits."""
    z, lab, cw = _logits(6)
    for name in ("lovasz", "lovasz_hist"):
        assert _port(name, z, lab)[0] == _port(
            name, z, lab, class_weights=torch.from_numpy(cw))[0]
    model = build_model("fastscnn", 19, device="cpu")
    for name in ("focal", "lovasz", "lovasz_hist"):
        assert L.build_loss(name) is L.LOSS_REGISTRY[name]
        assert L.fused_resize_ce_spec(model, name) == (None, None)
    assert set(L.LOSS_REGISTRY) == set(JL.LOSS_REGISTRY)
