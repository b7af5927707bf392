"""Every model of the zoo, image height sharded over 2 ranks on the CPU
under gloo, against one process: each model's full forward in train
mode (f64, dropout off, weights from seed 0) at the envelope's least
height, 128 rows (4 at stride 32, LEDNet's 1/64 pyramid at 1 row a
shard), 64 columns, and its backward from a seeded cotangent.

The input gradient, each parameter's gradient summed over the ranks and
the BN statistics are held within 1e-10 of the largest value of each
kind. The logits too, except where a model's forward ends in the
reference's f32 upsample of its logits (``LOGITS_TAIL == "resize"``):
the f64 logits it rounds differ by ~1e-13 between the two runs (convs
over a shard sum in another order), which flips an f32 rounding here and
there, so those logits are held to one f32 ulp of their largest value
(the upsample itself is bit for bit the whole tensor's, see
``esn_tpu_torch/ops/resize.py``). One spawn runs all 18 models.
"""
import numpy as np
import pytest
import torch

import _torch_spatial as TS
from esn_tpu_torch.models import build_model
from esn_tpu_torch.parallel import launch

ARCHS = ("fastscnn", "contextnet", "cgnet", "enet", "erfnet", "edanet",
         "segnet", "linknet", "espnetv2", "dabnet", "espnet_c", "espnet",
         "lednet", "esnet", "fpenet", "fssnet", "sqnet", "unet")
HW = (128, 64)
F64, F32_ULP = 1e-10, 2.0 ** -23
LIMIT = 240.0


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    images = {a: rng.randn(1, 3, *HW) for a in ARCHS}
    cots = {a: rng.randn(1, 19, *HW) for a in ARCHS}
    one = TS.zoo_case(ARCHS, images, cots, 1)
    two = launch.run_ranks(TS.zoo_case, 2, ARCHS, images, cots, 2,
                           timeout=LIMIT)
    torch.set_num_threads(n)
    return one, two


def _scale(arrays):
    return max([1.0] + [float(np.abs(a).max()) for a in arrays])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_at_spatial_2_matches_one_process(runs, arch):
    one, two = runs[0][arch], [o[arch] for o in runs[1]]
    tail = getattr(build_model(arch, 19, device="cpu"), "LOGITS_TAIL", "")
    y = np.concatenate([o["y"] for o in two], axis=2)
    tol = F32_ULP if tail == "resize" else F64
    np.testing.assert_allclose(y, one["y"], rtol=0,
                               atol=tol * _scale([one["y"]]))
    dx = np.concatenate([o["dx"] for o in two], axis=2)
    np.testing.assert_allclose(dx, one["dx"], rtol=0,
                               atol=F64 * _scale([one["dx"]]))
    for o in two:
        assert set(o["grads"]) == set(one["grads"])
        scale = _scale(one["grads"].values())
        for k, g in one["grads"].items():
            np.testing.assert_allclose(o["grads"][k], g, rtol=0,
                                       atol=F64 * scale, err_msg=k)
        scale = _scale(one["state"].values())
        for k, v in one["state"].items():
            np.testing.assert_allclose(o["state"][k], v, rtol=0,
                                       atol=F64 * scale, err_msg=k)
