"""The kernels' work counts and the configurations' FLOP counts.

The work counts of K1-K4 at chip_smoke's shapes give PERF.md §6's
``bound_ms`` (NVIDIA H100 peaks: 3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s
bf16): K1 (8,128,256,19) r = 8 0.023 ms; K2 Fast-SCNN's four DSConvs
0.230 ms a predict; K3 (8,128,256,19) r = 8, 5% of the labels ignored,
0.068 ms a step; K4 CGNet's 22 blocks 0.962 ms a predict."""
from __future__ import annotations

import json
import types

import pytest

from perfbench import bench
from perfbench.yardstick import shapes
from perfbench.yardstick.peaks import least_seconds

WORK = {m.__name__.rsplit("._", 1)[-1]: m for m in bench.work_modules()}
BF16 = types.SimpleNamespace(itemsize=2, valid_pixels=0)


def bound_ms(kernel, calls, cell=BF16):
    return 1e3 * sum(least_seconds(*w)
                     for w in WORK[kernel].launches(calls, cell))


def tail(n, c, h, w, r):
    return [{"cls": "Resize", "name": "tail", "args": [(n, c, h, w)],
             "out": (n, c, h * r, w * r), "module": None}]


def model_calls(arch, train=False):
    model = shapes.meta_model(bench.reference_module(arch).build, 19)
    return shapes.layer_calls(model, 8, (1024, 2048), train)


def test_k1():
    assert round(bound_ms("k1_resize_argmax", tail(8, 19, 128, 256, 8)),
                 3) == 0.023


def test_k2_fastscnn_predict():
    calls = model_calls("fastscnn")
    assert len(WORK["k2_dsconv"].launches(calls, BF16)) == 4
    assert round(bound_ms("k2_dsconv", calls), 3) == 0.230


def test_k3():
    cell = types.SimpleNamespace(itemsize=2,
                                 valid_pixels=round(0.95 * 8 * 1024 * 2048))
    assert round(bound_ms("k3_resize_ce", tail(8, 19, 128, 256, 8), cell),
                 3) == 0.068


def test_k4_cgnet_predict():
    calls = model_calls("cgnet")
    assert len(WORK["k4_cgblock"].launches(calls, BF16)) == 22
    assert round(bound_ms("k4_cgblock", calls), 3) == 0.962


def test_train_launches():
    """K5 for PPM's four upsamples and the fusion's x4, K6 for PPM's four
    pools, on Fast-SCNN's training path; neither on CGNet's."""
    fs, cg = model_calls("fastscnn", True), model_calls("cgnet", True)
    assert len(WORK["k5_resize_bilinear_bwd"].launches(fs, BF16)) == 5
    assert len(WORK["k6_adaptive_pool_bwd"].launches(fs, BF16)) == 4
    assert not WORK["k5_resize_bilinear_bwd"].launches(cg, BF16)
    assert not WORK["k6_adaptive_pool_bwd"].launches(cg, BF16)


@pytest.mark.parametrize("name", ["fastscnn-19-cityscapes",
                                  "cgnet-19-cityscapes"])
def test_flops_as_recorded(name):
    cfg = next(c for c in bench.load_benchmark()["configs"]
               if c["name"] == name)
    rec = json.loads((bench.ROOT / cfg["file"]).read_text())
    model = shapes.meta_model(bench.reference_module(rec["reference"]).build,
                              rec["classes"])
    hw = tuple(rec["image_hw"])
    assert shapes.model_flops(model, 1, hw, False) == \
        rec["flops_forward_per_image"]
    assert shapes.model_flops(model, 1, hw, True) == \
        rec["flops_train_step_per_image"]
