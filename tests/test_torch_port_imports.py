"""The port stands alone: importing all of ``esn_tpu_torch`` (its CLIs
too) and running a predict of each of its models on the CPU loads
none of ``jax``, ``esn_tpu``, ``flax``, ``msgpack``, ``cv2``, ``PIL`` or
``matplotlib`` (the card's machine has none of the last five).

Checked in a fresh interpreter, since this test process imports both
packages for the parity tests.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = ("fastscnn", "contextnet", "cgnet", "enet", "erfnet", "edanet",
         "segnet", "linknet", "espnetv2", "dabnet", "espnet_c", "espnet",
         "lednet", "esnet", "fpenet", "fssnet", "sqnet", "unet")
_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
import esn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(esn_tpu_torch.__path__,
                                               "esn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from esn_tpu_torch.models import build_model
from esn_tpu_torch.ops import kernels
from esn_tpu_torch.train.step import make_predict_step
images = torch.randn((1, 3, 64, 128), generator=torch.Generator().manual_seed(1))
preds = {}
for arch in ARCHS:
    model = build_model(arch, 19, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    pred = make_predict_step(model)(images)
    preds[arch] = [list(pred.shape), str(pred.dtype)]
print(json.dumps({
    "modules": names,
    "pred": preds,
    "launches": kernels.LAUNCHES,
    "loaded": sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "esn_tpu", "flax", "msgpack", "cv2", "PIL",
        "matplotlib")),
}))
"""


def test_port_imports_no_jax_and_predicts_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    probe = _PROBE.replace("ARCHS", repr(ARCHS))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    for name in ("esn_tpu_torch.cli", "esn_tpu_torch.cli.train",
                 "esn_tpu_torch.cli.test", "esn_tpu_torch.cli.predict",
                 "esn_tpu_torch.data.augment", "esn_tpu_torch.data.builders",
                 "esn_tpu_torch.data.datasets", "esn_tpu_torch.data.inform",
                 "esn_tpu_torch.data.loader", "esn_tpu_torch.data.palettes",
                 "esn_tpu_torch.data.png", "esn_tpu_torch.train.checkpoint",
                 "esn_tpu_torch.train.state", "esn_tpu_torch.train.trainer",
                 "esn_tpu_torch.utils.msgpack_decode",
                 "esn_tpu_torch.utils.profiling", "esn_tpu_torch.utils.seed",
                 "esn_tpu_torch.convert", "esn_tpu_torch.models.fastscnn",
                 "esn_tpu_torch.models.cgnet", "esn_tpu_torch.models.enet",
                 "esn_tpu_torch.models.contextnet",
                 "esn_tpu_torch.models.edanet", "esn_tpu_torch.models.erfnet",
                 "esn_tpu_torch.models.segnet", "esn_tpu_torch.models.linknet",
                 "esn_tpu_torch.models.espnetv2",
                 "esn_tpu_torch.models.dabnet", "esn_tpu_torch.models.espnet",
                 "esn_tpu_torch.models.lednet", "esn_tpu_torch.models.esnet",
                 "esn_tpu_torch.models.fpenet", "esn_tpu_torch.models.fssnet",
                 "esn_tpu_torch.models.sqnet", "esn_tpu_torch.models.unet",
                 "esn_tpu_torch.train.metrics",
                 "esn_tpu_torch.train.evaluation",
                 "esn_tpu_torch.ops.kernels.cgblock",
                 "esn_tpu_torch.ops.kernels.dsconv",
                 "esn_tpu_torch.ops.kernels.resize_argmax",
                 "esn_tpu_torch.ops.kernels.resize_ce",
                 "esn_tpu_torch.train.losses", "esn_tpu_torch.train.optimizers",
                 "esn_tpu_torch.train.schedules",
                 "esn_tpu_torch.train.step", "esn_tpu_torch.utils.params",
                 "esn_tpu_torch.parallel", "esn_tpu_torch.parallel.mesh",
                 "esn_tpu_torch.parallel.launch",
                 "esn_tpu_torch.parallel.dryrun",
                 "esn_tpu_torch.parallel.spatial",
                 "esn_tpu_torch.data.native",
                 "esn_tpu_torch.tools.golden_run",
                 "esn_tpu_torch.tools.pack_dataset"):
        assert name in out["modules"]
    assert out["pred"] == {arch: [[1, 64, 128], "torch.int32"]
                           for arch in ARCHS}
    # a CPU tensor runs the plain versions: no kernel launched
    assert out["launches"] == {"dsconv": 0, "resize_argmax": 0,
                               "resize_ce_fwd": 0, "resize_ce_bwd": 0,
                               "cgblock": 0, "resize_bilinear_bwd": 0,
                               "adaptive_pool_bwd": 0, "subpixel_argmax": 0,
                               "bn_moments": 0, "bn_apply": 0, "bn_bwd": 0}


_PNG_PROBE = r"""
import json, sys
sys.modules["cv2"] = None      # importing either now raises ImportError
sys.modules["PIL"] = None
import os, tempfile
import numpy as np
from esn_tpu_torch.data import CAMVID
from esn_tpu_torch.data.datasets import ManifestDataset, read_manifest
from esn_tpu_torch.tools.golden_run import build_fixture
root = build_fixture(tempfile.mkdtemp())
ds = ManifestDataset(read_manifest(
    os.path.join(root, "camvid", "camvid_train_list.txt")), CAMVID,
    resize_hw=(48, 64))
item = ds[0]
print(json.dumps({
    "shapes": [list(item["image"].shape), list(item["label"].shape)],
    "loaded": sorted(m for m, v in sys.modules.items() if v is not None
                     and m.split(".")[0] in ("cv2", "PIL", "jax",
                                             "esn_tpu")),
}))
"""


def test_png_manifest_reads_without_cv2_or_pil():
    """``ManifestDataset`` decodes PNG files with cv2 and PIL blocked
    from import, and loads neither (nor jax, nor the reference)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PNG_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"shapes": [[48, 64, 3], [48, 64]], "loaded": []}
