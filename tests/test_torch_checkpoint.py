"""The port's checkpoints: its msgpack decoder against ``msgpack``, the JAX
package's checkpoints read without ``msgpack`` or ``flax``, and its own
save -> load. Every comparison here is exact.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from esn_tpu.models import build_model as jax_build_model
from esn_tpu.train import checkpoint as jax_ckpt
from esn_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from esn_tpu.train.state import TrainState as JaxTrainState
from esn_tpu_torch import convert
from esn_tpu_torch.models import build_model
from esn_tpu_torch.train import checkpoint as ckpt
from esn_tpu_torch.train.optimizers import build_optimizer
from esn_tpu_torch.train.state import TrainState
from esn_tpu_torch.utils import msgpack_decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --------------------------------------------------------------- decoder

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40)
            | st.binary(max_size=300))
_trees = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=12), inner, max_size=20)
                   | st.builds(msgpack.ExtType,
                               st.integers(min_value=0, max_value=127),
                               st.binary(max_size=40))),
    max_leaves=60)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: the quick tier runs six
    workers on a few cores, and torch's OpenMP threads, one team per
    worker, then spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@settings(max_examples=150, deadline=None, database=None)
@given(tree=_trees, single_float=st.booleans())
def test_decoder_matches_msgpack(tree, single_float):
    data = msgpack.packb(tree, use_bin_type=True,
                         use_single_float=single_float)
    assert msgpack_decode.unpackb(data) == msgpack.unpackb(
        data, raw=False, strict_map_key=False)


@pytest.mark.parametrize("size", [0, 31, 32, 255, 256, 65535, 65536, 70000])
def test_decoder_lengths_big_endian(size):
    """Every str / bin / array / map length form (fix, 8, 16, 32 bit)."""
    tree = {"s": "x" * size, "b": b"\x01" * size, "a": list(range(size % 70000)),
            "m": {str(i): i for i in range(min(size, 70000))}}
    data = msgpack.packb(tree, use_bin_type=True)
    assert msgpack_decode.unpackb(data) == msgpack.unpackb(data)


def test_decoder_rejects_truncated_and_trailing_bytes():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        msgpack_decode.unpackb(data[:-1])
    with pytest.raises(ValueError):
        msgpack_decode.unpackb(data + b"\x00")


def test_flax_restore_matches(monkeypatch):
    """flax's array ext types: ndarrays of every dtype the packages write,
    shape (), numpy scalars, bfloat16, complex, and chunked arrays."""
    rng = np.random.RandomState(0)
    tree = {"f32": rng.randn(3, 4).astype(np.float32),
            "i32": np.asarray(7, np.int32),           # TrainState.step
            "u8": rng.randint(0, 255, (5,)).astype(np.uint8),
            "f64": rng.randn(2, 2), "scalar": np.float32(2.5),
            "big": rng.randn(40000).astype(np.float32),  # bin 32
            "nested": {"0": {}, "1": {"count": np.asarray(3, np.int32)}},
            "c": 1 + 2j, "meta": {"epoch": 3, "mIoU": 0.25, "name": "x"}}
    data = serialization.msgpack_serialize(tree)
    got = msgpack_decode.restore(data)
    want = serialization.msgpack_restore(data)
    _assert_tree_equal(got, want)
    assert isinstance(got["scalar"], np.float32) and got["i32"].shape == ()

    bf16 = np.asarray(jnp.asarray([1.5, -2.0, 3.25], jnp.bfloat16))
    got = msgpack_decode.restore(serialization.msgpack_serialize({"w": bf16}))
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  bf16.astype(np.float32))

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize({"w": tree["f32"],
                                            "v": {"x": tree["big"]}})
    assert b"__msgpack_chunked_array__" in data
    _assert_tree_equal(msgpack_decode.restore(data),
                       {"w": tree["f32"], "v": {"x": tree["big"]}})


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


# ------------------------------------------- JAX checkpoints, no msgpack

_PROBE = r"""
import json, sys
for name in ("msgpack", "flax", "jax", "esn_tpu"):
    sys.modules[name] = None        # importing any of them now raises
import torch
from esn_tpu_torch.models import build_model
from esn_tpu_torch.train import checkpoint as ckpt
from esn_tpu_torch.train.optimizers import build_optimizer
from esn_tpu_torch.train.state import TrainState
arch, optim, path, out = sys.argv[1:5]
model = build_model(arch, 19, device="cpu")
opt = build_optimizer(optim, model.parameters())
state, meta = ckpt.load_checkpoint(path, TrainState(model, opt))
infer = build_model(arch, 19, device="cpu")
_, meta2 = ckpt.load_variables(path, infer)
torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
            "step": state.step, "meta": meta, "infer": infer.state_dict(),
            "meta2": meta2}, out)
print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("msgpack", "flax", "jax",
                                                 "esn_tpu", "PIL", "cv2"))))
"""


def _jax_state(arch, optim="adam"):
    """A JAX ``TrainState`` of ``arch`` with ``optim`` in the state of a
    run one step in: every float leaf (params, BN stats, adam's moments or
    SGD's momentum) a
    distinct seeded value, so that a swapped or mislaid leaf cannot pass;
    adam's count and the step 1. Shapes from ``jax.eval_shape``: nothing
    is compiled."""
    jmodel = jax_build_model(arch, 19)
    tx = jax_build_optimizer(optim, 1e-3)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, 64, 128, 3), jnp.float32)),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def fill(leaf):
        if jnp.issubdtype(leaf.dtype, jnp.integer):
            return np.asarray(1, leaf.dtype)
        return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)

    params, stats = (jax.tree_util.tree_map(fill, shapes[c])
                     for c in ("params", "stats"))
    opt_state = jax.tree_util.tree_map(
        fill, jax.eval_shape(tx.init, shapes["params"]))
    return JaxTrainState(params, stats, opt_state, np.asarray(1, np.int32))


@pytest.mark.parametrize("arch,optim", [("fastscnn", "adam"),
                                        ("enet", "adam"),
                                        ("fastscnn", "sgd")])
def test_jax_checkpoint_loads_without_msgpack_or_flax(tmp_path, arch, optim):
    jstate = _jax_state(arch, optim)
    path = jax_ckpt.save_checkpoint(str(tmp_path), 4, jstate,
                                    {"mIoU": 0.375, "loss": 1.5})
    out = str(tmp_path / "port.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE, arch, optim, path,
                           out],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    got = torch.load(out, weights_only=True)

    model = build_model(arch, 19, device="cpu")
    want = convert.to_state_dict(
        {"params": jax.device_get(jstate.params),
         "stats": jax.device_get(jstate.stats)}, model)
    for sd in (got["model"], got["infer"]):
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), k
    opt = build_optimizer(optim, model.parameters())
    convert.load_optimizer_state(opt, model, jax.device_get(jstate.opt_state))
    want_opt = opt.state_dict()["state"]
    assert set(got["optimizer"]["state"]) == set(want_opt) == set(
        range(len(list(model.parameters()))))
    keys = ("momentum_buffer",) if optim == "sgd" else (
        "step", "exp_avg", "exp_avg_sq")
    for i, s in want_opt.items():
        assert set(s) == set(keys)
        for k in keys:
            assert torch.equal(got["optimizer"]["state"][i][k], s[k]), (i, k)
    if optim == "adam":
        assert float(want_opt[0]["step"]) == 1.0
    assert got["step"] == 1
    assert got["meta"] == got["meta2"] == {"epoch": 4, "mIoU": 0.375,
                                           "loss": 1.5}


def test_find_adam_in_live_and_restored_states():
    tx = jax_build_optimizer("adam", 1e-3)
    params = {"w": jnp.ones((2, 3))}
    live = tx.init(params)
    restored = serialization.msgpack_restore(serialization.msgpack_serialize(
        serialization.to_state_dict(jax.device_get(live))))
    assert set(restored) == {"0", "1", "2"}     # the chain, as a dict
    for state in (live, restored):
        count, mu, nu = convert._find_adam(state)
        assert int(np.asarray(count)) == 0
        np.testing.assert_array_equal(np.asarray(mu["w"]), np.zeros((2, 3)))
    assert convert._find_adam({"0": {}, "1": {"trace": params}}) is None


# ---------------------------------------------------- the port's own

def _stepped(seed=0):
    """A Fast-SCNN and its adam after one CPU step of a seeded batch."""
    model = build_model("fastscnn", 19, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    model.head.drop.rate = 0.0
    opt = build_optimizer("adam", model.parameters())
    for g in opt.param_groups:
        g["lr"] = 1e-3
    x = torch.randn(2, 3, 64, 128, generator=torch.Generator().manual_seed(1))
    model.train()
    model(x).float().square().mean().backward()
    opt.step()
    return model, opt


def test_port_save_load_bit_for_bit(tmp_path):
    model, opt = _stepped()
    path = ckpt.save_checkpoint(str(tmp_path), 3,
                                TrainState(model, opt, step=17),
                                {"mIoU": 0.5, "loss": 2.0})
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    assert path.endswith("model_3.ckpt") and not os.path.exists(path + ".tmp")
    fresh = build_model("fastscnn", 19, device="cpu")
    fresh_opt = build_optimizer("adam", fresh.parameters())
    state, meta = ckpt.load_checkpoint(path, TrainState(fresh, fresh_opt))
    assert state.step == 17 and meta == {"epoch": 3, "mIoU": 0.5, "loss": 2.0}
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               fresh.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    sa, sb = opt.state_dict(), fresh_opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    # the next step from either is the same
    for m, o in ((model, opt), (fresh, fresh_opt)):
        m.head.drop.rate = 0.0
        m.train()
        o.zero_grad()
        m(torch.ones(2, 3, 64, 128)).float().mean().backward()
        o.step()
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    other = build_model("fastscnn", 19, device="cpu")
    _, meta = ckpt.load_variables(path, other)
    assert meta["epoch"] == 3
    assert all(torch.equal(other.state_dict()[k], v) for k, v in saved.items())


def test_checkpoint_listing_and_params_only(tmp_path):
    model, opt = _stepped()
    for epoch in (2, 10, 1):
        ckpt.save_checkpoint(str(tmp_path), epoch, TrainState(model, opt))
    assert [e for e, _ in ckpt.list_checkpoints(str(tmp_path))] == [1, 2, 10]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("model_10.ckpt")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    ckpt.save_params_only(str(tmp_path / "p.pt"), model)
    other = ckpt.load_params_only(str(tmp_path / "p.pt"),
                                  build_model("fastscnn", 19, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(
        other.state_dict().values(), model.state_dict().values()))
    # the reference's params-only export ({params, stats} msgpack) loads
    variables = convert.to_variables(model.state_dict(), model)
    jax_ckpt.save_params_only(str(tmp_path / "p.msgpack"), variables)
    other = ckpt.load_params_only(str(tmp_path / "p.msgpack"),
                                  build_model("fastscnn", 19, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(
        other.state_dict().values(), model.state_dict().values()))
