"""The data-parallel world's helpers (``esn_tpu_torch.parallel.mesh``) on
the CPU under gloo: the batch helpers against the reference's
(``esn_tpu/parallel/mesh.py``), the collectives' values and gradients at
2 and 3 ranks, BatchNorm's global moments at 2 and 4 ranks against one
process in f64 (within 1e-12) and against the reference's BatchNorm on a
4-device JAX data mesh in f32, and the launcher's handling of a rank that
raises or hangs.

Each spawn (``parallel.launch.run_ranks``) rendezvouses through a
``file://`` path in a temporary directory, runs one torch thread a rank
and joins within its own limit, killing its ranks on failure.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel as TP
from esn_tpu import nn as jnn
from esn_tpu.nn.layers import BatchNorm as JaxBatchNorm
from esn_tpu.parallel import mesh as jmesh
from esn_tpu_torch.parallel import launch, mesh
from esn_tpu_torch.train import evaluation as EV

# f64 BN at W ranks against one process: the sums are split over the
# ranks, so only rounding of order 1e-16 may differ
BN_F64 = 1e-12
# f32 BN at 4 ranks against the reference's on a 4-device mesh: both in
# f32, summed in other orders (readings ~1e-7); gradients of the affine
# sum 64 values a channel
BN_F32 = dict(atol=2e-5, rtol=2e-5)
LIMIT = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's own torch work (each rank runs
    one too): the quick tier runs six workers on a few cores, and torch's
    OpenMP teams, one a worker, spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, n=5):
    return {"image": rng.rand(n, 4, 6, 3).astype(np.float32),
            "label": rng.randint(0, 19, (n, 4, 6)).astype(np.int32)}


@pytest.mark.parametrize("n,target", [(5, 5), (5, 8), (3, 4)])
def test_pad_batch_to_matches_reference(n, target):
    batch = _batch(np.random.RandomState(n), n)
    got, real = mesh.pad_batch_to(batch, target)
    want, want_real = jmesh.pad_batch_to(batch, target)
    assert real == want_real == n
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])
    assert EV.pad_batch_to is mesh.pad_batch_to


@pytest.mark.parametrize("n,ranks", [(5, 2), (6, 4), (8, 4), (3, 1)])
def test_pad_batch_to_devices_matches_reference(n, ranks):
    batch = _batch(np.random.RandomState(n), n)
    got, real = mesh.pad_batch_to_devices(batch, ranks)
    want, want_real = jmesh.pad_batch_to_devices(batch, ranks)
    assert real == want_real == n
    assert got["image"].shape[0] % ranks == 0
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])
    assert EV.eval_batch_size(n, ranks) == got["image"].shape[0]


@pytest.mark.parametrize("ranks", [2, 4])
def test_rank_rows_are_the_reference_shards(ranks):
    """Rank r's rows are the rows ``shard_batch`` puts on device r of a
    data mesh."""
    batch = _batch(np.random.RandomState(0), 8)
    sharded = jmesh.shard_batch(batch, jmesh.make_mesh(jax.devices()[:ranks]))
    for r in range(ranks):
        w = mesh.World(r, ranks, r, "gloo", torch.device("cpu"))
        mine = mesh.shard_batch(batch, w=w)
        shard = next(s for s in sharded["image"].addressable_shards
                     if s.device == jax.devices()[r])
        np.testing.assert_array_equal(mine["image"], np.asarray(shard.data))
        np.testing.assert_array_equal(mine["label"],
                                      batch["label"][mesh.rank_rows(8, w=w)])


def test_rank_rows_under_accumulation_and_their_errors():
    """Under grad_accum k rank r holds its part of each microbatch; a
    batch that k x W does not divide raises."""
    w = mesh.World(1, 2, 1, "gloo", torch.device("cpu"))
    np.testing.assert_array_equal(mesh.rank_rows(8, 2, w), [2, 3, 6, 7])
    np.testing.assert_array_equal(mesh.rank_rows(8, 1, w), [4, 5, 6, 7])
    tensors = {"x": torch.arange(8), "names": list("abcdefgh"), "k": 3}
    mine = mesh.shard_batch(tensors, 2, w)
    assert mine["x"].tolist() == [2, 3, 6, 7]
    assert mine["names"] == ["c", "d", "g", "h"] and mine["k"] == 3
    with pytest.raises(ValueError, match="cannot shrink"):
        mesh.rank_rows(6, 2, w)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rank_rows(5, 1, w)


def test_no_group_is_the_identity():
    assert not mesh.active()
    w = mesh.world()
    assert (w.rank, w.size, w.backend) == (0, 1, None)
    x = torch.randn(3, requires_grad=True)
    assert mesh.all_sum(x) is x and mesh.global_sum(x) is x
    assert mesh.gather_rows(x) is x
    batch = {"image": np.zeros((4, 2))}
    assert mesh.shard_batch(batch, 2) is batch
    loss = torch.tensor(1.5)
    assert mesh.all_reduce_grads([x], loss) == (loss,)
    assert mesh.init_data_parallel("cpu") == w      # WORLD_SIZE unset
    assert mesh.rank_devices() == ["cpu"]


def test_backend_rule(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh.choose_backend(cpu, 1) == mesh.choose_backend(cpu, 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card = torch.device("cuda", 0)
    assert mesh.choose_backend(card, 1) == "nccl"
    assert mesh.choose_backend(card, 2) == "gloo"    # two ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.choose_backend(card, 4) == "nccl"
    with pytest.raises(TypeError, match="f32, f64 or int64"):
        mesh._all_reduce_(torch.zeros(2, dtype=torch.bfloat16))


@pytest.mark.parametrize("ranks", [2, 3])
def test_global_sum_and_gather_rows_value_and_gradient(ranks):
    out = launch.run_ranks(TP.helpers_case, ranks, 11, timeout=LIMIT)
    rng = np.random.RandomState(11)
    xs, cs = rng.randn(ranks, 5), rng.randn(ranks, 5)
    gx, gc = rng.randn(ranks, 2, 3), rng.randn(ranks, 2 * ranks, 3)
    for r, o in enumerate(out):
        assert (o["rank"], o["size"], o["backend"]) == (r, ranks, "gloo")
        assert o["devices"] == ["cpu"] * ranks
        # y = sum_r x_r on every rank; dL/dx_r = sum of the ranks' cotangents
        np.testing.assert_allclose(o["y"], xs.sum(0), rtol=1e-15)
        np.testing.assert_allclose(o["dx"], cs.sum(0), rtol=1e-15)
        # the gathered rows exactly; dL/dx_r = this rank's rows of the
        # summed cotangents
        np.testing.assert_array_equal(o["g"], gx.reshape(-1, 3))
        np.testing.assert_allclose(o["dg"], gc.sum(0)[2 * r:2 * r + 2],
                                   rtol=1e-15)
        np.testing.assert_array_equal(
            o["counts"], np.arange(3) * ranks + sum(range(ranks)))


def _bn_inputs(dtype=np.float64):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 3, 5, 6) * 2 + 1).astype(dtype)
    cot = rng.randn(4, 3, 5, 6).astype(dtype)
    params = {"weight": rng.uniform(0.5, 1.5, 3), "bias": rng.randn(3) * 0.1,
              "running_mean": rng.randn(3) * 0.5,
              "running_var": rng.uniform(0.5, 1.5, 3)}
    return x, cot, {k: v.astype(dtype) for k, v in params.items()}


@pytest.mark.parametrize("ranks", [2, 4])
def test_batchnorm_matches_one_process_f64(ranks):
    x, cot, params = _bn_inputs()
    one = TP.bn_case(x, cot, params)
    out = launch.run_ranks(TP.bn_case, ranks, x, cot, params, timeout=LIMIT)
    rows = 4 // ranks
    for r, o in enumerate(out):
        sl = slice(r * rows, (r + 1) * rows)
        for k in ("y", "dx"):
            np.testing.assert_allclose(o[k], one[k][sl], rtol=0, atol=BN_F64)
        for k in ("dweight", "dbias", "running_mean", "running_var"):
            np.testing.assert_allclose(o[k], one[k], rtol=0, atol=BN_F64)
    launch.assert_ranks_equal([{k: o[k] for k in (
        "dweight", "dbias", "running_mean", "running_var")} for o in out])


def test_batchnorm_matches_reference_on_a_jax_data_mesh():
    """4 ranks in f32 against the reference's BatchNorm with the batch
    sharded over a 4-device mesh (its global-view moments and autodiff):
    output, gradients of x and of the affine, running statistics."""
    x, cot, params = _bn_inputs(np.float32)
    out = launch.run_ranks(TP.bn_case, 4, x, cot, params, "float32",
                           timeout=LIMIT)
    jm = jmesh.make_mesh(jax.devices()[:4])
    xh, ch = (np.ascontiguousarray(a.transpose(0, 2, 3, 1)) for a in (x, cot))
    variables = {"params": {"scale": params["weight"], "bias": params["bias"]},
                 "stats": {"mean": params["running_mean"],
                           "var": params["running_var"]}}
    module = JaxBatchNorm(3)

    def loss(p, xx):
        y, new = jnn.apply(module, {"params": p, "stats": variables["stats"]},
                           xx, train=True, mutable=True)
        return jnp.sum(y * ch), (y, new["stats"])

    sharded = jmesh.shard_batch({"x": xh}, jm)["x"]
    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jmesh.replicate(variables["params"], jm), sharded)
    y, gx = (np.asarray(a).transpose(0, 3, 1, 2) for a in (y, gx))
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["y"], y[r:r + 1], **BN_F32)
        np.testing.assert_allclose(o["dx"], gx[r:r + 1], **BN_F32)
        np.testing.assert_allclose(o["dweight"], gp["scale"], **BN_F32)
        np.testing.assert_allclose(o["dbias"], gp["bias"], **BN_F32)
        np.testing.assert_allclose(o["running_mean"], stats["mean"], **BN_F32)
        np.testing.assert_allclose(o["running_var"], stats["var"], **BN_F32)


def test_a_rank_that_raises_or_hangs_fails_the_launch():
    with pytest.raises(launch.RankFailure, match="rank 1 fails on purpose"):
        launch.run_ranks(TP.raise_case, 2, timeout=LIMIT)
    with pytest.raises(launch.RankFailure, match="did not finish within"):
        launch.run_ranks(TP.hang_case, 2, timeout=8.0)
