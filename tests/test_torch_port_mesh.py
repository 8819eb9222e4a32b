"""The port's device mesh (`iggcn_tpu_torch/parallel/mesh.py`) on gloo CPU
ranks, one torch thread each.

* `fold_mesh` gives the JAX package's shape for k = 1..10 on 8 devices and
  follows its rule on 1, 3, 4 and 5; `make_mesh` refuses to
  oversubscribe; the backend rule; contiguous, ordered, possibly unequal
  shards.
* The data-axis pieces on 2 and 4 ranks against the unsharded batch, in
  float64 (the sharded sums only reorder the unsharded ones):
  `BatchNorm1d` (2-D and 3-D input, running statistics), `weighted_mean`,
  `nll_loss`, `recon_sum`, the consistency term (soft and hard
  clusters), `orthogonal_loss` (both grams) and `sparsity_loss`, at 7
  rows and at 3 (a rank of 4 then holds none); values, input and
  parameter gradients at rtol 1e-6.
* `replicate` broadcasts rank 0's tensors.
* `make_dp_train_step` on 2, 3 and 4 ranks against the port's single step
  with dropout on, and at dropout 0 against the JAX package's
  `make_dp_train_step` on `make_mesh(8)`: loss rtol 1e-5, params atol
  1e-4 (`tests/test_parallel.py`'s pins).
* Mesh serving on 4 CPU devices against one device and the JAX package's
  `batched_forward(mesh=make_mesh(8))` at atol 1e-5, the batch rounded up
  to a multiple of the axis.
* `python -m iggcn_tpu_torch.parallel.dryrun 4`, and the cuDNN pins.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from iggcn_tpu.config import LossWeights as JaxLW
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.parallel import mesh as jax_mesh
from iggcn_tpu.predict import batched_forward as jax_batched_forward
from iggcn_tpu.train.fold_parallel import fold_mesh as jax_fold_mesh
from iggcn_tpu.train.steps import TrainState as JaxState
from iggcn_tpu.train.steps import make_optimizer, make_train_step
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.batching import cohort_batch_arrays, pad_to_batches
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.parallel import dryrun
from iggcn_tpu_torch.parallel import mesh as meshlib
from iggcn_tpu_torch.predict import batched_forward
from iggcn_tpu_torch.tools.convert import load_flax_variables
from iggcn_tpu_torch.utils import platform

from tests import torch_mesh_ranks as ranks

CPU = torch.device("cpu")
WORLD = 4
B = 16
MODEL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8)
NO_DROPOUT = dict(dropout_lin=0.0, dropout_regr=0.0, dropout_go=0.0,
                  dropout_readout=0.0)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1, orth=0.1)
TRAIN = dict(epochs=1, batch_size=B, lr=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("k", range(1, 11))
def test_fold_mesh_shape_is_the_jax_packages(k):
    assert jax.device_count() >= 8, "conftest must provide 8 devices"
    want = jax_fold_mesh(k).devices.shape
    got = meshlib.fold_mesh(k, [CPU] * 8)
    assert got.shape == want and got.axis_names == ("fold", "data")
    assert got.size == want[0] * want[1]


@pytest.mark.parametrize("n,k,shape", [
    (1, 5, (1, 1)), (3, 5, (1, 3)), (3, 4, (2, 1)), (3, 6, (3, 1)),
    (4, 5, (1, 4)), (4, 4, (4, 1)), (4, 6, (3, 1)), (4, 10, (2, 2)),
    (5, 5, (5, 1)), (5, 4, (4, 1)), (8, 3, (3, 2)), (8, 5, (5, 1))])
def test_fold_mesh_rule(n, k, shape):
    mesh = meshlib.fold_mesh(k, [torch.device("cpu", i) for i in range(n)])
    assert mesh.shape == shape
    # the leftover devices idle; the mesh takes the first ones in order
    assert list(mesh.devices) == [torch.device("cpu", i)
                                  for i in range(shape[0] * shape[1])]
    assert [mesh.coords(r) for r in range(mesh.size)] == [
        (i, j) for i in range(shape[0]) for j in range(shape[1])]


def test_make_mesh_refuses_to_oversubscribe():
    with pytest.raises(ValueError, match="requested a 5-device mesh but "
                                         "only 4 device"):
        meshlib.make_mesh(5, [CPU] * 4)
    assert meshlib.make_mesh(devices=[CPU] * 3).shape == (3,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshlib.make_mesh(2)


def test_backend_rule():
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert meshlib.choose_backend([CPU] * 2) == "gloo"
    assert meshlib.choose_backend(cuda) == "nccl"
    assert meshlib.choose_backend(cuda, "gloo") == "gloo"
    with pytest.raises(ValueError, match="more than once"):
        meshlib.choose_backend([cuda[0]] * 2)
    assert meshlib.choose_backend([cuda[0]] * 2, "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL cannot"):
        meshlib.choose_backend([cuda[0]] * 2, "nccl")
    with pytest.raises(ValueError, match="CPU mesh runs on gloo"):
        meshlib.choose_backend([CPU], "nccl")


@pytest.mark.parametrize("rows,size", [(16, 4), (7, 4), (3, 4), (10, 3)])
def test_shards_are_contiguous_ordered_and_cover_the_batch(rows, size):
    bounds = [meshlib.DataAxis(None, j, size).bounds(rows)
              for j in range(size)]
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def _flagship_variables():
    cohort = synthetic_cohort(np.random.default_rng(3), num_subjects=B - 2)
    arrays = cohort_batch_arrays(cohort)
    arrays.pop("sbj_id")
    batch = pad_to_batches(arrays, B)
    cfg = JaxMC(**MODEL, **NO_DROPOUT)
    jmodel = JaxFused(cfg=cfg, topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(11), batch["x"], batch["adj"], batch["snps"]))
    return batch, jmodel, variables


@pytest.fixture(scope="module")
def world_results():
    """Everything the world computes, in one launch of 4 CPU ranks, and
    the JAX package's DP step, run in this process meanwhile."""
    batch, jmodel, variables = _flagship_variables()
    result = {}
    thread = threading.Thread(target=lambda: result.update(
        jax_dp=_jax_dp(batch, jmodel, variables)), daemon=True)
    thread.start()
    jobs = [("pieces_on", (2,)), ("pieces_on", (4,))]
    for d in (2, 3, 4):
        jobs.append(("dp_step", (d, variables, batch, MODEL, TRAIN, LOSS)))
    for d in (2, 4):
        jobs.append(("dp_step", (d, variables, batch,
                                 {**MODEL, **NO_DROPOUT}, TRAIN, LOSS)))
    jobs.append(("replicated", ()))
    out = meshlib.launch(ranks.run_all, (jobs,),
                         meshlib.make_mesh(devices=[CPU] * WORLD), threads=1)
    thread.join(timeout=600)
    assert "jax_dp" in result, "the JAX package's DP step did not finish"
    return {"pieces": {2: out[0], 4: out[1]},
            "dp": dict(zip((2, 3, 4), out[2:5])),
            "dp_no_dropout": dict(zip((2, 4), out[5:7])),
            "replicated": out[7], "jax_dp": result["jax_dp"],
            "setup": (batch, jmodel, variables)}


def test_replicate_broadcasts_rank_zeros_tensors(world_results):
    assert world_results["replicated"] == [[0.0, 0.0, 0.0]] * WORLD


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("rows", ranks.PIECE_ROWS)
@pytest.mark.parametrize("name", ranks.PIECES)
def test_data_axis_piece_equals_the_unsharded_batch(world_results, d, rows,
                                                    name):
    got = world_results["pieces"][d][name, rows]
    want = ranks.piece_result(name, ranks.piece_inputs(rows))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert got[1].keys() == want[1].keys() and want[1]
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-6,
                                   atol=1e-12, err_msg=k)
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)
    for (gm, gv), (wm, wv) in zip(got[3], want[3]):
        np.testing.assert_allclose(gm, wm, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-12)


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _assert_vars_close(got, want):
    got, want = dict(_tree_items(got)), dict(_tree_items(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_dp_step_equals_the_single_step(world_results, d):
    batch, _, variables = world_results["setup"]
    loss, model = ranks.single_step(variables, batch, MODEL, TRAIN, LOSS)
    from iggcn_tpu_torch.tools.convert import to_flax_variables
    got_loss, got_vars = world_results["dp"][d]
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    _assert_vars_close(got_vars, to_flax_variables(model))


def _jax_dp(batch, jmodel, variables):
    tcfg = JaxTC(**TRAIN, loss=JaxLW(**LOSS))
    optimizer = make_optimizer(tcfg, 1)
    step = make_train_step(jmodel, JaxMC(**MODEL, **NO_DROPOUT), tcfg,
                           optimizer)
    mesh = jax_mesh.make_mesh(8)
    state = JaxState.create(variables, optimizer, steps_per_epoch=1)
    new, loss = jax_mesh.make_dp_train_step(step, mesh)(
        jax_mesh.replicate_tree(mesh, state),
        jax_mesh.shard_batch_tree(mesh, batch), jax.random.PRNGKey(0))
    return float(loss), jax.device_get({"params": new.params,
                                        "batch_stats": new.batch_stats})


@pytest.mark.parametrize("d", [2, 4])
def test_dp_step_equals_the_jax_packages_dp_step(world_results, d):
    got_loss, got_vars = world_results["dp_no_dropout"][d]
    want_loss, want_vars = world_results["jax_dp"]
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    got, want = dict(_tree_items(got_vars)), dict(_tree_items(want_vars))
    # The two leaves whose true gradient is zero in train mode (see
    # `tests/test_torch_port_trajectory.py`): the key slice of the
    # attention's in-projection bias and the last decoder bias before the
    # train-mode batch norm bn_b_d. Adam's first step turns their float
    # noise into steps of up to ~lr of either sign on either side, and
    # bn_b_d's running mean sees that bias through conc_d.
    mcfg = ModelConfig(**MODEL)
    walk = 2 * 1.02 * TRAIN["lr"]
    e = mcfg.jk_dim
    name, key = "params/mha_in_proj_bias", slice(e, 2 * e)
    bias = f"params/go_network/g_b_d_{mcfg.go_n_l - 1}/bias"
    stat = "batch_stats/go_network/bn_b_d/mean"
    assert np.abs(got[name][key] - want[name][key]).max() <= walk
    got[name][key] = want[name][key]
    bias_walk = np.abs(got[bias] - want[bias]).max()
    assert bias_walk <= walk
    conc_d = np.abs(want["params/go_network/conc_d/kernel"]).sum()
    assert np.abs(got[stat] - want[stat]).max() <= bias_walk * conc_d + 1e-4
    assert got.keys() == want.keys()
    for k in want:
        if k not in (bias, stat):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_mesh_serving_equals_one_device_and_the_jax_package(monkeypatch):
    batch, jmodel, variables = _flagship_variables()
    cohort = synthetic_cohort(np.random.default_rng(8), num_subjects=10)
    model = FusedSGCN(ModelConfig(**MODEL, **NO_DROPOUT),
                      synthetic_topology(np.random.default_rng(0)))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    model.eval()
    args = (cohort.x, cohort.adj, cohort.snps)
    one = batched_forward(model, *args, batch_size=10)
    rows = []
    forward = FusedSGCN.forward

    def spy(self, x, *a, **kw):
        rows.append(x.shape[0])
        return forward(self, x, *a, **kw)

    monkeypatch.setattr(FusedSGCN, "forward", spy)
    mesh = meshlib.make_mesh(devices=[CPU] * 4)
    par = batched_forward(model, *args, batch_size=10, mesh=mesh)
    # 10 rounded up to 12: three rows on each of the 4 positions
    assert rows == [3, 3, 3, 3]
    jax_out = jax_batched_forward(jmodel, variables["params"],
                                  variables["batch_stats"], *args,
                                  batch_size=10,
                                  mesh=jax_mesh.make_mesh(8))
    assert par.keys() == one.keys() == jax_out.keys()
    for k in one:
        assert par[k].shape == one[k].shape
        np.testing.assert_allclose(par[k], one[k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(par[k], jax_out[k], atol=1e-5, err_msg=k)


def test_dryrun_on_four_ranks(capsys):
    assert dryrun.main(["4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split("(")[0] for line in out] == [
        "dp_step", "fold_parallel", "fold_parallel_padded",
        "permut_seed_parallel", "cv_seed_parallel", "dp_serving"]
    assert all(" ok" in line for line in out)
    assert "mesh fold=1 x data=4" in out[2]


def test_cudnn_is_pinned_to_its_deterministic_algorithms():
    assert platform is not None
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert torch.backends.cudnn.allow_tf32 is False
