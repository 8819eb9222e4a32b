"""Six optimiser steps of the port (`iggcn_tpu_torch/train/steps.py`)
against the JAX package's `make_train_step`, from the same flax variables
on the same padded batch (two rows of weight 0): the 7-term objective over
the plain and the masked pass, coupled-L2 Adam, the StepLR crossing two
decay boundaries within the six steps (one step per epoch, decay every
two), and the batch norms' running statistics moving pass after pass.
Dropout is 0 on both sides (the streams cannot cross frameworks). The
JAX side runs with `dual_pass_vmap` on and off. Per-step losses rtol 2e-4
(the pin of `tests/test_trajectory_parity.py`), final params and
batch_stats atol 1e-4, except two leaves whose true gradient is zero and
one running mean that sees one of them (see the test)."""
import jax
import numpy as np
import pytest
import torch

from iggcn_tpu.config import LossWeights as JaxLW
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.train.steps import TrainState as JaxState
from iggcn_tpu.train.steps import make_optimizer, make_train_step
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.batching import cohort_batch_arrays, pad_to_batches
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.tools.convert import load_flax_variables, to_flax_variables
from iggcn_tpu_torch.train import steps

STEPS = 6
B = 12
MODEL = dict(num_layers=2, hidden=16, hidden_linear=16, l_dim=8,
             dropout_lin=0.0, dropout_regr=0.0, dropout_go=0.0,
             dropout_readout=0.0)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1, orth=0.1)
TRAIN = dict(epochs=STEPS, batch_size=B, lr=3e-3, weight_decay=1e-2,
             lr_decay_factor=0.5, lr_decay_step_size=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    cohort = synthetic_cohort(np.random.default_rng(3), num_subjects=B - 2)
    arrays = cohort_batch_arrays(cohort)
    arrays.pop("sbj_id")
    batch = pad_to_batches(arrays, B)
    jmodel = JaxFused(cfg=JaxMC(**MODEL),
                      topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(11), batch["x"], batch["adj"], batch["snps"]))
    return batch, jmodel, variables


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("dual_pass_vmap", [True, False])
def test_six_steps_match_make_train_step(setup, dual_pass_vmap):
    batch, jmodel, variables = setup
    jtcfg = JaxTC(**TRAIN, dual_pass_vmap=dual_pass_vmap, loss=JaxLW(**LOSS))
    optimizer = make_optimizer(jtcfg)
    step_fn = jax.jit(make_train_step(jmodel, JaxMC(**MODEL), jtcfg,
                                      optimizer))
    state = JaxState.create(variables, optimizer, steps_per_epoch=1)
    want = []
    rng = jax.random.PRNGKey(0)    # feeds rate-0 dropout only
    for _ in range(STEPS):
        rng, r = jax.random.split(rng)
        state, loss_sum = step_fn(state, batch, r)
        want.append(float(loss_sum))
    want_vars = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})

    mcfg = ModelConfig(**MODEL)
    tcfg = TrainConfig(**TRAIN, loss=LossWeights(**LOSS))
    model = FusedSGCN(mcfg, synthetic_topology(np.random.default_rng(0)))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    pstate = steps.TrainState(model, tcfg, steps_per_epoch=1)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = [float(steps.train_step(pstate, tbatch, mcfg, tcfg, None))
           for _ in range(STEPS)]
    assert pstate.step == STEPS
    assert [steps.lr_at_step(tcfg, s, 1) for s in range(STEPS)] == [
        3e-3, 3e-3, 1.5e-3, 1.5e-3, 7.5e-4, 7.5e-4]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    got_vars = dict(_tree_items(to_flax_variables(model)))
    want_items = dict(_tree_items(want_vars))
    assert got_vars.keys() == want_items.keys()
    # Two leaves have a true gradient of zero in train mode, so Adam turns
    # float noise into +-lr steps of arbitrary sign on both sides (the JAX
    # package's own trajectory test exempts them the same way): the key
    # slice of the attention's in-projection bias (a constant on every key
    # shifts no softmax) and the last decoder norm's bias (bn_b_d, a train-
    # mode batch norm over each node, subtracts it again). Two such walks
    # differ by at most twice Adam's bound on a walk (each step moves a
    # parameter by at most ~1.02 lr over the first six steps at
    # b1=0.9, b2=0.999), and bn_b_d's running mean, which sees that bias
    # through conc_d, by the bias's difference carried through conc_d.
    walk = 2 * 1.02 * sum(steps.lr_at_step(tcfg, s, 1) for s in range(STEPS))
    e = mcfg.jk_dim
    key = slice(e, 2 * e)
    bias = f"params/go_network/g_b_d_{mcfg.go_n_l - 1}/bias"
    stat = "batch_stats/go_network/bn_b_d/mean"
    name = "params/mha_in_proj_bias"
    assert np.abs(got_vars[name][key] - want_items[name][key]).max() <= walk
    got_vars[name][key] = want_items[name][key]
    bias_walk = np.abs(got_vars[bias] - want_items[bias]).max()
    assert bias_walk <= walk
    conc_d = np.abs(want_items["params/go_network/conc_d/kernel"]).sum()
    assert (np.abs(got_vars[stat] - want_items[stat]).max()
            <= bias_walk * conc_d + 1e-4)
    for k, w in want_items.items():
        if k not in (bias, stat):
            np.testing.assert_allclose(got_vars[k], w, rtol=0, atol=1e-4,
                                       err_msg=k)
    # the trajectory moved: the comparison is not of untouched weights
    init = dict(_tree_items(variables))
    assert max(float(np.abs(want_items[k] - init[k]).max())
               for k in init) > 1e-3


def test_eval_step_reports_both_passes_loss_and_outputs(setup):
    batch, _, variables = setup
    mcfg = ModelConfig(**MODEL)
    tcfg = TrainConfig(**TRAIN, loss=LossWeights(**LOSS))
    model = FusedSGCN(mcfg, synthetic_topology(np.random.default_rng(0)))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = steps.eval_step(model, tbatch, mcfg, tcfg)
    assert not model.training
    loss, _ = steps.fused_objective(model, tbatch, mcfg, tcfg, train=False)
    torch.testing.assert_close(out["loss_sum"], loss * (B - 2))
    assert out["log_probs"].shape == (B, 2) and out["our_reg"].shape == (B, 3)
    torch.testing.assert_close(out["pred"], out["log_probs"].argmax(-1))
