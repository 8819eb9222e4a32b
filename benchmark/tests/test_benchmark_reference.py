"""The plain reference against the port at a tiny size on the CPU: the
eval-mode forward of both configurations' shapes, and a training cell's
comparison as a run makes it (its first steps, running statistics, first
evaluation and best-epoch keep), read against its limits."""
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import data, registry
from benchmark.reference import fused_sgcn as ref


@pytest.mark.parametrize("config", ["flagship-l2h16", "multifusion-l3h10"])
def test_eval_forward_matches_the_port(config):
    from iggcn_tpu_torch.config import ModelConfig
    from iggcn_tpu_torch.data.go_graph import GoTopology
    from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
    cfg = registry.config(config)
    m = cfg["model"]
    cpu = torch.device("cpu")
    dag = data.go_dag(3, [24, 16, 10, 6, 1], m["num_snps"])
    co = data.cohort(3, 40, m["rois"], m["feat_dim"], m["num_snps"],
                     m["num_classes"], 3, cpu)
    n = int(dag["pool"].sum())
    topo = GoTopology(dag["adj_child_parent"].astype(np.float64),
                      dag["go_snps"].astype(np.float64),
                      [int(p) for p in dag["pool"]], 4, np.zeros(n),
                      [str(i) for i in range(n)], [[] for _ in range(n)])
    model = FusedSGCN(ModelConfig(**dict(m, go_f_dim=tuple(m["go_f_dim"]))),
                      topo, device=cpu)
    weights = data.weight_sets({k: v.shape for k, v in
                                model.state_dict().items()}, 1, 3, cpu)[0]
    model.load_state_dict(weights)
    model.eval()
    x, adj, snps = (torch.as_tensor(co[k]) for k in ("x", "adj", "snps"))
    with torch.no_grad():
        got = model(x, adj, snps)
        got_m = model(x, adj, snps, is_explain=True)
    rdag = ref.GoDag(dag["adj_child_parent"], dag["go_snps"], dag["pool"],
                     m["go_n_l"], cpu)
    drop = ref.Dropout(None)
    with torch.no_grad():
        want = ref.forward(weights, m, rdag, x, adj, snps, drop)
        want_m = ref.forward(weights, m, rdag, x, adj, snps, drop,
                             explain=True)
    for g, w in ((got, want), (got_m, want_m)):
        for key in ("log_probs", "our_reg", "snps_hat", "out_z"):
            np.testing.assert_allclose(getattr(g, key).numpy(),
                                       w[key].numpy(), rtol=1e-4, atol=1e-5)


def test_training_cell_first_steps_within_limits(small):
    result, _ = run.run_cell("train.flagship.permut60", 11, 0.5, False,
                             torch.device("cpu"), overrides=small,
                             start=time.perf_counter())
    assert result["correct"], result["checks"]
    # the CPU's own rounding: far inside the card's limits
    assert result["checks"]["first_loss_gap"]["value"] < 1e-5
    assert result["checks"]["grad_gap"]["value"] < 1e-3
    assert result["checks"]["stats_gap"]["value"] < 1e-3
    assert result["checks"]["eval_loss_gap"]["value"] < 1e-5
    assert result["checks"]["eval_out_gap"]["value"] < 1e-4
    assert result["checks"]["rows_unknown"]["value"] == 0
    assert result["checks"]["best_mismatch"]["value"] == 0


def test_clinical_targets_are_the_loaders():
    from iggcn_tpu_torch.data.adni import CLINICAL_SELECT_INDEX, MinMaxScaler
    assert tuple(CLINICAL_SELECT_INDEX) == data.CLINICAL_COLUMNS
    demo = np.random.default_rng(0).random((50, 9)).astype(np.float32)
    want = MinMaxScaler().fit(demo).transform(demo)[:, list(
        data.CLINICAL_COLUMNS)]
    np.testing.assert_allclose(ref.clinical_targets(demo,
                                                    data.CLINICAL_COLUMNS),
                               want, rtol=1e-6, atol=1e-7)
