"""No path that the port trains or serves accumulates with atomics.

On CUDA, the ops of `ATOMIC_OPS` add into their output with float
atomics (or count with integer ones) in an order that changes from launch
to launch, so a run that uses them does not repeat bit for bit. The JAX
package's runs repeat, and the port's must too, without a global switch:
its own formulation has to keep them off every path.

Each path below runs here on the CPU under `Recorder`, a
`TorchDispatchMode` that sees every aten op the forward, the backward and
the optimiser step dispatch (the same ops reach the CUDA kernels on the
card). A path fails on any op of `ATOMIC_OPS`, unless the op is in
`ALLOWED` and the recorded call writes no output index twice (then the
order of the adds cannot matter: each destination receives one value).

The paths: one forward + backward + Adam step of each fused family the
CLI trains (and the flagship under `--isMultiFusion`) at batch 32 and 64,
so that the GO network's dense and edge attention are both walked; both
SNP-only families at batch 32 and 64; every zoo name; the batched
fold-parallel step (`steps.batched_train_step`, one program for all
folds) and a seed batch (3 seeds x 3 folds in one program); and the
served forward of each bundle class at batch 256, fp32 and bf16."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data import tu
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.batching import cohort_batch_arrays, pad_to_batches
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.data.nested import create_nested_dataset
from iggcn_tpu_torch.models.baselines import MLPModel
from iggcn_tpu_torch.models.clusterlabel import ClusterLabelSGCN
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.models.guide import GuideImgSnp
from iggcn_tpu_torch.predict import batched_forward, batched_forward_snps
from iggcn_tpu_torch.train import snps_trainer, steps
from iggcn_tpu_torch.train.cv import init_fold_model
from iggcn_tpu_torch.train.generic_cv import (build_generic_steps,
                                              init_generic_model,
                                              make_generic_optimizer)

# aten op (without the in-place underscore) -> why CUDA makes it a draw
ATOMIC_OPS = {
    "index_add": "adds source slices into self at `index` with float "
                 "atomicAdd: a repeated index sums in launch order "
                 "(`index_select`'s backward is one)",
    "index_put": "with accumulate=True (`t[idx] += v`, and the backward "
                 "of advanced indexing `t[idx]`) sums repeated indices in "
                 "an order the launch picks",
    "_index_put_impl": "the kernel behind `index_put_`; the same with "
                       "accumulate=True",
    "_unsafe_index_put": "`index_put` without bounds checks; the same with "
                         "accumulate=True",
    "scatter_add": "adds src into self at `index` with atomicAdd (the "
                   "backward of `gather` and `take_along_dim`)",
    "scatter_reduce": "reduces src into self at `index` with atomics",
    "index_reduce": "reduces source slices into self at `index` with "
                    "atomics",
    "embedding_dense_backward": "sums the gradient rows of repeated "
                                "embedding indices with atomics",
    "put": "with accumulate=True adds into the flattened self with "
           "atomicAdd",
    "bincount": "counts (or sums weights) per bin with atomics",
    "histc": "counts per bin with atomics",
}
# only with this positional argument (`accumulate`) true
ACCUMULATE_ARG = {"index_put": 3, "_index_put_impl": 3,
                  "_unsafe_index_put": 3, "put": 3}


def _scatter_writes_once(args, kwargs) -> bool:
    """scatter_add(self, dim, index, src): each element of `index` names
    the destination of one src element (its own coordinates, with `dim`
    replaced by the index value); True when no two name the same one."""
    self, dim, index = args[0], args[1], args[2]
    idx = index.detach().cpu().numpy()
    coords = list(np.indices(idx.shape))
    coords[dim % idx.ndim] = idx
    flat = np.ravel_multi_index(coords, tuple(self.shape))
    return np.unique(flat).size == flat.size


# op -> (where the port calls it, the check every call must pass)
ALLOWED = {
    "scatter_add": ("the backward of `gather`: `train/losses.py:nll_loss` "
                    "(one label per row), `ops/pool.py:sort_pool` (k "
                    "distinct nodes per graph)", _scatter_writes_once),
}


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched under it; `flagged` lists the
    calls of `ATOMIC_OPS` that `ALLOWED` does not clear."""

    def __init__(self):
        super().__init__()
        self.ops = set()
        self.flagged = []
        self.allowed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__.rstrip("_")
        self.ops.add(name)
        if name in ATOMIC_OPS and self._accumulates(name, args, kwargs):
            allowed = ALLOWED.get(name)
            if allowed is not None and allowed[1](args, kwargs):
                self.allowed += 1
            else:
                self.flagged.append(str(func))
        return func(*args, **kwargs)

    @staticmethod
    def _accumulates(name, args, kwargs) -> bool:
        pos = ACCUMULATE_ARG.get(name)
        if pos is None:
            return True
        if "accumulate" in kwargs:
            return bool(kwargs["accumulate"])
        return len(args) > pos and bool(args[pos])


def recorded(fn) -> Recorder:
    rec = Recorder()
    with rec:
        fn()
    return rec


def assert_no_atomics(rec: Recorder) -> None:
    assert rec.ops & {"mm", "bmm", "addmm", "matmul"}, "nothing recorded"
    assert not rec.flagged, rec.flagged


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CPU = torch.device("cpu")
SMALL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8)
LOSS = LossWeights(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1,
                   orth=0.1)
MULTI = dict(rois=270, feat_dim=1, is_multi_fusion=True)
# the CLI's fused names (and the flagship's multi-fusion variant) ->
# (model kind, ModelConfig fields beyond SMALL)
FUSED = {**{name: (kind, {"use_gat": name == "SGCN_GAT"})
            for name, kind in port_main.FUSION_MODELS.items()},
         "SGCN_GCN_IMGSNP --isMultiFusion": ("sgcn_imgsnp", MULTI)}
BATCHES = (32, 64)


@pytest.fixture(scope="module")
def topo():
    return synthetic_topology(np.random.default_rng(0))


@pytest.fixture(scope="module")
def cohorts():
    """Padded arrays of 60 subjects per ROI count (batch 64 holds 4
    padding rows, batch 32 none in its first batch)."""
    out = {}
    for rois, feat in ((90, 3), (270, 1)):
        c = synthetic_cohort(np.random.default_rng(3), num_subjects=60,
                             rois=rois, feat_dim=feat)
        arrays = cohort_batch_arrays(c)
        arrays.pop("sbj_id")
        out[rois] = arrays
    return out


def _fused_batch(arrays, b):
    return {k: torch.as_tensor(v[:b]) for k, v in
            pad_to_batches(arrays, b).items()}


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_train_step_has_no_atomics(topo, cohorts, name, b):
    kind, extra = FUSED[name]
    mcfg = ModelConfig(**SMALL, **extra)
    tcfg = TrainConfig(batch_size=b, loss=LOSS)
    model, gen = init_fold_model(mcfg, topo, 1, 0, CPU, kind=kind)
    state = steps.TrainState(model, tcfg, 1, kind)
    batch = _fused_batch(cohorts[mcfg.rois], b)
    rec = recorded(lambda: steps.train_step(state, batch, mcfg, tcfg, gen))
    assert_no_atomics(rec)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("kind", ["go", "mlp"])
def test_snps_train_step_has_no_atomics(topo, cohorts, kind, b):
    model, gen = snps_trainer.init_snps_model(kind, topo, 54, 1, 0, CPU)
    opt = snps_trainer.make_snps_optimizer(model)
    arrays = pad_to_batches(cohorts[90], b)
    x = torch.as_tensor(arrays["snps"][:b])
    y = torch.as_tensor(arrays["y"][:b]).float()
    w = torch.as_tensor(arrays["w"][:b])
    rec = recorded(lambda: snps_trainer.snps_train_step(
        model, opt, x, y, w, 1e-3, 1e-4, gen))
    assert_no_atomics(rec)


@pytest.fixture(scope="module")
def zoo_data():
    """The CLI's zoo datasets at a small size: the ADNI-shaped cohort as a
    graph list (the CLI's default `--data ADNI`) and its h=2 nested
    dataset with hop labels (the CLI's default `--node_label hop`)."""
    c = synthetic_cohort(np.random.default_rng(4), num_subjects=36, rois=30)
    flat = tu.from_graph_list(list(c.x), list(c.adj), c.y.astype(np.int64))
    small = tu.synthetic_tu_dataset(np.random.default_rng(5), num_graphs=36)
    return flat, create_nested_dataset(small, h=2, node_label="hop")


@pytest.mark.parametrize("name", port_main.ZOO_MODELS)
def test_zoo_train_step_has_no_atomics(zoo_data, name):
    flat, nested = zoo_data
    data = nested if name.startswith("Nested") else flat
    template, wiring = port_main.build_zoo_model(name, 2, 8, data)
    model, gen = init_generic_model(template, 1, 0, CPU)
    train_step, _ = build_generic_steps(
        model, make_generic_optimizer(model),
        needs_mask=wiring.get("needs_mask", True),
        needs_assign=wiring.get("needs_assign", False),
        adj_only=wiring.get("adj_only", False),
        aux_loss=wiring.get("aux_loss", False),
        takes_weight=wiring.get("takes_weight", False))
    keys = [k for k in ("x", "adj", "mask", "assign", "y", "z", "rd")
            if getattr(data, k, None) is not None]
    batch = {k: torch.as_tensor(np.ascontiguousarray(getattr(data, k)[:32]))
             for k in keys}
    batch["w"] = torch.ones(32)
    if name.startswith("Nested"):
        assert "z" in batch         # the hop labels' embedding is walked
    rec = recorded(lambda: train_step(batch, gen, 1e-3))
    assert_no_atomics(rec)


@pytest.mark.parametrize("folds", [3, 9], ids=["fold_parallel",
                                               "seed_batch_3x3"])
def test_batched_train_step_has_no_atomics(topo, cohorts, folds):
    kind, mcfg = "sgcn_imgsnp", ModelConfig(**SMALL)
    tcfg = TrainConfig(batch_size=32, loss=LOSS)
    inits = [init_fold_model(mcfg, topo, 1 + f // 3, f % 3, CPU, kind=kind)
             for f in range(folds)]
    state = steps.StackedState([m for m, _ in inits], tcfg, [1] * folds,
                               kind)
    one = _fused_batch(cohorts[90], 32)
    batch = {k: torch.stack([v] * folds) for k, v in one.items()}
    shapes = steps.record_noise_shapes(state, batch, mcfg, tcfg)
    noise = steps.draw_fold_noise(shapes, [g for _, g in inits], CPU)
    rec = recorded(lambda: steps.batched_train_step(
        state, batch, mcfg, tcfg, noise, np.ones(folds, bool)))
    assert_no_atomics(rec)


SERVED = {"FusedSGCN": FusedSGCN, "ClusterLabelSGCN": ClusterLabelSGCN,
          "GuideImgSnp": GuideImgSnp, "GeneOntologyNetwork": None,
          "MLPModel": None}


@pytest.fixture(scope="module")
def served_arrays():
    c = synthetic_cohort(np.random.default_rng(6), num_subjects=260,
                         diffuse=False)
    return {k: getattr(c, k).astype(np.float32) for k in ("x", "adj", "snps")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("cls", sorted(SERVED))
def test_served_forward_at_batch_256_has_no_atomics(topo, served_arrays, cls,
                                                    dtype):
    g = torch.Generator().manual_seed(2)
    if cls == "GeneOntologyNetwork":
        model = GeneOntologyNetwork(topo, classifier=True, generator=g)
    elif cls == "MLPModel":
        model = MLPModel(54, generator=g)
    else:
        model = SERVED[cls](ModelConfig(**SMALL), topo, generator=g)
    model.eval()
    a = served_arrays
    if hasattr(model, "cfg"):
        rec = recorded(lambda: batched_forward(
            model, a["x"], a["adj"], a["snps"], batch_size=256, dtype=dtype))
    else:
        rec = recorded(lambda: batched_forward_snps(
            model, a["snps"], batch_size=256, dtype=dtype))
    assert_no_atomics(rec)


def test_the_recorder_flags_atomics_and_clears_single_writes():
    """What the audit rests on: an `index_add_` and a gather whose backward
    writes an index twice are flagged; a gather whose backward writes each
    index once (the NLL's one label per row) is not."""
    idx = torch.tensor([0, 1, 1])
    rec = recorded(lambda: torch.zeros(2).index_add_(0, idx, torch.ones(3)))
    assert rec.flagged and "index_add" in rec.flagged[0]

    def gather_backward(index):
        t = torch.ones(3, 4, requires_grad=True)
        t.gather(1, index).sum().backward()

    rec = recorded(lambda: gather_backward(torch.tensor([[0], [2], [3]])))
    assert not rec.flagged and rec.allowed == 1
    rec = recorded(lambda: gather_backward(torch.tensor([[0, 0]] * 3)))
    assert rec.flagged and "scatter_add" in rec.flagged[0]

    def index_backward():
        t = torch.ones(3, requires_grad=True)
        t[torch.tensor([0, 0, 2])].sum().backward()

    rec = recorded(index_backward)
    assert rec.flagged
