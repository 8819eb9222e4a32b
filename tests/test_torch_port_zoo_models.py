"""The port's zoo models against the JAX package on the same weights, on
the CPU, for all 18 zoo names of the CLI (built by both CLIs' tables,
`build_zoo_model` / `_build_zoo_model`, over bit-equal datasets: a
synthetic TU benchmark of 6-20 nodes with degree features, and for the
Nested* names its nested dataset at h=2 with `spd` labels and resistance
distances, so both label embeddings run), H=8, two layers (TopK and
Graclus three, DiffPool four, so that every pool and DiffPool's second
level run):

  * `repr` and the class name are the flax module's (the fold records'
    fingerprint reads them);
  * `tools/convert.py` both ways: the JAX init's flax tree loads into the
    port model and comes back unchanged, leaf for leaf (so the leaf names
    and shapes are the flax module's; the conv kernels are permuted);
  * eval log-probabilities with random batch-norm running statistics,
    max abs diff 1e-5;
  * six train steps of the port's generic step against the JAX
    `build_generic_steps` (batches of 8 with two zero-weight padding rows,
    the learning rate across two StepLR boundaries, dropout zeroed on both
    sides): per-step losses rtol 2e-4, final parameters and batch-norm
    running statistics rtol 2e-4 / atol 1e-6, except where a gradient is
    zero to rounding. Adam's step g / (sqrt(v) + eps) is scale-free, so
    an entry whose gradient is zero analytically (a bias just before a
    batch norm, the gate bias under GlobalAttention's softmax, a GAT
    target's attention vector under its softmax, a weight that only ever
    meets a padded node's 0 input) moves by up to its learning rate in the
    direction its rounding points, differently in each package. Such
    entries are found on the port's side: each step's float64 gradient
    from the port's state, the entry flagged when its magnitude is at
    most 10 times the port's fp32 error on it. A flagged entry, and the
    running mean of a batch norm channel whose preceding bias entry is
    flagged (the walk shifts that channel's batch mean), may differ by
    twice Adam's largest possible move summed over the steps
    (`adam_step_bound`); every other entry holds the 2e-4 / 1e-6 pin."""
import copy
import math

import jax
import numpy as np
import pytest
import torch

import main as jax_main
from iggcn_tpu.data import nested as jax_nested
from iggcn_tpu.data import tu as jax_tu
from iggcn_tpu.models import baselines as jax_baselines
from iggcn_tpu.models import nested as jax_nested_models
from iggcn_tpu.train import generic_cv as jax_cv
from iggcn_tpu.train.steps import adam_transform
from iggcn_tpu.train.steps import steplr_host as jax_steplr
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.data import nested, tu
from iggcn_tpu_torch.tools.convert import (load_flax_variables,
                                           to_flax_variables)
from iggcn_tpu_torch.train import generic_cv

B, H, STEPS, LR = 8, 8, 6, 3e-3
DECAY_EVERY, FACTOR = 2, 0.5
LAYERS = {"TopK": 3, "Graclus": 3, "DiffPool": 4}
NESTED = dict(h=2, node_label="spd", use_rd=True)


@pytest.fixture(autouse=True, scope="module")
def fast_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_jax_dropout(monkeypatch):
    """The JAX CNN and nested heads drop at a fixed 0.5; the port's rates
    are zeroed instead."""
    identity = lambda rng, x, rate, *a, **k: x  # noqa: E731
    monkeypatch.setattr(jax_baselines, "dropout", identity)
    monkeypatch.setattr(jax_nested_models, "dropout", identity)


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_graphs=24, n_min=6, n_max=20)
    small = dict(num_graphs=24, n_min=4, n_max=8)
    port = tu.synthetic_tu_dataset(np.random.default_rng(7), **kw)
    jax_ds = jax_tu.synthetic_tu_dataset(np.random.default_rng(7), **kw)
    port_small = tu.synthetic_tu_dataset(np.random.default_rng(8), **small)
    jax_small = jax_tu.synthetic_tu_dataset(np.random.default_rng(8), **small)
    return {"port": port, "jax": jax_ds,
            "port_nested": nested.create_nested_dataset(port_small, **NESTED),
            "jax_nested": jax_nested.create_nested_dataset(jax_small,
                                                           **NESTED)}


def _models(name, datasets):
    """(port model, JAX model, cv_kwargs, the dataset's arrays)."""
    key = "nested" if name.startswith("Nested") else ""
    port_ds = datasets["port_" + key if key else "port"]
    jax_ds = datasets["jax_" + key if key else "jax"]
    layers = LAYERS.get(name, 2)
    model, kw = port_main.build_zoo_model(name, layers, H, port_ds)
    jmodel, jkw = jax_main._build_zoo_model(name, layers, H, jax_ds)
    assert kw == jkw
    arrays = {k: getattr(port_ds, k) for k in generic_cv.BATCH_KEYS
              if getattr(port_ds, k, None) is not None}
    return model, jmodel, kw, arrays


def _batch(arrays, rows, w=None):
    out = {k: v[rows] for k, v in arrays.items()}
    out["y"] = out["y"].astype(np.int32)
    out["w"] = (np.ones(len(rows), np.float32) if w is None
                else np.asarray(w, np.float32))
    return out


def _port_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _wiring(kw):
    return {k: kw.get(k, False) for k in ("needs_mask", "needs_assign",
                                         "adj_only", "takes_weight")}


def _quiet(model):
    model.dropout_lin = 0.0
    return model


def _random_stats(model, seed=5):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.3, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_args(jmodel, batch, kw):
    w = _wiring(kw)
    if w["adj_only"]:
        return (batch["adj"],)
    if w["needs_mask"]:
        args = (batch["x"], batch["adj"], batch["mask"])
        return args + ((batch["assign"],) if w["needs_assign"] else ())
    return (batch["x"], batch["adj"])


@pytest.mark.parametrize("name", port_main.ZOO_MODELS)
def test_forward_repr_and_weights_match_jax(datasets, name):
    model, jmodel, kw, arrays = _models(name, datasets)
    assert type(model).__name__ == type(jmodel).__name__
    assert repr(model) == repr(jmodel)
    batch = _batch(arrays, np.arange(B))
    extra = {k: batch[k] for k in ("z", "rd") if k in batch}
    init = jmodel.init(jax.random.PRNGKey(0), *_jax_args(jmodel, batch, kw),
                       **extra)
    init = jax.device_get(init)
    fresh = model.fresh(generator=torch.Generator().manual_seed(1))
    load_flax_variables(fresh, init["params"], init.get("batch_stats"))
    back = to_flax_variables(fresh)
    for coll in ("params", "batch_stats"):
        got = dict(_flat(back[coll]))
        want = dict(_flat(init.get(coll, {})))
        assert sorted(got) == sorted(want), coll
        for path, a in want.items():
            np.testing.assert_array_equal(got[path], a,
                                          err_msg="/".join(path))

    _random_stats(model)
    variables = to_flax_variables(model)
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    want = jax_cv._model_forward(jmodel, variables, batch, False, None,
                                 needs_mask=kw.get("needs_mask", False),
                                 needs_assign=kw.get("needs_assign", False),
                                 adj_only=kw.get("adj_only", False),
                                 mutable=False,
                                 takes_weight=kw.get("takes_weight", False))[0]
    got = generic_cv.model_forward(model, _port_batch(batch), False, None,
                                   **_wiring(kw))
    if isinstance(want, tuple):
        want, got = want[0], got[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


def adam_step_bound(lr_t, t, b1=0.9, b2=0.999):
    """Largest move of a parameter in Adam step t (1-based) at learning rate
    lr_t from a fresh state, whatever its gradients (Cauchy-Schwarz on the
    moment sums)."""
    r = b1 * b1 / b2
    return (lr_t * (1 - b1) / (1 - b1 ** t)
            * math.sqrt((1 - b2 ** t) / (1 - b2))
            * math.sqrt((1 - r ** t) / (1 - r)))


def _zero_to_rounding(model, batch, wiring):
    """{flax path: entries whose float64 gradient, from `model`'s state on
    `batch`, is at most 10 times the fp32 error of the port's gradient};
    call after the port's fp32 step on `batch`, from a float64 copy taken
    before it."""
    m64, before = model
    opt = torch.optim.SGD(m64.parameters(), lr=0.0)
    step64, _ = generic_cv.build_generic_steps(m64, opt, **wiring)
    step64({k: v.double() if v.is_floating_point() else v
            for k, v in _port_batch(batch).items()}, None, 0.0)
    out = {}
    for (name, p64), p32 in zip(m64.named_parameters(), before.parameters()):
        if p64.grad is None or p32.grad is None:   # not on this route
            continue
        g64 = p64.grad.numpy()
        err = np.abs(p32.grad.double().numpy() - g64)
        out[name] = np.abs(g64) <= 10 * err
    return out


def _flagged_paths(model, flags):
    """flags by port parameter name -> by flax path, in the flax layout."""
    fake = {n: torch.from_numpy(f.astype(np.float32))
            for n, f in flags.items()}
    state = dict(model.state_dict())
    state.update(fake)
    tree = to_flax_variables(model, state)["params"]
    return {p: a > 0 for p, a in _flat(tree)}


@pytest.mark.parametrize("name", port_main.ZOO_MODELS)
def test_six_train_steps_match_build_generic_steps(datasets, name):
    model, jmodel, kw, arrays = _models(name, datasets)
    _quiet(model)
    variables = to_flax_variables(model)
    has_stats = bool(variables["batch_stats"])
    if not has_stats:
        del variables["batch_stats"]
    wiring = dict(needs_mask=kw.get("needs_mask", False),
                  needs_assign=kw.get("needs_assign", False),
                  adj_only=kw.get("adj_only", False),
                  aux_loss=kw.get("aux_loss", False),
                  takes_weight=kw.get("takes_weight", False))
    optimizer = adam_transform()
    train_step, _ = jax_cv.build_generic_steps(jmodel, optimizer,
                                               has_stats=has_stats, **wiring)
    opt_state = optimizer.init(variables["params"])
    port_opt = generic_cv.make_generic_optimizer(model)
    port_step, _ = generic_cv.build_generic_steps(model, port_opt, **wiring)
    order = np.random.default_rng(11).permutation(len(arrays["y"]))
    w = np.ones(B, np.float32)
    w[-2:] = 0.0
    rng = jax.random.PRNGKey(3)       # feeds zeroed dropout only
    want, got, walk = [], [], 0.0
    flags = {n: np.zeros(p.shape, bool) for n, p in model.named_parameters()}
    for t in range(STEPS):
        lr_t = generic_cv.steplr_host(LR, FACTOR, DECAY_EVERY, t)
        assert lr_t == jax_steplr(LR, FACTOR, DECAY_EVERY, t)
        walk += 2 * adam_step_bound(lr_t, t + 1)
        rows = order[(t * B) % len(order):][:B]
        batch = _batch(arrays, rows, w)
        rng, srng = jax.random.split(rng)
        variables, opt_state, loss = train_step(variables, opt_state, batch,
                                                srng, np.float32(lr_t))
        want.append(float(loss))
        m64 = copy.deepcopy(model).double()
        got.append(float(port_step(_port_batch(batch), None, lr_t)))
        for n, f in _zero_to_rounding((m64, model), batch, wiring).items():
            flags[n] |= f
    np.testing.assert_allclose(got, want, rtol=2e-4)
    walking = _flagged_paths(model, flags)
    final = to_flax_variables(model)
    for coll in variables:
        mine = dict(_flat(final[coll]))
        for path, a in _flat(jax.device_get(variables[coll])):
            free = np.zeros(a.shape, bool)
            if coll == "params":
                free = walking[path]
            elif path[-1] == "mean":
                # the linear before a GIN MLP's batch norm: bnK follows lK
                # where the MLP interleaves two, its one late bn1 follows l2
                # (through a relu that passes a channel's shift where it is
                # active on every row)
                mlp = path[:-2]
                interleaved = (mlp + ("bn2", "mean")) in dict(
                    _flat(variables[coll]))
                lin = "l" + path[-2][2:] if interleaved else "l2"
                free = walking.get(mlp + (lin, "bias"), free)
            diff = np.abs(mine[path] - a)
            name = f"{coll}/{'/'.join(path)}"
            assert (diff <= 2e-4 * np.abs(a) + 1e-6)[~free].all(), (
                name, float(diff[~free].max()))
            assert (diff[free] <= walk).all(), (name, float(diff.max()),
                                                walk)
