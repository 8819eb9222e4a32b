"""Traffic kind `train_chunk`: one chunk of a permutation test, trained as
one batched program.

The CLI (`--permut_seeds A:B --fold_parallel`) trains a permutation null
in chunks of `--spmd_batch_entries` fold entries: S permutation variants
x k folds, each variant the cohort with its subject -> score pairing
shuffled, all sharing the splits, the initial weights of each fold, its
dropout stream and its epoch shuffles. Each chunk is one call of
`iggcn_tpu_torch.train.fold_parallel.run_folds_parallel` over the
entries `cv.prepare_fold` prepares.

Set-up draws the cohort, the DAG, the variants and one weight set per
fold from the seed, prepares the entries and builds the fold models,
then makes a call of one epoch, which builds every kernel and warms
every shape, and puts the models, their dropout streams and the epochs
back at the start. The window is one call of a fixed number of epochs
from there: every train step, each epoch's evaluation of the validation
and test folds, and the best-epoch keep. The count is the cell's
(`window` in its file: a call's fixed seconds and an epoch's seconds on
the card), so that `--seconds` hold it, and it does not depend on how
fast a run goes. The window's call records, on the device, what its
first steps did and the weights its first evaluation read; the check
copies them to the host once the window has closed.

Traffic parameters: `variants`, the permutation variants of the chunk.
The configuration gives the family (`family`), the cohort (`cohort`),
the model, the training settings (`train`) and the loss weights.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import checks, data, device as devlib, port, work
from benchmark.reference import fused_sgcn as ref

# the families this kind trains: the configuration's `family` -> the port's
# model kind; the reference is `reference/fused_sgcn.py`
FAMILIES = {"SGCN_GCN_IMGSNP": "sgcn_imgsnp"}
CHECK_STEPS = 3
MAX_EPOCHS = 64
STACK_COUNTERS = ("launches", "launches_backward", "launches_streamed",
                  "launches_bf16")


def family(cfg: dict) -> str:
    """The port's model kind of the configuration's family; a family this
    kind does not train raises."""
    if cfg.get("family") not in FAMILIES:
        raise ValueError(f"the kind train_chunk trains {sorted(FAMILIES)}, "
                         f"not {cfg.get('family')!r}")
    return FAMILIES[cfg["family"]]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Recorder:
    """Wraps the trainer's batched train and eval steps for one call. Of
    the first CHECK_STEPS train steps it keeps every entry's loss, the rows
    and row weights trained, each leaf's first gradient as Adam holds it
    (its first moment over 1 - beta1) and, over the steps, each leaf's
    change and each running statistic's; at the first eval batch, every
    tensor of the entries' state (the weights the first epoch's
    evaluation reads). All of it stays on the device until `host()`.
    `fault` plants a fault: into every train step (`stale_state`,
    `half_batch`) or into the first evaluation's outputs
    (`altered_answer`)."""

    def __init__(self, fault: str = None):
        self.fault = fault
        self.taken, self.start = 0, None
        self.losses, self.x, self.w = [], [], []
        self.first_grad = self.change = self.stats = self.at_eval = None

    @contextlib.contextmanager
    def installed(self):
        from iggcn_tpu_torch.train import fold_parallel
        train, evaluate = (fold_parallel.batched_train_step,
                           fold_parallel.batched_eval_step)
        self._train, self._eval = train, evaluate
        fold_parallel.batched_train_step = self.train
        fold_parallel.batched_eval_step = self.eval
        try:
            yield self
        finally:
            fold_parallel.batched_train_step = train
            fold_parallel.batched_eval_step = evaluate

    def train(self, state, batch, mcfg, tcfg, noise, has_real):
        i = self.taken
        self.taken += 1
        if i == 0:
            self.start = {k: v.detach().clone()
                          for k, v in state.fold_tensors().items()}
        given = batch
        if self.fault == "half_batch":
            half = batch["w"].shape[1] // 2
            batch = dict(batch, w=torch.cat(
                [batch["w"][:, :half], torch.zeros_like(batch["w"][:, half:])],
                dim=1))
        if self.fault == "stale_state":
            kept = {k: v.detach().clone() for k, v in self._tensors(state)}
        out = self._train(state, batch, mcfg, tcfg, noise, has_real)
        if self.fault == "stale_state":
            with torch.no_grad():
                for k, v in self._tensors(state):
                    v.copy_(kept[k])
        if i >= CHECK_STEPS:
            return out
        with torch.no_grad():
            self.losses.append(out / batch["w"].sum(dim=1))
            self.x.append(given["x"].clone())
            self.w.append(given["w"].clone())
            if i == 0:
                b1 = ref.ADAM_BETAS[0]
                self.first_grad = {k: (v / (1 - b1)).flatten(1).norm(dim=1)
                                   for k, v in state.exp_avg.items()}
            if i == CHECK_STEPS - 1:
                moved = {k: (v.detach() - self.start[k]).flatten(1)
                         .norm(dim=1)
                         for k, v in state.fold_tensors().items()}
                self.change = {k: moved[k] for k in state.params}
                self.stats = {k: moved[k] for k in state.buffers}
                self.start = None
        return out

    @staticmethod
    def _tensors(state):
        for name, group in (("params", state.params),
                            ("buffers", state.buffers),
                            ("exp_avg", state.exp_avg),
                            ("exp_avg_sq", state.exp_avg_sq)):
            for k, v in group.items():
                yield f"{name}.{k}", v

    def eval(self, state, batch, mcfg, tcfg):
        first = self.at_eval is None
        if first:
            self.at_eval = {k: v.detach().clone()
                            for k, v in state.fold_tensors().items()}
        out = self._eval(state, batch, mcfg, tcfg)
        if first and self.fault == "altered_answer":
            out = dict(out, log_probs=out["log_probs"].flip(-1))
        return out

    def host(self) -> dict:
        """What was recorded, as host arrays (the first evaluation's
        weights stay tensors on the device: the reference reads them
        there)."""
        return {"losses": [_host(t) for t in self.losses],
                "x": [_host(t) for t in self.x],
                "w": [_host(t) for t in self.w],
                "first_grad": {k: _host(v) for k, v in self.first_grad.items()},
                "change": {k: _host(v) for k, v in self.change.items()},
                "stats": {k: _host(v) for k, v in self.stats.items()},
                "at_eval": self.at_eval}


def _train_config(cfg: dict, seed: int):
    from iggcn_tpu_torch.config import LossWeights, TrainConfig
    t = cfg["train"]
    return TrainConfig(epochs=MAX_EPOCHS, batch_size=t["batch_size"],
                       lr=t["lr"], lr_decay_factor=t["lr_decay_factor"],
                       lr_decay_step_size=t["lr_decay_step_size"],
                       weight_decay=t["weight_decay"], folds=t["folds"],
                       seed=data.sub_seed(seed, 6) % 2**31,
                       is_permut_test=True, fold_parallel=True,
                       loss=LossWeights(**cfg["loss"]))


def prepare(ctx) -> dict:
    """Inputs, entries and fold models: everything before the first
    call."""
    from iggcn_tpu_torch.data.adni import AdniCohort, MinMaxScaler
    from iggcn_tpu_torch.data.batching import cohort_batch_arrays
    from iggcn_tpu_torch.data.splits import k_fold
    from iggcn_tpu_torch.train import cv
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    kind = family(cfg)
    m, c = cfg["model"], cfg["cohort"]
    mcfg, tcfg = port.model_config(m), _train_config(cfg, seed)
    with ctx.span("setup.cohort"):
        dag = data.go_dag(seed, c["go_levels"], m["num_snps"])
        co = data.cohort(seed, c["subjects"], m["rois"], m["feat_dim"],
                         m["num_snps"], m["num_classes"], c["knn"], dev)
        perms = data.permutations(seed, tr["variants"], c["subjects"])
        topo = port.topology(dag)
        scaler = MinMaxScaler().fit(co["demographics"])
        clini = scaler.transform(co["demographics"])[
            :, list(data.CLINICAL_COLUMNS)].astype(np.float32)
    with ctx.span("setup.entries"):
        splits = k_fold(co["y"], tcfg.folds, tcfg.seed)
        entries = []
        for v, perm in enumerate(perms):
            cohort = AdniCohort(
                x=co["x"], adj=co["adj"], raw_adj=co["adj"], y=co["y"],
                clust_y=co["clust_y"], snps=co["snps"],
                sbj_id=np.arange(c["subjects"]), tsne_fdim=co["tsne"],
                clini_score=clini[perm],
                demographics=co["demographics"][perm], scaler4score=scaler,
                num_classes=m["num_classes"])
            full = cohort_batch_arrays(cohort)
            for fold, split in enumerate(splits):
                entries.append({"variant": v, "fold": fold,
                                "p": cv.prepare_fold(cohort, full, split,
                                                     fold, tcfg, -1)})
            del full
    with ctx.span("setup.models"):
        shapes = {k: tuple(t.shape) for k, t in cv.MODEL_FAMILIES[kind](
            mcfg, topo, device="cpu").state_dict().items()}
        weights = data.weight_sets(shapes, tcfg.folds, seed, dev)
        drop_seeds = [data.sub_seed(seed, 5, f) for f in range(tcfg.folds)]
        models, gens = [], []
        for e in entries:
            model = cv.MODEL_FAMILIES[kind](mcfg, topo, device=dev)
            model.load_state_dict(weights[e["fold"]])
            models.append(model)
            gens.append(torch.Generator(dev).manual_seed(
                drop_seeds[e["fold"]]))
    return {"ctx": ctx, "kind": kind, "mcfg": mcfg, "tcfg": tcfg,
            "entries": entries, "models": models, "gens": gens, "dag": dag,
            "cohort": co, "perms": perms, "splits": splits,
            "weights": weights, "drop_seeds": drop_seeds}


def reset(state: dict) -> None:
    """The models back at the seed's weights and their dropout streams at
    the start: the next call trains as the first would (each call builds
    its own Adam state and step counts, and starts at the first epoch)."""
    for e, model, gen in zip(state["entries"], state["models"],
                             state["gens"]):
        model.load_state_dict(state["weights"][e["fold"]])
        gen.manual_seed(state["drop_seeds"][e["fold"]])


def setup(ctx) -> dict:
    state = prepare(ctx)
    with ctx.span("setup.warm"):
        _call(state, 1)
    reset(state)
    return state


def _call(state: dict, epochs: int):
    """One call of the batched trainer over every entry for `epochs`
    epochs, from the first epoch's shuffles."""
    from iggcn_tpu_torch.train.fold_parallel import run_folds_parallel
    if epochs > MAX_EPOCHS:
        raise ValueError(f"more than {MAX_EPOCHS} epochs prepared")
    ps = [e["p"] for e in state["entries"]]
    tcfg = state["tcfg"]
    return run_folds_parallel(
        state["models"], state["gens"], [p["train_data"] for p in ps],
        [p["val_data"] for p in ps], [p["test_data"] for p in ps],
        [p["perms"][:epochs] for p in ps],
        [p["train_data"]["y"].shape[0] // tcfg.batch_size for p in ps],
        state["mcfg"], tcfg, state["kind"])


def _recorded_call(state: dict, epochs: int) -> None:
    """`_call` with the recorder installed; its results and the recorder
    are kept for the check."""
    recorder = Recorder(fault=state["ctx"].fault)
    with recorder.installed():
        per_epoch, best, _ = _call(state, epochs)
    state.update(recorder=recorder, per_epoch=per_epoch, best=best)


def _graphs(state: dict, split: str) -> int:
    return sum(e["p"][f"n_{split}"] for e in state["entries"])


def window_epochs(pace: dict, seconds: float) -> int:
    """The epochs that fill `seconds` at the cell's nominal pace."""
    return max(1, int(round((seconds - pace["call_s"]) / pace["epoch_s"])))


def window(state: dict, seconds: float) -> dict:
    """One call of the epochs that fill `seconds` at the cell's nominal
    pace: training graphs completed over the call's whole wall time."""
    epochs = window_epochs(state["ctx"].cell["window"], seconds)
    with state["ctx"].span("window"):
        t0 = time.perf_counter()
        _recorded_call(state, epochs)
        wall = time.perf_counter() - t0
    failed = sum(int(not np.all(np.isfinite(pe["train_loss_sum"])))
                 for pe in state["per_epoch"])
    return {"metrics": {"train_graphs_per_s":
                        epochs * _graphs(state, "train") / wall},
            "attempted": len(state["per_epoch"]) * epochs, "failed": failed}


def traced(state: dict) -> dict:
    """The window's call for one epoch under the profiler, with the work
    it did: batched train steps, model FLOPs of the real rows, and the
    stack kernels' calls with their shapes."""
    from iggcn_tpu_torch.ops.gcn_stack import fused_gcn_stack
    sessions = []

    def epoch():
        if sessions:        # a retried session: start the call afresh
            reset(state)
        sessions.append(len(sessions))
        for k in STACK_COUNTERS:
            setattr(fused_gcn_stack, k, 0)
        _recorded_call(state, 1)
    warm = lambda: torch.ones(1, device=state["ctx"].device).add_(1)  # noqa
    with state["ctx"].span("traced_epoch"):
        dev_events, wall, _ = devlib.profiled(
            epoch, warm, lambda ev: devlib.stack_kernels_complete(
                ev, fused_gcn_stack))
    cfg = state["ctx"].config
    m, b, f = cfg["model"], cfg["train"]["batch_size"], len(state["entries"])
    levels = cfg["cohort"]["go_levels"]
    both = work.pass_flops(m, levels) + work.masked_pass_flops(m, levels)
    ps = [e["p"] for e in state["entries"]]
    rows = {s: max(p[f"{s}_data"]["y"].shape[0] for p in ps)
            for s in ("train", "val", "test")}
    widths = (m["hidden"],) * m["num_layers"]
    shape = (f, b, m["rois"], m["feat_dim"], widths)
    return {"device": dev_events, "window_s": wall,
            "work": {"train_batches": rows["train"] // b,
                     "model_flops": both * (3 * _graphs(state, "train")
                                            + _graphs(state, "val")
                                            + _graphs(state, "test")),
                     "stack_calls": {
                         "forward": (fused_gcn_stack.launches,
                                     work.grouped_work(*shape)),
                         "backward": (fused_gcn_stack.launches_backward,
                                      work.backward_work(*shape))},
                     "other_stack_calls": fused_gcn_stack.launches_streamed
                     + fused_gcn_stack.launches_bf16}}


def check(state: dict) -> Dict[str, float]:
    """Copies the window's records to the host, frees the program's state,
    then follows every entry's first steps with the reference from the
    same weights, rows and dropout streams, evaluates its validation and
    test folds with the weights the program's first evaluation read, and
    checks the best-epoch keep against the program's per-epoch results."""
    rec = state.pop("recorder").host()
    for key in ("models", "gens"):
        state.pop(key, None)
    if state["ctx"].device.type == "cuda":
        torch.cuda.empty_cache()
    want, unknown = reference(state, rec)
    return readings(program(rec, state["per_epoch"]), want, unknown,
                    best_mismatch(state["per_epoch"], state["best"]))


def program(rec: dict, per_epoch: List[dict]) -> List[dict]:
    """Each entry's numbers as the program gave them: its first steps'
    losses, each leaf's first gradient norm and change norm, each running
    statistic's change norm, and its first epoch's evaluation (loss sums,
    test rows' log_probs and our_reg)."""
    return [{"losses": np.asarray([step[i] for step in rec["losses"]]),
             "first_grad": {k: float(v[i])
                            for k, v in rec["first_grad"].items()},
             "change": {k: float(v[i]) for k, v in rec["change"].items()},
             "stats": {k: float(v[i]) for k, v in rec["stats"].items()},
             "eval": {"val_loss_sum": float(pe["val_loss_sum"][0]),
                      "test_loss_sum": float(pe["test_loss_sum"][0]),
                      "log_probs": pe["log_probs"][0],
                      "our_reg": pe["our_reg"][0]}}
            for i, pe in enumerate(per_epoch)]


def best_mismatch(per_epoch: List[dict], best: List[dict]) -> int:
    """The entries whose kept best epoch is not the first epoch of the
    least validation loss sum, or whose kept test results are not that
    epoch's."""
    bad = 0
    for pe, b in zip(per_epoch, best):
        e = int(np.argmin(pe["val_loss_sum"]))
        same = b["val_loss_sum"] == pe["val_loss_sum"][e] and \
            b["test"]["loss_sum"] == pe["test_loss_sum"][e] and all(
                np.array_equal(v, pe[k][e])
                for k, v in b["test"].items() if k != "loss_sum")
        bad += int(not same)
    return bad


def reference(state: dict, rec: dict, exact: bool = True):
    """(each entry's numbers by the reference, and the count of trained
    rows that were not the entry's to train). An entry's first steps are
    followed where every row the program trained is a distinct subject of
    its fold's train split at weight 1; its first evaluation is the
    reference's, over the fold's validation and test subjects in the
    split's order, with the weights the program's evaluation read.
    `exact=False` computes in TF32: the control."""
    ctx = state["ctx"]
    dev, cfg = ctx.device, ctx.config
    co = state["cohort"]
    dag = ref.GoDag(state["dag"]["adj_child_parent"], state["dag"]["go_snps"],
                    state["dag"]["pool"], cfg["model"]["go_n_l"], dev)
    index = {co["x"][s].tobytes(): s for s in range(len(co["x"]))}
    arrays = {k: torch.as_tensor(co[k], device=dev)
              for k in ("x", "adj", "snps", "y", "tsne")}
    clini = ref.clinical_targets(co["demographics"], data.CLINICAL_COLUMNS)
    rcfg = dict(cfg["model"], loss=cfg["loss"])
    b = cfg["train"]["batch_size"]

    def rows(sids, perm):
        sel = torch.as_tensor(np.asarray(sids), device=dev)
        return {**{k: v[sel] for k, v in arrays.items()},
                "clini": torch.as_tensor(clini[perm][sids], device=dev)}
    out, unknown = [], 0
    ref.exact_matmuls(exact)
    try:
        for i, e in enumerate(state["entries"]):
            perm = state["perms"][e["variant"]]
            train_idx, test_idx, val_idx = state["splits"][e["fold"]]
            own, seen, batches = set(train_idx.tolist()), set(), []
            for x, w in zip(rec["x"], rec["w"]):
                sids = [index.get(r.tobytes(), -1) for r in x[i]]
                bad = int(np.sum(w[i] != 1))
                for s in sids:
                    bad += s not in own or s in seen
                    seen.add(s)
                unknown += bad
                if not bad:
                    batches.append(rows(sids, perm))
            r = None
            if len(batches) == len(rec["x"]):
                gen = torch.Generator(dev).manual_seed(
                    state["drop_seeds"][e["fold"]])
                r = ref.train_steps(state["weights"][e["fold"]], rcfg, dag,
                                    batches, gen, cfg["train"]["lr"],
                                    cfg["train"]["weight_decay"])
                r = {"losses": np.asarray(r["losses"]),
                     "first_grad": {k: float(v.norm())
                                    for k, v in r["first_grad"].items()},
                     "change": {k: float(v.norm())
                                for k, v in r["change"].items()},
                     "stats": {k: float(v.norm())
                               for k, v in r["stats"].items()}}
            w_eval = {k: v[i] for k, v in rec["at_eval"].items()}
            val = ref.evaluate(w_eval, rcfg, dag, rows(val_idx, perm), b)
            test = ref.evaluate(w_eval, rcfg, dag, rows(test_idx, perm), b)
            out.append({"steps": r, "eval": {
                "val_loss_sum": val["loss_sum"],
                "test_loss_sum": test["loss_sum"],
                "log_probs": _host(test["log_probs"]),
                "our_reg": _host(test["our_reg"])}})
    finally:
        ref.exact_matmuls(True)
    return out, unknown


def readings(got: List[dict], want: List[dict], unknown: int = 0,
             best: int = 0) -> Dict[str, float]:
    """The worst entry's gap of each number: the first step's loss
    (relative; the later steps' losses part by fp32 rounding that Adam's
    first update amplifies, PERF.md §2), the first gradient's and (over
    the leaves the reference moves) the change's worst-leaf norm gap, the
    running statistics' worst norm gap (`checks.norm_gap`), the first
    evaluation's loss sums (relative) and its test rows' outputs (widest
    gap); the rows the reference could not follow, and the entries whose
    best-epoch keep is wrong. `got` holds the program's numbers or, for
    the control, the reference's in the shape `reference` gives them."""
    out = {"first_loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0,
           "stats_gap": 0.0, "eval_loss_gap": 0.0, "eval_out_gap": 0.0,
           "rows_unknown": float(unknown), "best_mismatch": float(best)}
    for g, w in zip(got, want):
        gs = g.get("steps", g)
        ws = w["steps"]
        if ws is not None and gs is not None:
            out["first_loss_gap"] = max(out["first_loss_gap"], float(
                abs(gs["losses"][0] - ws["losses"][0]) / abs(ws["losses"][0])))
            out["grad_gap"] = max(out["grad_gap"], checks.norm_gap(
                gs["first_grad"], ws["first_grad"]))
            out["change_gap"] = max(out["change_gap"], checks.norm_gap(
                gs["change"], ws["change"],
                checks.moving_leaves(ws["first_grad"])))
            out["stats_gap"] = max(out["stats_gap"], checks.norm_gap(
                gs["stats"], ws["stats"]))
        ge, we = g["eval"], w["eval"]
        for key in ("val_loss_sum", "test_loss_sum"):
            out["eval_loss_gap"] = max(out["eval_loss_gap"], float(
                abs(ge[key] - we[key]) / abs(we[key])))
        n = len(we["log_probs"])
        for key in ("log_probs", "our_reg"):
            out["eval_out_gap"] = max(out["eval_out_gap"], float(
                np.max(np.abs(ge[key][:n] - we[key]))))
    return out


def calibrate(ctx, control: bool) -> dict:
    """The readings of one seed for setting the limits: a call of one
    epoch, recorded as the window's, against the reference, and with
    `control` the reference in TF32 against it; a fault planted in `ctx`
    reads in the program's place."""
    state = prepare(ctx)
    _recorded_call(state, 1)
    rec = state.pop("recorder").host()
    for key in ("models", "gens"):
        state.pop(key)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    want, unknown = reference(state, rec)
    out = {"program": readings(program(rec, state["per_epoch"]), want,
                               unknown, best_mismatch(state["per_epoch"],
                                                      state["best"]))}
    if control:
        lower, _ = reference(state, rec, exact=False)
        out["control"] = readings(lower, want)
    return out

