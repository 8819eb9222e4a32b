"""A run with the timed path broken underneath comes out not correct, one
run for each fault a cell can have: a train step that returns its state
unchanged, half of each batch left out with the mean taken over the
rest, an answer altered where it is produced (a served request's, a
training call's first evaluation). The control (the reference
in TF32 in the program's place) fails too; it runs on the card only."""
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import checks, registry


def _run(cell, fault, small, seed=31):
    result, _ = run.run_cell(cell, seed, 0.5, False, torch.device("cpu"),
                             fault=fault, overrides=small,
                             start=time.perf_counter())
    return result


@pytest.mark.parametrize("cell, fault", [
    ("train.flagship.permut60", None),
    ("train.flagship.permut60", "stale_state"),
    ("train.flagship.permut60", "half_batch"),
    ("train.flagship.permut60", "altered_answer"),
    ("serve.flagship.cohort-b1024", None),
    ("serve.flagship.cohort-b1024", "altered_answer"),
])
def test_a_broken_path_is_not_correct(cell, fault, small):
    result = _run(cell, fault, small)
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["train.flagship.permut60",
                                  "train.multifusion.permut60",
                                  "serve.flagship.cohort-b1024"])
def test_the_control_is_not_correct(cell, cuda_device, small):
    """Run on the card at the tests' size (the limits were set from the
    control at the cell's own size): the reference in TF32 fails one of
    the cell's limits, the program passes them."""
    spec = registry.cell(cell)
    config = registry.config(spec["config"])
    traffic = registry.traffic(spec["traffic"])
    for part, target in (("config", config), ("traffic", traffic)):
        for key, value in small[part].items():
            target[key] = ({**target[key], **value}
                           if isinstance(value, dict) else value)
    kind = registry.kind(traffic["kind"])
    ctx = run.Context(spec, config, traffic, 41, cuda_device)
    out = kind.calibrate(ctx, control=True)
    assert checks.judge(out["program"], spec["limits"])[0], out
    assert not checks.judge(out["control"], spec["limits"])[0], out
