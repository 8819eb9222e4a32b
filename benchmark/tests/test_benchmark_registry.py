"""A cell, a configuration, a traffic mix and a per-layer metric added as
files alone, in a copy of the benchmark, are found and run."""
import json
import os
import shutil
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import registry

ROOT = registry.ROOT


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def test_files_added_alone_are_found_and_read(tmp_path, small):
    root = _copy(tmp_path)
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # a configuration: the flagship at another grid point
    cfg = json.loads((bench / "configs" / "flagship-l2h16.json").read_text())
    cfg["model"].update(num_layers=3, hidden=10)
    (bench / "configs" / "flagship-l3h10.json").write_text(json.dumps(cfg))
    spec["configs"].append({**spec["configs"][0], "name": "flagship-l3h10",
                            "file": "benchmark/configs/flagship-l3h10.json"})
    # a traffic mix of an existing kind
    (bench / "traffic" / "permut-chunk-3x5.json").write_text(json.dumps(
        {"kind": "train_chunk", "variants": 3}))
    # a cell, and a metric that lists it
    cell = {"name": "train.flagship-l3h10.permut15",
            "config": "flagship-l3h10", "traffic": "permut-chunk-3x5",
            "chips": 1, "why": "a throwaway cell"}
    spec["workloads"].append(cell)
    own = json.loads((bench / "workloads" /
                      "train.flagship.permut60.json").read_text())
    limits = own["limits"]
    (bench / "workloads" / f"{cell['name']}.json").write_text(json.dumps(
        {**own, **{k: cell[k] for k in registry.CELL_KEYS}}))
    spec["end_to_end"][0]["workloads"].append(cell["name"])
    (bench / "metrics" / "stack_calls.train.py").write_text(
        "def read(t):\n"
        "    return float(t['work']['stack_calls']['forward'][0])\n")
    spec["per_layer"].append({"name": "stack_calls.train", "unit": "calls",
                              "better": "lower", "source": "program_counter",
                              "layer": "imaging stack kernels",
                              "moves": "train_graphs_per_s",
                              "workloads": [cell["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    root = str(root)
    assert registry.cell(cell["name"], root)["limits"] == limits
    assert registry.traffic("permut-chunk-3x5", root)["variants"] == 3
    assert registry.kind("train_chunk", root).family(
        registry.config("flagship-l3h10", root)) == "sgcn_imgsnp"
    assert [m["name"] for m in registry.per_layer(cell["name"], root)] == \
        ["stack_calls.train"]
    assert [m["name"] for m in registry.end_to_end(cell["name"], root)] == \
        ["train_graphs_per_s", "setup_s"]
    reader = registry.metric_reader("stack_calls.train", root)
    assert reader.read({"work": {"stack_calls": {"forward": (4, None)}}}) \
        == 4.0

    small["traffic"]["variants"] = 3
    result, spans = run.run_cell(cell["name"], 21, 0.5, False,
                                 torch.device("cpu"), overrides=small,
                                 start=time.perf_counter(), root=root)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_graphs_per_s", "setup_s"}
    assert result["attempted"] % 15 == 0        # 3 variants x 5 folds
    assert [s[0] for s in spans][-2:] == ["window", "check"]


def test_cell_files_repeat_benchmark_json():
    spec = registry.spec()
    assert {w["name"] for w in spec["workloads"]} == {
        f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark",
                                                "workloads"))}
    for w in spec["workloads"]:
        cell = registry.cell(w["name"])
        assert registry.traffic(cell["traffic"])["kind"]
        assert registry.config(cell["config"])["model"]
    for m in spec["per_layer"]:
        assert registry.metric_reader(m["name"]).read


@pytest.mark.parametrize("kind", ["train_chunk", "score_cohort"])
def test_a_family_the_kind_does_not_run_raises(kind, small):
    """A configuration naming another family is refused, not run as the
    fused SGCN under its name."""
    cfg = registry.config("flagship-l2h16")
    cfg["family"] = "SGCN_GCN_CLUSTERLABEL"
    ctx = run.Context({"limits": {}}, cfg, {**registry.traffic(
        "permut-chunk-12x5"), **small["traffic"]}, 5, torch.device("cpu"))
    with pytest.raises(ValueError, match="SGCN_GCN_CLUSTERLABEL"):
        registry.kind(kind).setup(ctx)


def test_a_configuration_must_state_its_reduced_keys(tmp_path):
    root = _copy(tmp_path)
    path = root / "benchmark" / "configs" / "flagship-l2h16.json"
    cfg = json.loads(path.read_text())
    del cfg["permut_seeds"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="permut_seeds"):
        registry.config("flagship-l2h16", str(root))
