"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port `iggcn_tpu_torch` is allowed,
`iggcn_tpu` is not), and the reference imports nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark.harness import checks

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("loaded, found", [
    (["iggcn_tpu_torch", "iggcn_tpu_torch.train.cv", "numpy"], []),
    (["jaxtyping", "flaxen", "optax_like", "iggcn_tpu_torchx"], []),
    (["iggcn_tpu.ops.pallas_gcn"], ["iggcn_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "optax"], ["flax", "optax"]),
])
def test_forbidden_names_compared_whole(loaded, found):
    assert checks.forbidden_loaded(loaded) == found


def _run(code):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_of_each_kind_loads_no_jax():
    """Every cell's kind driven on the CPU at a tiny size (its set-up,
    window and check, the port's modules it loads with them), then the
    process's modules are looked at."""
    code = f"""
import sys, time, torch
sys.path.insert(0, {ROOT!r})
torch.set_num_threads(1)
from benchmark import run
from benchmark.harness import checks, registry
from benchmark.tests.conftest import SMALL
for cell in [w["name"] for w in registry.spec()["workloads"]]:
    run.run_cell(cell, 5, 0.5, False, torch.device("cpu"), overrides=SMALL,
                 start=time.perf_counter())
for name in [m["name"] for m in registry.spec()["per_layer"]]:
    registry.metric_reader(name)
print(checks.forbidden_loaded())
"""
    assert _run(code) == "[]"


def test_reference_imports_nothing_of_the_port():
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import benchmark.reference.fused_sgcn
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"iggcn_tpu_torch", "iggcn_tpu", "jax", "flax"}}))
"""
    assert _run(code) == "[]"
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                       "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "iggcn_tpu_torch", "iggcn_tpu", "benchmark"), \
                    (path, name)
