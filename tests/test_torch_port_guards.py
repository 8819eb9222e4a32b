"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, picks the card unless asked for the CPU, and pins fp32 numerics."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from iggcn_tpu_torch.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "iggcn_tpu"}


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "iggcn_tpu_torch")):
        files.extend(os.path.join(dirpath, n) for n in sorted(names)
                     if n.endswith(".py"))
    return files


def _import_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_import_root_check_tells_the_packages_apart():
    tree = ast.parse("import iggcn_tpu_torch.ops\nfrom iggcn_tpu.ops import gcn\n"
                     "from jax import numpy\n")
    roots = [r for r, _ in _import_roots(tree)]
    assert roots == ["iggcn_tpu_torch", "iggcn_tpu", "jax"]
    assert [r for r in roots if r in FORBIDDEN_ROOTS] == ["iggcn_tpu", "jax"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 10
    bad = []
    for path in sources:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        bad += [f"{os.path.relpath(path, REPO)}:{line}: import {root}"
                for root, line in _import_roots(tree)
                if root in FORBIDDEN_ROOTS]
    assert not bad, "\n".join(bad)


def test_importing_the_serving_tool_loads_no_jax():
    code = ("import sys, iggcn_tpu_torch.tools.serve, chip_smoke\n"
            "import iggcn_tpu_torch.main, iggcn_tpu_torch.train.cv\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'iggcn_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        platform.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        platform.resolve_device("cuda")
    assert platform.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        platform.resolve_device("meta")


def test_tf32_is_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
