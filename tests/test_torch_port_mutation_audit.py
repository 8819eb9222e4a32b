"""The port's mutation-audit machinery end to end (the full audit of
twenty-one mutations is `scripts/mutation_audit_torch.py`): two fast
mutations of `iggcn_tpu_torch`, applied by the `torch_mutations` pytest
plugin through `IGGCN_TORCH_MUTATION` in a subprocess, each turn their
pinned port test red (a failed test, pytest's exit code 1) while the
same test is green unmutated; an unknown name stops pytest."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

from mutation_audit_torch import TESTS_FAILED, run_pytest  # noqa: E402
from torch_mutations import TARGETS  # noqa: E402


@pytest.mark.parametrize("name", ["kfold_val_is_next",
                                  "padding_weights_ignored"])
def test_mutation_is_caught_and_control_is_green(name):
    assert run_pytest(TARGETS[name], mutation=name) == TESTS_FAILED, (
        f"{TARGETS[name]} did not catch {name}")
    assert run_pytest(TARGETS[name]) == 0, (
        f"control run failed: {TARGETS[name]} is red without a mutation")


def test_unknown_mutation_fails_loudly():
    rc = run_pytest(TARGETS["kfold_val_is_next"], mutation="bogus")
    assert rc not in (0, TESTS_FAILED), rc
