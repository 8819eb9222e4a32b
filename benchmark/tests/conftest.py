"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`card` that need a CUDA device and skip without one (decided inside the
`cuda_device` fixture, never at import). Run them from the repo root:

    OMP_NUM_THREADS=1 python -m pytest benchmark/tests -q
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the tests' tiny sizes: 80 subjects, a 5-level DAG of 57 terms, batch 8,
# 2 permutation variants; 2 cohorts of 40 served at 16
SMALL = {"config": {"cohort": {"subjects": 80,
                               "go_levels": [24, 16, 10, 6, 1]},
                    "train": {"batch_size": 8}},
         "traffic": {"variants": 2, "cohort_subjects": 40, "batch_size": 16,
                     "pool": 2}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 products exist "
                    "only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def small():
    import copy
    return copy.deepcopy(SMALL)
