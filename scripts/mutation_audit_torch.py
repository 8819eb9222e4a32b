"""Test-sensitivity audit of the PyTorch port: prove that the port's tests
catch drift.

For each mutation in `scripts/torch_mutations.py` (a plausible
misimplementation of `iggcn_tpu_torch.*`: StepLR off by one, the biased
running variance, decoupled decay, dropped self-loops, the padding gate,
the stack's relu tie and its plan, ...), run its pinned port test in a
subprocess with the registry loaded as a pytest plugin and
`IGGCN_TORCH_MUTATION` set, and assert that it fails; then run every
target once unmutated and assert that it passes, so that each failure is
the mutation's.

The port's counterpart of `scripts/mutation_audit.py`, which patches the
JAX package only (`tests/mutations.py`, applied by `tests/conftest.py`).

Usage:
    env JAX_PLATFORMS=cpu python scripts/mutation_audit_torch.py [names...]

Prints one line per case and a final JSON summary; exits 1 when a
mutation is not caught (its target stays green, or pytest stops with
another code than a failed test's) or a control is red, 2 for an unknown
name. Runtime: ~8-9 min for all twenty-one.
"""
import json
import os
import subprocess
import sys
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
sys.path.insert(0, SCRIPTS)

from torch_mutations import ENV, MUTATIONS, TARGETS  # noqa: E402

TESTS_FAILED = 1             # pytest's exit code when a test failed


def run_pytest(target: str, mutation: str = "") -> int:
    """pytest's exit code for `target` with `mutation` applied (none when
    empty), in a fresh process on the CPU."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [SCRIPTS] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p])
    env.pop("IGGCN_MUTATION", None)
    if mutation:
        env[ENV] = mutation
    else:
        env.pop(ENV, None)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", target, "-x", "-q", "--no-header",
         "-p", "no:cacheprovider", "-p", "torch_mutations"],
        cwd=REPO, env=env, capture_output=True, text=True)
    return proc.returncode


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or sorted(MUTATIONS)
    unknown = [n for n in names if n not in MUTATIONS]
    if unknown:
        print(f"unknown mutation(s) {unknown}; known: {sorted(MUTATIONS)}")
        return 2

    results = {}
    for name in names:
        target = TARGETS[name]
        t0 = time.perf_counter()
        rc = run_pytest(target, mutation=name)
        # 1: a test failed; any other code (an error before or outside the
        # tests, a usage error) does not show that the tests catch it
        caught = rc == TESTS_FAILED
        results[name] = {"target": target, "caught": caught, "rc": rc}
        print(f"[mutation] {name:26s} -> {target}: "
              f"{'CAUGHT' if caught else f'NOT CAUGHT (bad, rc {rc})'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    controls = {}
    for target in sorted({TARGETS[n] for n in names}):
        rc = run_pytest(target)
        controls[target] = rc == 0
        print(f"[control]  {target}: {'green' if rc == 0 else 'RED (bad)'}",
              flush=True)

    ok = (all(r["caught"] for r in results.values())
          and all(controls.values()))
    print(json.dumps({"mutations": results, "controls": controls,
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
