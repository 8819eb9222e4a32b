"""The port's `--batch_file` (`iggcn_tpu_torch/main.py:run_batch_file`) on
the CPU: every non-empty, non-# line of the file runs as its own command
line in this process, in order; a failing line is reported and the batch
goes on, and exits 1; a line may not name --batch_file, and the command
line may name nothing else; each run's `cmd_input.txt` records its own
line. The runs are real (GIN on the TUTEST fixture, a fused-family CV at
a few dozen subjects), and each equals its standalone run."""
import os
import shlex

import numpy as np
import pytest
import torch

import main as jax_main
from iggcn_tpu_torch import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = ["--device", "cpu", "--model", "GIN", "--data", "TUTEST", "--tu_root",
       os.path.join(REPO, "tests", "fixtures"), "--epochs", "1", "--fold",
       "3", "--batch_size", "4", "--no-search", "--layers", "2", "--hiddens",
       "8"]
FUSED = ["--device", "cpu", "--synthetic", "--synthetic_subjects", "36",
         "--epochs", "1", "--fold", "3", "--batch_size", "8", "--no-search",
         "--layers", "2", "--hiddens", "8", "--cohort_cache_dir", ""]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _records(res_dir):
    out = {}
    for name in sorted(os.listdir(res_dir)):
        if name.startswith("fold_result_"):
            with np.load(os.path.join(res_dir, name)) as zf:
                out[name] = {k: zf[k] for k in zf.files}
    return out


def test_lines_run_in_order_and_comments_are_skipped(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.chdir(tmp_path)
    zoo_line = shlex.join(ZOO + ["--save_appendix", "_b1"])
    fused_line = shlex.join(FUSED + ["--fold_parallel", "--save_appendix",
                                     "_b2"])
    (tmp_path / "runs.txt").write_text(
        "# a comment line\n\n" + zoo_line + "\n   \n" + fused_line + "\n")
    assert port_main.main(["--batch_file", "runs.txt"]) is None
    out = capsys.readouterr().out
    assert f"[batch] 1/2 (line 3): {zoo_line}" in out
    assert f"[batch] 2/2 (line 5): {fused_line}" in out
    assert "[batch] 2/2 experiments succeeded" in out
    # each run records its own line, not the batch's command line
    for appendix, line in (("_b1", zoo_line), ("_b2", fused_line)):
        cmd = (tmp_path / "results" / f"ADNI{appendix}" / "cmd_input.txt"
               ).read_text()
        assert cmd == "python -m iggcn_tpu_torch.main " + line + "\n"
    # and equals its standalone run
    port_main.main(ZOO + ["--save_appendix", "_s1"])
    port_main.main(FUSED + ["--fold_parallel", "--save_appendix", "_s2"])
    for a, b in (("_b1", "_s1"), ("_b2", "_s2")):
        got = _records(tmp_path / "results" / f"ADNI{a}")
        want = _records(tmp_path / "results" / f"ADNI{b}")
        assert got.keys() == want.keys() and got
        for name in got:
            for k in want[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k])


def test_a_failing_line_is_reported_and_the_batch_goes_on(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "runs.txt").write_text(
        "--device cpu --model BOGUS --save_appendix _x\n"
        + shlex.join(ZOO + ["--save_appendix", "_y"]) + "\n"
        + "--device cpu --synthetic 'unclosed\n")
    with pytest.raises(SystemExit) as info:
        port_main.main(["--batch_file", "runs.txt"])
    assert info.value.code == 1
    cap = capsys.readouterr()
    assert "[batch] 1/3 experiments succeeded" in cap.out
    assert "FAILED line 1 (exit 2): --device cpu --model BOGUS" in cap.err
    assert "[batch] line 3 does not tokenize" in cap.err
    assert "FAILED line 3 (shlex: No closing quotation)" in cap.err
    assert (tmp_path / "results" / "ADNI_y" / "log.txt").exists()
    assert not (tmp_path / "results" / "ADNI_x").exists()


@pytest.mark.parametrize("argv,content,message,code", [
    (["--batch_file", "runs.txt", "--epochs", "5"], "--synthetic\n",
     "self-contained", 2),
    (["--batch_file", "missing.txt"], None, "cannot read", 2),
    (["--batch_file", "runs.txt"], "# only comments\n\n", "no runnable lines",
     2),
    (["--batch_file", "runs.txt"], "--batch_file other.txt\n",
     "does not nest", 1),
    (["--batch_file=runs.txt"], "--batch_file=other.txt\n", "does not nest",
     1),
])
def test_the_file_and_the_command_line_are_checked_as_the_jax_cli_checks(
        tmp_path, monkeypatch, capsys, argv, content, message, code):
    monkeypatch.chdir(tmp_path)
    if content is not None:
        (tmp_path / "runs.txt").write_text(content)
    errors = []
    for run in (jax_main.main, port_main.main):
        with pytest.raises(SystemExit) as info:
            run(list(argv))
        assert info.value.code == code
        err = capsys.readouterr().err
        assert message in err
        errors.append(err.splitlines()[-1])
    if code == 2:               # the parser's own message, word for word
        assert errors[0] == errors[1]
    assert not (tmp_path / "results").exists()
