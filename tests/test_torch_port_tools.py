"""The port's tools held against the JAX package's, on the CPU:
`tools/profile_step.py` (its table) and the CLI's `--profile_dir` (a
torch.profiler trace), `tools/doctor.py` (the same findings, word for
word but for the package name, and the same exit code as the JAX doctor
on good and broken layouts), `tools/gen_docs.py` (`--check` passes on the
committed `docs/cli_torch.md` and fails on a stale copy), every flag of
the JAX CLIs in the port's, and the `auto` (native C++) and `device`
(batched solve) diffusion backends against the NumPy path: `auto` within
1e-12, `device` within 2e-5 (fp32), with the same sparsity, as
`tests/test_native.py` holds the JAX package's."""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import scipy.io as sio
import torch

import main as jax_main
from iggcn_tpu.data import diffusion as jax_diffusion
from iggcn_tpu.tools import doctor as jax_doctor
from iggcn_tpu.tools import (explain as jax_explain, export_cohort as jax_ec,
                             import_torch as jax_it, profile_step as jax_ps,
                             report as jax_report, serve as jax_serve)
from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.data import diffusion
from iggcn_tpu_torch.tools import (doctor, explain, export_cohort, gen_docs,
                                   import_torch, profile_step, report, serve)
from iggcn_tpu_torch.utils import cuda_build
from tests.test_real_loaders import _write_mat_cohort

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
GO_ARGS = ["--json_path", os.path.join(FIX, "go", "analysis.json"),
           "--go_connection_path", os.path.join(FIX, "go",
                                                "go_root_connection.txt"),
           "--snps_to_gene_path", os.path.join(FIX, "go", "snps_to_gene.txt")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def test_profile_step_prints_its_table_on_the_cpu(tmp_path, capsys):
    hist = profile_step.main(["--device", "cpu", "--batch", "4", "--steps",
                              "1", "--top", "5", "--out", str(tmp_path)])
    text = capsys.readouterr().out
    assert "host op self time (CPU run)" in text and "device=cpu" in text
    lines = text.splitlines()
    head = lines.index(f"{'us/step':>9} {'share':>6} {'count':>6}  name")
    assert len(lines[head + 1:lines.index("# category rollup")]) == 6
    assert any("aten::" in name for name in hist)
    assert "elementwise" in text.split("# category rollup")[1]
    with open(tmp_path / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]


def test_profile_dir_traces_a_cli_run(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    port_main.main(["--device", "cpu", "--synthetic", "--synthetic_subjects",
                    "24", "--epochs", "1", "--fold", "3", "--no-search",
                    "--layers", "1", "--hiddens", "4", "--batch_size", "8",
                    "--save_appendix", "_p", "--cohort_cache_dir", "",
                    "--profile_dir", str(tmp_path / "trace")])
    assert "[profile] torch.profiler trace ->" in capsys.readouterr().out
    with open(tmp_path / "trace" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::bmm" in names or "aten::matmul" in names


@pytest.mark.parametrize("jax_mod,port_mod", [
    (jax_main, port_main), (jax_doctor, doctor), (jax_serve, serve),
    (jax_explain, explain), (jax_ps, profile_step), (jax_report, report),
    (jax_ec, export_cohort), (jax_it, import_torch)])
def test_the_port_has_every_flag_of_the_jax_cli(jax_mod, port_mod):
    def flags(mod):
        return {s for a in mod.build_parser()._actions
                for s in a.option_strings}
    assert flags(jax_mod) - flags(port_mod) == set()


def test_gen_docs_check_passes_on_the_committed_reference(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    assert gen_docs.main(["--check"]) == 0
    text = gen_docs.render_cli_md()
    for flag in ("--profile_dir", "--bf16", "--plot", "--tu_name"):
        assert f"`{flag}`" in text
    stale = tmp_path / "cli_torch.md"
    stale.write_text(text.replace("--profile_dir", "--profile_dirs"))
    monkeypatch.setattr(gen_docs, "DOC_PATH", str(stale))
    assert gen_docs.main(["--check"]) == 1
    assert "stale" in capsys.readouterr().err
    assert gen_docs.main([]) == 0 and stale.read_text() == text


def _same_doctor(argv):
    got = _run(doctor.main, argv)
    want = _run(jax_doctor.main, argv)
    assert got[0] == want[0]
    assert got[1].replace("iggcn_tpu_torch.", "iggcn_tpu.") == want[1]
    return got


def _break(base, case):
    kdir = os.path.join(base, "knn", "5")
    if case == "missing":
        os.remove(os.path.join(kdir, "corr_data.mat"))
    elif case == "renamed":
        sio.savemat(os.path.join(kdir, "SNPS_data.mat"),
                    {"WRONG_NAME": np.zeros((4, 4))})
    elif case == "labels":
        sio.savemat(os.path.join(kdir, "BL_DXGrp_label.mat"),
                    {"BL_DXGrp_label": np.zeros((3, 1), int)})
    elif case == "cluster":
        shutil.rmtree(os.path.join(kdir, "center_2"))


@pytest.mark.parametrize("case,extra,code", [
    ("good", [], 0), ("missing", [], 1), ("renamed", [], 1),
    ("labels", [], 1), ("cluster", [], 1), ("good", ["--isMultiFusion"], 1),
    ("good", GO_ARGS, 1)])
def test_doctor_matches_the_jax_doctor_on_mat_layouts(tmp_path, case, extra,
                                                      code):
    base = str(tmp_path) + "/"
    _write_mat_cohort(base, np.random.default_rng(0))
    _break(base, case)
    got = _same_doctor(["--data_path", base, *extra])
    assert got[0] == code
    assert ("0 failure(s)" in got[1]) == (code == 0)


def test_doctor_matches_the_jax_doctor_on_go_tu_and_csv(tmp_path):
    assert _same_doctor(GO_ARGS)[0] == 0
    tu = tmp_path / "tu"
    shutil.copytree(os.path.join(FIX, "TUTEST"), tu / "TUTEST")
    code, text = _same_doctor(["--tu_root", str(tu), "--tu_name", "TUTEST"])
    assert code == 0 and "TUTEST:" in text
    os.remove(tu / "TUTEST" / "TUTEST_graph_labels.txt")
    assert _same_doctor(["--tu_root", str(tu), "--tu_name", "TUTEST"])[0] == 1
    base = tmp_path / "data_AH"
    base.mkdir()
    (base / "snp.csv").write_text("a,b\n1,2\n0,1\n2,0\n")
    (base / "dia.csv").write_text("dia\n0\n1\n1\n")
    assert _same_doctor(["--snps_csv_root", str(tmp_path)])[0] == 0
    (base / "dia.csv").write_text("dia\n0\n2\n1\n")
    assert _same_doctor(["--snps_csv_root", str(tmp_path)])[0] == 1
    with pytest.raises(SystemExit):
        doctor.main([])


def _adjs(seed, shape):
    return np.abs(np.random.default_rng(seed).normal(size=shape)) + 0.1


@pytest.mark.parametrize("b,n,k", [(16, 90, 3), (4, 30, 5), (2, 5, 99)])
def test_auto_backend_matches_numpy(b, n, k):
    adjs = _adjs(b, (b, n, n))
    got = diffusion.preprocess_diffusion(adjs, top_k=k)     # auto
    want = diffusion.preprocess_diffusion(adjs, top_k=min(k, n),
                                          backend="numpy")
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert ((got > 0) == (want > 0)).all()
    np.testing.assert_array_equal(
        got, jax_diffusion.gdc_native.ppr_topk_batch(adjs, 0.05, k))


def test_device_backend_matches_numpy_and_jax():
    adjs = _adjs(4, (4, 30, 30))
    got = diffusion.preprocess_diffusion(adjs, top_k=3, backend="device",
                                         device="cpu")
    want = diffusion.preprocess_diffusion(adjs, top_k=3, backend="numpy")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert ((got > 0) == (want > 0)).all()
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    jax_dev = jax_diffusion.preprocess_diffusion(adjs, top_k=3,
                                                 backend="device")
    np.testing.assert_allclose(got, jax_dev, atol=2e-5)
    with pytest.raises(ValueError, match="PPR\\+top-k"):
        diffusion.preprocess_diffusion(adjs, is_topk=False, backend="device")
    # `auto` runs numpy for the modes other than PPR + top-k, as JAX's does
    for modes in ({"is_topk": False}, {"is_ppr": False}):
        np.testing.assert_array_equal(
            diffusion.preprocess_diffusion(adjs, top_k=3, **modes),
            diffusion.preprocess_diffusion(adjs, top_k=3, backend="numpy",
                                           **modes))
    with pytest.raises(ValueError, match="unknown diffusion backend"):
        diffusion.preprocess_diffusion(adjs, backend="gpu")


def test_auto_backend_raises_when_it_cannot_build(monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    monkeypatch.setattr(cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="host compiler"):
        diffusion.preprocess_diffusion(_adjs(0, (1, 6, 6)), backend="auto")


def test_auto_backend_builds_serial_where_the_compiler_has_no_openmp(
        tmp_path, monkeypatch):
    """A host compiler without OpenMP's runtime (the card host's has no
    libgomp) builds the library without it: the same results, serial."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
                   "{ echo \"fatal error: cannot read spec file "
                   "'libgomp.spec'\" >&2; exit 1; }; done\n"
                   f"exec {shutil.which('g++')} \"$@\"\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(cuda_build, "_libs", {})
    adjs = _adjs(5, (3, 20, 20))
    np.testing.assert_allclose(
        diffusion.preprocess_diffusion(adjs, backend="auto"),
        diffusion.preprocess_diffusion(adjs, backend="numpy"), atol=1e-12)
    log = cuda_build.BUILD_LOGS["gdc_native.cpp"]
    assert "-fopenmp: exit 1" in log and "-shared: exit 0" in log
