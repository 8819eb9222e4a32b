"""The port's GO parser (`iggcn_tpu_torch/data/go_graph.py:parse_go_json`
and its steps) and scraper helpers (`data/go_scraper.py`) against the JAX
package's: the hand-derived goldens of the committed PANTHER fixture
(`tests/test_golden_go_parser.py`), and the same topology as the JAX
parser, field for field and exactly, on that fixture, on the CLI test's
fixture and on the generator `chip_smoke.py` writes for the card (at a
small size here, so the card's inputs are validated on the CPU too)."""
import os

import numpy as np
import pytest

import chip_smoke
from iggcn_tpu.data import go_graph as jax_go
from iggcn_tpu.data import go_scraper as jax_scraper
from iggcn_tpu_torch.data import go_graph, go_scraper
from tests import test_golden_go_parser as golden
from tests.test_cli_real_data import _write_go_fixture

FIELDS = ("adj_child_parent", "go_snps", "pool", "n_l", "go_level",
          "go_ids", "go_genes")


def _sources(kind, tmp_path):
    if kind == "committed":
        return tuple(os.path.join(golden.FIX, name) for name in (
            "analysis.json", "go_root_connection.txt", "snps_to_gene.txt"))
    if kind == "cli":
        return _write_go_fixture(tmp_path)
    sizes = {"chip_smoke small": (12, 8, 5, 3, 1),
             "chip_smoke real scale": chip_smoke.REAL_GO_LEVELS}[kind]
    return chip_smoke.write_go_sources(str(tmp_path), np.random.default_rng(4),
                                       level_sizes=sizes)


def _assert_same_topology(got, want):
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field


def test_parser_goldens():
    topo = go_graph.parse_go_json(*_sources("committed", None))
    assert topo.go_ids == golden.EXPECTED_IDS
    np.testing.assert_array_equal(topo.go_level,
                                  np.asarray(golden.EXPECTED_LEVELS, float))
    assert topo.pool == golden.EXPECTED_POOL and topo.n_l == 4
    rows, cols = np.nonzero(topo.adj_child_parent)
    assert set(zip(rows.tolist(), cols.tolist())) == golden.EXPECTED_EDGES
    assert topo.go_genes == [["G6"], ["G3"], ["G4"], [], ["G1"],
                             ["G1", "G5"], [], [], []]
    expected_inc = np.zeros((9, 3))
    expected_inc[[4, 5, 1, 0, 5], [0, 0, 1, 2, 2]] = 1
    expected_inc[8, :] = 1
    np.testing.assert_array_equal(topo.go_snps, expected_inc)


@pytest.mark.parametrize("kind", ["committed", "cli", "chip_smoke small",
                                  "chip_smoke real scale"])
def test_parse_go_json_matches_jax(tmp_path, kind):
    paths = _sources(kind, tmp_path)
    got = go_graph.parse_go_json(*paths)
    _assert_same_topology(got, jax_go.parse_go_json(*paths))
    if kind.startswith("chip_smoke"):
        sizes = (chip_smoke.REAL_GO_LEVELS if kind.endswith("scale")
                 else (12, 8, 5, 3, 1))
        # the generator's promise: five levels of exactly these sizes
        assert got.pool == list(sizes) and got.num_snps == 54
        assert got.go_snps[:-1].any() and got.go_snps[-1].all()


def test_parser_steps_match_jax(tmp_path):
    """Each step on its own: both passes, the root-connection merge, the
    BFS levels and the incidence."""
    import json
    jp, cp, sg = _sources("chip_smoke small", tmp_path)
    with open(jp) as fh:
        data = json.load(fh)
    first = go_graph._parse_pass(data)
    assert first == jax_go._parse_pass(data)
    keep = set(first[-1])
    second = go_graph._parse_pass(data, keep_ids=keep)
    assert second == jax_go._parse_pass(data, keep_ids=keep)
    ids, genes, rows, cols, _ = second
    got_ids, got_adj = go_graph.merge_root_connections(cp, list(ids),
                                                       list(rows), list(cols))
    want_ids, want_adj = jax_go.merge_root_connections(cp, list(ids),
                                                       list(rows), list(cols))
    assert got_ids == want_ids
    np.testing.assert_array_equal(got_adj, want_adj)
    root = got_ids.index(go_graph.ROOT_GO_ID)
    np.testing.assert_array_equal(go_graph.bfs_levels(got_adj, root),
                                  jax_go.bfs_levels(want_adj, root))
    np.testing.assert_array_equal(
        go_graph.build_go_gene_snps(genes, 0, sg),
        jax_go.build_go_gene_snps(genes, 0, sg))


def test_unreachable_terms_raise_as_in_jax(tmp_path):
    jp, cp, sg = _sources("cli", tmp_path)
    with open(cp) as fh:
        first_chain = fh.readline()
    with open(cp, "w") as fh:
        fh.write(first_chain)          # drop the chain that reaches GO:4, 5
    for parse in (go_graph.parse_go_json, jax_go.parse_go_json):
        with pytest.raises(ValueError, match="unreachable"):
            parse(jp, cp, sg)


def test_scraper_matches_jax(tmp_path):
    ids = tmp_path / "ids.txt"
    ids.write_text("GO:0000001\n\nGO:0000002\n")
    assert go_scraper.read_go_ids(str(ids)) == jax_scraper.read_go_ids(
        str(ids))

    def fetch(url):
        return [url[-7:] + ".1", url[-7:] + ".2"]

    written = {}
    for side, mod in (("port", go_scraper), ("jax", jax_scraper)):
        out = tmp_path / f"{side}.txt"
        got = mod.fetch_go_root_connections(str(ids), str(out), fetch=fetch,
                                            delay_s=0)
        written[side] = (got, out.read_text())
    assert written["port"] == written["jax"]
    assert written["port"][0] == ["0000001.1", "0000001.2", "0000002.1",
                                  "0000002.2"]
