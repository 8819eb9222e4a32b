"""GO root-connection scraper, a one-off offline tool (port of
`iggcn_tpu/data/go_scraper.py`).

Re-design of `snps_get_root_go_by_html.py:7-40`: crawl the CTD GO detail
pages for each GO term and record its ancestry chains ("tree paths") into
`go_root_connection.txt` — the file the GO graph builder merges into the
DAG (`iggcn_tpu_torch/data/go_graph.py:merge_root_connections`, parity
`snps_get_root_go_by_html.py:65-97`).

Network access is a one-time offline step on a workstation; the training
environment never needs it. The fetch function is injectable so formatting
and file layout are unit-testable without egress.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional

CTD_LINK_PREFIX = "https://ctdbase.org/detail.go?type=go&acc=GO%3A"


def read_go_ids(id_path: str) -> List[str]:
    """GO ids file -> CTD detail URLs (parity `:13-20`)."""
    with open(id_path) as fh:
        return [CTD_LINK_PREFIX + line.strip().replace("GO:", "")
                for line in fh if line.strip()]


def _default_fetch(url: str) -> List[str]:  # pragma: no cover - needs net
    """Fetch one CTD page and extract the tree-path row ids
    (parity `:26-39`: rows of class gridrow1..4, id 'treeALL.<path>')."""
    import requests
    from bs4 import BeautifulSoup

    # bounded: one hung CTD page must not stall the whole crawl forever
    r = requests.get(url, timeout=60)
    soup = BeautifulSoup(r.content, "html.parser")
    out = []
    for row_index in range(1, 5):
        rows = soup.findAll("tr", {"class": f"gridrow{row_index}"})
        if len(rows) <= 0:
            break
        for para in rows:
            result = para.attrs["id"]
            result = result.replace("treeALL.", "").replace("GO", "")
            out.append(result)
    return out


def save_connections(items: Iterable[str], connection_path: str) -> None:
    """One tree path per line (parity `:7-11`)."""
    with open(connection_path, "w") as fh:
        for item in items:
            fh.write(item + "\n")


def fetch_go_root_connections(id_path: str, connection_path: str, *,
                              fetch: Optional[Callable[[str], List[str]]] = None,
                              delay_s: float = 30.0) -> List[str]:
    """Crawl every GO id's CTD page and write `go_root_connection.txt`.

    `fetch` defaults to the live requests/bs4 fetcher; inject a stub for
    tests or cached pages. `delay_s` is the politeness delay between pages
    (parity `:27`).
    """
    if fetch is None:
        fetch = _default_fetch
    all_result: List[str] = []
    for i, link in enumerate(read_go_ids(id_path)):
        if i and delay_s:
            time.sleep(delay_s)
        all_result.extend(fetch(link))
    save_connections(all_result, connection_path)
    return all_result
