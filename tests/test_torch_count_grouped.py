"""Port parity, grouped partitioned counting: count_reads_to_host with
JT_COUNT_PARTITIONS=4 in 1, 2 and 4 passes (JT_COUNT_GROUPS) gives records,
host table bytes and device table bytes equal to jasper_tpu's on the same
settings and to the port's classic branch, exactly, at k=15, 25 and 37."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import pytest

from tests.test_torch_count import KS
from tests.test_torch_count_branches import check_branch, classic  # noqa: F401


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("G", [1, 2, 4])
def test_grouped_matches(classic, monkeypatch, G, k):  # noqa: F811
    env = {"JT_COUNT_PARTITIONS": "4"}
    if G > 1:
        env["JT_COUNT_GROUPS"] = str(G)
    logs = check_branch(classic, monkeypatch, k, env, f"count: pass {G}/{G} counted")
    assert sum(m.endswith(f"resident lanes, {4 // G} ladders)") for m in logs) == G
