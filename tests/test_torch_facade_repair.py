"""The checks of tests/test_torch_facade.py (the port's ShardedBrisk on
the CPU against brisk_tpu's on the 8-device CPU mesh, exact) on the
repair fixture of tests/test_torch_api.py at k=31 and k=63: windows that
need exact repairs, and, at a reduced skl_row_cap, lanes whose rows
overflow their row budget — the facade's repair route (_rerun_runs,
_rebuild_overflow_rows, _deliver_skl_rows)."""

import pytest

from tests.test_torch_facade import (  # noqa: F401  (collected here too)
    GEO31, K31, K63, build, mesh, test_arenas_and_counters,
    test_counts_stats_and_gets, test_kff_readback,
    test_npz_both_ways_and_reallocate, test_query_file)

SCENARIOS = {
    "repair31": (None, K31, GEO31, 8),
    "repair63": (None, K63, dict(batch_per_shard=4, window=64, stack=2),
                 16),
}


@pytest.fixture(scope="module", params=list(SCENARIOS))
def built(request, mesh, tmp_path_factory):
    name = request.param
    return build(name, SCENARIOS[name], mesh, tmp_path_factory.mktemp(name))
