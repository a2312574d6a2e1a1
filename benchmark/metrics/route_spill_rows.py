"""route_spill_rows: super-k-mer rows that the route could not send to
their owner shard (past a destination's capacity, skl_route_cap) and
that stayed on their source shard, in the job's index:
ShardedBrisk.stats()["n_spilled"], read outside the window. None for a
program that does not report it."""


def read(record):
    return record.get("n_spilled")
