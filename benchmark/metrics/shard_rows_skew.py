"""shard_rows_skew: how unevenly the index's rows lie over its shards:
the most rows a shard holds over the mean over shards
(ShardedBrisk.stats()["shard_entries"], finalized super-k-mer rows,
read outside the window); 1 is even. None for a program that does not
report it."""


def read(record):
    rows = record.get("shard_entries")
    if not rows or not sum(rows):
        return None
    return max(rows) * len(rows) / sum(rows)
