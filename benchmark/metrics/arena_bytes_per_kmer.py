"""arena_bytes_per_kmer: the program's own count of resident index bytes
per distinct k-mer (Brisk.stats()["bytes_per_kmer"]: rows in use, not
allocated capacity), after the last job, outside the window."""


def read(record):
    v = record.get("arena_bytes_per_kmer")
    return v if v else None
