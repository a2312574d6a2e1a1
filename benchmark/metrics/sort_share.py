"""sort_share: the share of query_busy_ms spent in sort kernels, %.

A sort kernel is one whose name holds "sort" in any case: CUB's radix
sort passes (DeviceRadixSort*, DeviceSegmentedRadixSort*) and PyTorch's
own sort kernels (radixSortKVInPlace, bitonicSortKVInPlace, ...).
"""

from benchmark import tracing


def is_sort(name: str) -> bool:
    return "sort" in name.lower()


def read(record):
    busy = tracing.busy_ms(record, "query")
    if not busy:
        return None
    n, ms = tracing.kernel_ms(record, "query", is_sort)
    if not n:
        return None
    return 100.0 * ms / busy
