"""enum_roofline: the enumerator's five kernels (positions, rescan,
state_scan, emit, skl_rows) inside the traced job's `insert_file` span,
their least time over their measured time, % (NVIDIA H100 SXM peaks at
700 W: 3.35 TB/s, 17e12 float64 additions/s).

The least time is benchmark/roofline.py's model at the configuration's
`enum_geometry`, per batch (one state_scan launch per batch), plus the
row assembly's bytes from the job's own k-mers and super-k-mers. None
when the span launched none of these kernels.
"""

import re

from benchmark import roofline, tracing

_NAME = re.compile(r"\b(" + "|".join(roofline.KERNELS) + r")_kernel\b")


def read(record):
    cfg = record.get("config")
    if cfg is None or "enum_geometry" not in cfg:
        return None
    per = {}
    for kern in roofline.KERNELS:
        per[kern] = tracing.kernel_ms(
            record, "insert",
            lambda n, kern=kern: (_NAME.search(n) or [None, None])[1] == kern)
    batches = per["state_scan"][0]
    measured_ms = sum(ms for _, ms in per.values())
    if not batches or not measured_ms:
        return None
    p = cfg["params"]
    least = roofline.batch_least_s(p["k"], p["m"], cfg["enum_geometry"])
    job = record["job"]
    least_s = (batches * sum(least.values())
               + roofline.rows_least_s(job["n_emitted"],
                                       job["n_superkmers"]))
    return 100.0 * least_s * 1e3 / measured_ms
