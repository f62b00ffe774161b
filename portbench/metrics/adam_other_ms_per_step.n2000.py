"""Device milliseconds an Adam step on the fused route outside K7 (with its
sums) and the dense binning's integer sorts (by the kernel table): the
step's small kernels, copies and fills. None in a GA record and where no K7
ran (the chained Adam cell, read by adam_other_ms_per_step)."""

SKIP = ("K7", "K6-K7-sums", "sort.int")  # kernels.json's names


def read(rec):
    t = rec.trace
    if rec.kind != "adam" or t is None or t["by_kernel"].get("K7", 0.0) <= 0.0:
        return None
    return 1e3 * sum(v for k, v in t["by_kernel"].items() if k not in SKIP) / t["units"]
