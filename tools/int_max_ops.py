#!/usr/bin/env python3
"""Do torch.sort, torch.where and torch.sum on a CUDA card give the right
answer on tensors of more than 2**31 - 1 elements?

    python3 tools/int_max_ops.py [--rows 429600] [--cols 5000]

The dense binning (render_cuda.bin_splats_dense) runs these three on
[B, T, N_pass] tensors; at B = 4096, 128 tiles and 5,000-splat passes (the
flagship's unchunked batch) that is 2.6e9 elements. Here the same ops run
on an int32 [rows, cols] tensor x[r, j] = (7919 j + r) mod cols, each row a
permutation of 0..cols-1 (7919 is prime to 5,000), so every answer is
known: the sorted row is 0..cols-1 and its indices invert the permutation;
the mask x < r mod (cols + 1) keeps r mod (cols + 1) (at most cols) entries
of row r, which torch.where and the row sums must count, and the full sum
must total. The defaults give 2,148,000,000 elements, above 2**31 - 1 =
2,147,483,647; the checks read the rows in slices. Each op is reported as
"right", "wrong" (with the first bad row) or the exception it raised, on
one JSON line beside the card's name and power limit; the exit code is 0
only when all four are right, 1 when any is wrong or raised. Needs a card; the
sort's input, values, int64 indices and scratch peaked at 77.3 GB on an
NVIDIA H100 80GB HBM3 (700 W) at the defaults.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SLICE = 1 << 14  # rows checked at once


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows", type=int, default=429_600)
    ap.add_argument("--cols", type=int, default=5_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int_max_ops: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    R, L = args.rows, args.cols
    dev = torch.device("cuda")
    out = {"card": card, "torch": torch.__version__, "rows": R, "cols": L, "elements": R * L,
           "int_max": 2 ** 31 - 1}
    col = torch.arange(L, dtype=torch.int32, device=dev)
    row = torch.arange(R, dtype=torch.int32, device=dev)

    def build():
        return torch.remainder(col[None, :] * 7919 + row[:, None], L)

    def keep_count(r):  # entries of row r below r mod (L + 1)
        return torch.clamp_max(torch.remainder(r, L + 1), L)

    def first_bad(check) -> int | None:
        for lo in range(0, R, SLICE):
            hi = min(R, lo + SLICE)
            ok = check(lo, hi)
            if not bool(ok.all()):
                return lo + int(torch.nonzero(~ok)[0, 0])
        return None

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            bad = fn()
            res = {"result": "right" if bad is None else "wrong", "first_bad_row": bad}
        except Exception as e:  # the answer here is what the op does, raise included
            res = {"result": "raised", "error": f"{type(e).__name__}: {str(e)[:300]}"}
        res["seconds"] = time.perf_counter() - t0
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[name] = res
        print(f"{name}: {res}", flush=True)

    def sort():
        x = build()
        v, i = torch.sort(x, dim=-1)
        bad_v = first_bad(lambda lo, hi: v[lo:hi] == col[None, :])
        if bad_v is not None:
            return bad_v
        x = build()  # a fresh copy: sort may not have kept its input
        return first_bad(lambda lo, hi: torch.gather(x[lo:hi], 1, i[lo:hi].long())
                         == col[None, :])

    def where():
        x = build()
        keep = x < torch.remainder(row, L + 1)[:, None]
        w = torch.where(keep, x, torch.full((), L, dtype=torch.int32, device=dev))
        del x, keep
        return first_bad(lambda lo, hi: torch.sum(w[lo:hi] != L, dim=-1)
                         == keep_count(row[lo:hi]))

    def row_sum():
        keep = build() < torch.remainder(row, L + 1)[:, None]
        s = torch.sum(keep, dim=-1, dtype=torch.int32)
        return first_bad(lambda lo, hi: s[lo:hi] == keep_count(row[lo:hi]))

    def full_sum():
        keep = build() < torch.remainder(row, L + 1)[:, None]
        total = int(torch.sum(keep))
        want = int(torch.sum(keep_count(row).long()))
        return None if total == want else -1

    ops = {"sort": sort, "where": where, "sum_rows": row_sum, "sum_all": full_sum}
    for name, fn in ops.items():
        run(name, fn)
    print("INT_MAX_OPS " + json.dumps(out), flush=True)
    return 0 if all(out[name]["result"] == "right" for name in ops) else 1


if __name__ == "__main__":
    sys.exit(main())
