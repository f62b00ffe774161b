"""The control of a cell's correctness check, on the card: the run with the
program's float32 fitness replaced by its own bfloat16 walk (GA cells:
Objective precision "bf16", K1-bf16), or with the reference computed in
bfloat16 put in the program's place (Adam cells). Each seed prints one
line of the numbers compared; every line has to come out not correct.
With `--fault NAME` the sound program runs with that fault of
portbench/faults.py planted in its timed path instead.

    python3 -m portbench.control --workload ga512-p32 --seconds 2 --seeds 5 6 7
    python3 -m portbench.control --workload adam1024-n10k --fault half-rows --seeds 5 6 7
"""
import argparse
import json
import sys

from . import cell as cell_mod
from .faults import FAULTS
from .run import run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    cell = cell_mod.load(args.workload)
    import pytest

    for seed in args.seeds:
        with pytest.MonkeyPatch.context() as mp:
            if args.fault:
                FAULTS[cell.traffic["driver"]][args.fault](mp)
            out = run_cell(cell, seed, args.seconds, False, "cuda", control=not args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "bf16", "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
