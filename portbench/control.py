"""The control of a cell's correctness check, on the card: the run with the
program's float32 fitness replaced by its own bfloat16 walk (GA cells:
Objective precision "bf16", K1-bf16), or with the reference computed in
bfloat16 put in the program's place (Adam cells). Each seed prints one
line of the numbers compared; every line has to come out not correct.
With `--fault NAME` the sound program runs with that fault planted in its
timed path instead: one of portbench/faults.py's FAULTS under the cell's
driver or, for a driver that brings its own, of its module's FAULTS.

    python3 -m portbench.control --workload ga512-p32 --seconds 2 --seeds 5 6 7
    python3 -m portbench.control --workload adam1024-n10k --fault half-rows --seeds 5 6 7
"""
import argparse
import json
import sys

from . import cell as cell_mod
from .faults import FAULTS
from .run import driver, run_cell


def faults_of(name: str) -> dict:
    """Fault name -> planting function, for the driver `name`: faults.py's
    FAULTS[name] where it has that entry, else the FAULTS dict of the
    driver's own module (none where it has no such dict)."""
    if name in FAULTS:
        return FAULTS[name]
    return getattr(driver(name), "FAULTS", {})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    cell = cell_mod.load(args.workload)
    faults = faults_of(cell.traffic["driver"])
    if args.fault and args.fault not in faults:
        p.error(f"no fault {args.fault!r} for the driver {cell.traffic['driver']!r}; "
                f"it knows: {', '.join(sorted(faults)) or 'none'}")
    import pytest

    for seed in args.seeds:
        with pytest.MonkeyPatch.context() as mp:
            if args.fault:
                faults[args.fault](mp)
            out = run_cell(cell, seed, args.seconds, False, "cuda", control=not args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "bf16", "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
