"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m portbench.run --workload ga512-p32 --seed 7 --seconds 10 --trace 0

from the root of a checkout. The cell, its configuration and traffic, its
correctness limits and its metrics are found by name from BENCHMARK.json
(portbench/cell.py). `--trace 0` times the window and reports the cell's
end-to-end metrics; `--trace 1` profiles a few blocks and reports its
per-layer metrics. Either way the run checks what the timed path produced
against the plain reference (portbench/reference.py), prints each number
compared beside its limit as the last lines of standard error and under
"checks", the last key of the result, and prints the result as the last
line of standard output.

A cell's traffic names its driver, `portbench/drivers/<driver>.py`,
found by that name (`driver`); the contract that a driver keeps is in
portbench/drivers/__init__.py. A traced result also carries "spans", the
device time of each of the program's span paths (portbench/spans.py).

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is present, and 3 when a module of JAX or of the JAX package was
loaded; the program under test is ggs_tpu_torch alone.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ggs_tpu")


def forbidden(module_names) -> list:
    """The top-level names among module_names that belong to JAX or to the
    JAX package, compared whole (ggs_tpu_torch is not ggs_tpu)."""
    return sorted({n.split(".")[0] for n in module_names} & set(FORBIDDEN))


def driver(name: str):
    """The driver module portbench/drivers/<name>.py, imported by its name."""
    path = f"portbench/drivers/{name}.py"
    if not name.isidentifier():
        raise ValueError(f"driver {name!r} is not a Python identifier, so {path} "
                         "cannot be imported")
    module = f"portbench.drivers.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise  # the driver exists and an import inside it failed
        raise ModuleNotFoundError(f"no driver {name!r}: {path} not found", name=module) from e


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, t_start: float = None) -> dict:
    """One run of `cell` -> the result object (without printing it): the
    traffic's driver runs the cell and returns its record, checks, device
    and the units attempted; each of the cell's metrics (end-to-end, or
    per-layer with `trace`) is read from the record by its reader."""
    from . import cell as cell_mod
    from . import spans

    rec, checks, dev_info, attempted = driver(cell.traffic["driver"]).run(
        cell, seed, seconds, trace, device, control, t_start)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell_mod.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(c["value"] > c["limit"] for c in checks)
    out = {"correct": failed == 0, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if trace and rec.trace is not None:
        out["device"]["busy_s"] = rec.trace["busy_s"]
        out["device"]["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
        out["trace_sessions"] = {k: rec.trace[k] for k in ("attempts", "settled", "op_counts")}
        out["spans"] = spans.result(rec.trace)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import cell as cell_mod

    cell = cell_mod.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.chips} CUDA card(s) needed, "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed % 2**63, args.seconds, bool(args.trace), "cuda",
                   t_start=T_START)
    bad = forbidden(sys.modules)
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
