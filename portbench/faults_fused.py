"""The Adam faults `half-rows` and `answer-altered` of portbench/faults.py,
planted where the fused route computes the energy and its gradient
(render_grad.fused_value_and_grad, one K7 launch a step). Those of
faults.py patch objective.image_energy, which only the chained route
(above render_cuda.MAX_SPLATS splats) calls, so in a cell on the fused
route (adam512-n2000) they leave the program sound. Each seed prints one
line of the numbers compared, as portbench.control does; every line has to
come out not correct.

    python3 -m portbench.faults_fused --workload adam512-n2000 --fault half-rows --seeds 5 6 7
"""
import argparse
import json
import sys


def fused_answer_altered(mp):
    """The fused route's energies and gradients 0.1% high."""
    from ggs_tpu_torch.ops import render_grad

    real = render_grad.fused_value_and_grad

    def altered(*a, **k):
        (loss, fits), grads = real(*a, **k)
        return (loss * (1 + 1e-3), fits * (1 + 1e-3)), grads * (1 + 1e-3)

    mp.setattr(render_grad, "fused_value_and_grad", altered)


def fused_half_rows(mp):
    """The fused route's energy, and so its gradient, taken over the top
    half of the canvas: the weight mask is zero on the bottom half."""
    from ggs_tpu_torch.ops import render_grad

    real = render_grad.fused_value_and_grad

    def half(g, target, wm, *a, **k):
        top = wm.clone()
        top[top.shape[0] // 2:] = 0.0
        return real(g, target, top, *a, **k)

    mp.setattr(render_grad, "fused_value_and_grad", half)


FUSED_FAULTS = {"half-rows": fused_half_rows, "answer-altered": fused_answer_altered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FUSED_FAULTS))
    args = p.parse_args(argv)
    import pytest

    from . import cell as cell_mod
    from .run import run_cell

    cell = cell_mod.load(args.workload)
    for seed in args.seeds:
        with pytest.MonkeyPatch.context() as mp:
            FUSED_FAULTS[args.fault](mp)
            out = run_cell(cell, seed, args.seconds, False, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "fused-" + args.fault, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
