"""Faults planted in the timed path, for the check that has to see them:
each takes a pytest MonkeyPatch (`setattr`) and breaks the program under
it. The CPU tests plant each of them (portbench/tests/
test_portbench_faults.py); `python3 -m portbench.control --fault NAME`
reads one on the card at a cell's own size."""
import torch


def ga_state_unchanged(mp):
    """ga.step returns the state it was given."""
    from ggs_tpu_torch.models import ga

    def frozen(state, *a, **k):
        f = state.fits
        return state, torch.stack([state.best_fit, f.mean(), f.median(), f[0] * 0])

    mp.setattr(ga, "step", frozen)


def ga_half_batch(mp):
    """objective.evaluate scores the first half of the batch and gives the
    rest their mean."""
    from ggs_tpu_torch.ops import objective

    real = objective.evaluate

    def half(obj, g, *a, **k):
        h = max(1, g.shape[0] // 2)
        f = real(obj, g[:h], *a, **k)
        return torch.cat([f, f.mean().expand(g.shape[0] - h)])

    mp.setattr(objective, "evaluate", half)


def ga_answer_altered(mp):
    """objective.evaluate's fits come out 0.1% high."""
    from ggs_tpu_torch.ops import objective

    real = objective.evaluate
    mp.setattr(objective, "evaluate", lambda *a, **k: real(*a, **k) * (1 + 1e-3))


def adam_state_unchanged(mp):
    """An Adam step returns the genome it was given."""
    from ggs_tpu_torch.models import gradient

    real = gradient.make_fit_step

    def make(obj, gnm, cfg):
        make_opt, step = real(obj, gnm, cfg)

        def frozen(state, target, wm, blur_sigma=None):
            g0 = state.g.detach().clone()
            st, fits = step(state, target, wm, blur_sigma)
            with torch.no_grad():
                st.g.copy_(g0)
            return st, fits

        return make_opt, frozen

    mp.setattr(gradient, "make_fit_step", make)


def _adam_graphed_block(mp, keys):
    """Wraps make_run_block: a graphed call of more than one step (the
    window's block) sets `keys` of the Adam state back to what it was
    given; the eager block is left sound."""
    from ggs_tpu_torch.models import gradient

    real = gradient.make_run_block

    def make(obj, gnm, cfg):
        rb = real(obj, gnm, cfg)
        graphed = rb.graphed

        def broken(state, target, wm, n, blur_sigma=None):
            if n == 1 or state.g not in state.opt.state:
                return graphed(state, target, wm, n, blur_sigma)
            keep = {k: v.clone() for k, v in gradient._adam_tensors(state).items() if k in keys}
            st, fits = graphed(state, target, wm, n, blur_sigma)
            for k, v in gradient._adam_tensors(st).items():
                if k in keys:
                    v.copy_(keep[k])
            return st, fits

        rb.graphed = broken
        return rb

    mp.setattr(gradient, "make_run_block", make)


def adam_block_state_unchanged(mp):
    """The window's graphed block returns the genome, moments and step
    count it was given."""
    _adam_graphed_block(mp, ("g", "exp_avg", "exp_avg_sq", "step"))


def adam_block_stale_count(mp):
    """The window's graphed block does not advance Adam's step count, so
    every later block takes stale bias corrections."""
    _adam_graphed_block(mp, ("step",))


def adam_half_rows(mp):
    """The energy (and so the gradient) of one genome, the batch of one,
    taken over the top half of the canvas."""
    from ggs_tpu_torch.ops import objective

    real = objective.image_energy

    def half(obj, imgs, target, wm=None):
        h = imgs.shape[1] // 2
        return real(obj, imgs[:, :h], target[:h], None if wm is None else wm[:h])

    mp.setattr(objective, "image_energy", half)


def adam_answer_altered(mp):
    """The energy, and so its gradient, 0.1% high."""
    from ggs_tpu_torch.ops import objective

    real = objective.image_energy
    mp.setattr(objective, "image_energy", lambda *a, **k: real(*a, **k) * (1 + 1e-3))


FAULTS = {
    "ga": {"state-unchanged": ga_state_unchanged, "half-batch": ga_half_batch,
           "answer-altered": ga_answer_altered},
    "adam": {"state-unchanged": adam_state_unchanged, "half-rows": adam_half_rows,
             "answer-altered": adam_answer_altered,
             "block-state-unchanged": adam_block_state_unchanged,
             "block-stale-count": adam_block_stale_count},
}
