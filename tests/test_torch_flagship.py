"""The flagship's structure at a small size: the port's chunked, multi-pass
evaluate, its row-slab partials and a chunked GA generation, against the
JAX package and against the port's own unchunked paths. The counterpart of
tests/test_flagship_aot.py:94-128 (BASELINE.json's multi-host config, pop
4096, 10,000 splats, 1024x1024, scored in chunks and in 512-row slabs),
cut to B=5 candidates of N=20 splats on a 32x128 canvas, with the pass
size lowered to 7 splats in both packages (render_pallas._MAX_SMEM_SPLATS
and render_cuda.MAX_SPLATS), as tests/test_torch_chunked.py does, so each
candidate runs three chained passes as a flagship candidate runs two. On
the CPU the port's wrappers take their plain versions; the JAX side runs
its Pallas kernels in interpret mode.

Tolerances, with their sources:
* fitness across packages: rtol 5e-5 (tests/test_render_pallas.py:140);
* the slab partials summed against the whole fitness x denominator:
  rtol 1e-6, atol 1e-7 (tests/test_sharding.py:142);
* the port chunked against unchunked, and a chunked GA generation against
  an unchunked one on the same draws: bit for bit (each candidate's walk
  and sum do not depend on the batch it is scored in)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggs_tpu.ops import objective as jobjective
from ggs_tpu.ops import render_pallas as rp
from ggs_tpu_torch import run_ga
from ggs_tpu_torch.config import GAConfig, GenomeConfig, MutSigma
from ggs_tpu_torch.models import ga as tga
from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import fitness as tfitness
from ggs_tpu_torch.ops import objective as tobjective
from ggs_tpu_torch.ops import render_cuda as rc
from torch_inputs import axes_genomes, image, weights
from torch_inputs import chained, one_torch_thread  # noqa: F401 (fixtures)

H, W = 32, 128
B, N, CHUNK = 5, 20, 2  # three chunks, the last padded; three passes of 6, 7 and 7
HS = H // 2  # two slabs, as the flagship's tile axis of 2 cuts 1024 rows into 512
G = axes_genomes(41, B, N, H, W)
TGT, WM = image(42, H, W), weights(43, H, W)
TIERS = [("exact-tight", None), ("fast", 8e-2)]  # run_ga's default and the fast flagship


def _tobj(precision, eps, chunk=CHUNK):
    return tobjective.Objective(H=H, W=W, chunk=chunk, precision=precision, cull_eps=eps)


def _evaluate(precision, eps, chunk=CHUNK, g=G):
    return tobjective.evaluate(_tobj(precision, eps, chunk), g, TGT, WM, device="cpu")


@pytest.mark.parametrize("precision,eps", TIERS, ids=[t[0] for t in TIERS])
def test_chunked_multipass_evaluate_matches_jax(chained, precision, eps):
    """evaluate with a chunk that does not divide B (the padding path) and
    three chained passes a candidate, against JAX's evaluate with the same
    chunk on its Pallas path."""
    jobj = jobjective.Objective(H=H, W=W, impl="pallas", interpret=True, chunk=CHUNK,
                                precision=precision, cull_eps=eps)
    want = jobjective.evaluate(jobj, jnp.asarray(G), jnp.asarray(TGT), jnp.asarray(WM))
    np.testing.assert_allclose(_evaluate(precision, eps).numpy(), np.asarray(want), rtol=5e-5)


@pytest.mark.parametrize("precision,eps", TIERS, ids=[t[0] for t in TIERS])
def test_chunked_evaluate_equals_unchunked(chained, precision, eps):
    """Chunks of 2 (the last padded) and of 4 give the unchunked batch's
    fits bit for bit, and a candidate scored alone its own fit."""
    whole = _evaluate(precision, eps, chunk=None)
    for chunk in (CHUNK, 4):
        assert torch.equal(_evaluate(precision, eps, chunk=chunk), whole)
    assert torch.equal(_evaluate(precision, eps, chunk=None, g=G[3:4]), whole[3:4])


@pytest.mark.parametrize("precision,eps", TIERS, ids=[t[0] for t in TIERS])
def test_two_slab_partials_sum_to_fitness(chained, precision, eps):
    """The two half-canvas slabs' partials (chained passes, shifted boxes),
    each against JAX's fitness_pallas_partial, and summed against the
    port's whole fitness x denominator. Above the pass size the whole fast
    fitness takes the slabs' chained route (K4's single pass only below it),
    on the same 16-row tiles, so the fast tier sums too."""
    g9 = tcodec.genome_to_renderer(torch.from_numpy(G))
    w_eff, denom = tfitness.weff_denom(torch.from_numpy(WM), False, 1.0, H, W)
    corner = precision == "fast"
    parts = []
    for y0 in (0, HS):
        got = rc.fitness_partial(g9, torch.from_numpy(TGT[y0:y0 + HS]), w_eff[y0:y0 + HS], H,
                                 W, y0, tile_h=HS, precision=precision, cull_eps=eps,
                                 corner_cull=corner)
        want = rp.fitness_pallas_partial(
            jnp.asarray(g9.numpy()), jnp.asarray(TGT[y0:y0 + HS]), jnp.asarray(WM[y0:y0 + HS]),
            H, W, jnp.int32(y0), tile_h=HS, tile_w=128, interpret=True, precision=precision,
            cull_eps=eps, corner_cull=corner)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                                   err_msg=f"slab {y0}+{HS}")
        parts.append(got)
    full = rc.fitness(g9, torch.from_numpy(TGT), torch.from_numpy(WM), H, W, tile_h=HS,
                      precision=precision, cull_eps=eps, corner_cull=corner) * denom
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_chunked_ga_generation_equals_unchunked(chained):
    """One GA generation at P=6 scored in chunks of 4 (the last padded)
    equals the same generation scored whole, on the same draws: population,
    fits, best, best fit and stall count in bits."""
    P = 6
    cfg, gnm = GAConfig(pop_size=P, generations=10, elite_k=2), GenomeConfig(n_splats=N)
    pop = torch.from_numpy(axes_genomes(44, P, N, H, W))
    tgt, wm = torch.from_numpy(TGT), torch.from_numpy(WM)
    draws = tga.draw_offspring(torch.Generator().manual_seed(45), P, N, cfg.tour_k, "cpu")
    sig_max, sig_min = MutSigma.max_defaults().__dict__, MutSigma.min_defaults().__dict__
    out = []
    for chunk in (4, None):
        obj = _tobj("exact-tight", None, chunk)
        fits = tobjective.evaluate(obj, pop, tgt, wm, device="cpu")
        b = int(torch.argmin(fits))
        st = tga.GAState(pop, fits, pop[b], fits[b], torch.zeros((), dtype=torch.int32),
                         torch.Generator(), 0)
        out.append(tga.step(st, obj, tgt, wm, cfg, gnm, sig_max, sig_min, draws=draws)[0])
    a, b = out
    for name in ("pop", "fits", "best", "best_fit", "no_improve"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.gen == b.gen == 1


def test_run_ga_eval_chunk_equals_whole_batch(chained, tmp_path):
    """run_ga --eval-chunk (the flagship's flag) with a chunk that does not
    divide the population gives the whole-batch run's curves and best
    genome bit for bit, through the runner: init, generations, rescore and
    export."""
    out = {}
    for chunk in ("4", "0"):
        out[chunk] = run_ga.main([
            "--image", f"synthetic:{H}x{W}", "--work-max-side", str(W), "--n-splats", str(N),
            "--pop-size", "6", "--elite-k", "2", "--generations", "3", "--log-every", "1",
            "--eval-chunk", chunk, "--no-video", "--device", "cpu",
            "--output-dir", str(tmp_path / f"chunk{chunk}")])
    a, b = out["4"], out["0"]
    assert a["curves"] == b["curves"] and len(a["curves"]["best"]) == 4
    assert np.array_equal(a["best"], b["best"]) and a["best_fit"] == b["best_fit"]
    assert torch.equal(a["final"], b["final"])
