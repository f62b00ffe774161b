"""The port's checkpoints (ggs_tpu_torch/utils/checkpoint.py), mirroring
tests/test_checkpoint.py: state round trips, a resume bit-equal to the
uninterrupted run, the refusals, and the atomic write, on the CPU at a small
size (16x16, N=4), where every kernel wrapper takes its plain version. A
port state holds a torch.Generator and, for Adam, a torch.optim.Adam, so
"bit-equal" covers the generator's state and Adam's moments and step, and
one more step from the loaded state equals one from the saved state."""
import json

import numpy as np
import pytest
import torch

from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, SAConfig
from ggs_tpu_torch.models import ga, genome, gradient, pt, sa
from ggs_tpu_torch.ops import objective
from ggs_tpu_torch.parallel import island
from ggs_tpu_torch.utils import checkpoint as ckpt
from torch_inputs import image, weights
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H = W = 16
GNM = GenomeConfig(n_splats=4, min_scale=1.0, max_scale=0.3)
OBJ = objective.Objective(H=H, W=W, precision="exact-tight")
GA_CFG = GAConfig(pop_size=4, generations=20, elite_k=1, cxpb=0.5, mutpb=0.3)
SA_CFG = SAConfig(iterations=20, tries_per_iter=3, t0=1e-2)
TGT = torch.from_numpy(image(3, H, W))
WM = torch.from_numpy(weights(4, H, W))


def _rng(seed=7):
    return torch.Generator().manual_seed(seed)


def _grad_step():
    return gradient.make_fit_step(OBJ, GNM, GradConfig(lr=2e-2))


# kind -> (fresh state from a fresh generator, run(state, n) -> state)
def _ga():
    return ga.init(_rng(), OBJ, TGT, WM, GA_CFG, GNM)


def _islands():
    return ga.init(_rng(), OBJ, TGT, WM, GAConfig(pop_size=8, generations=20, elite_k=1), GNM)


def _sa():
    return sa.init(_rng(), OBJ, TGT, WM, GNM)


def _pt():
    return pt.init(_rng(), OBJ, TGT, WM, GNM, 3, t_cold=1e-2, t_hot=1.0)


def _grad():
    make_opt, _ = _grad_step()
    g0 = genome.new_population(_rng(), 2, GNM.n_splats, H, W, GNM.min_scale, GNM.max_scale,
                               device="cpu")
    return gradient.init_state(make_opt, g0)


def _run_ga(st, n):
    return ga.run_block(st, OBJ, TGT, WM, GA_CFG, GNM, n)[0]


def _run_islands(st, n):
    cfg = GAConfig(pop_size=8, generations=20, elite_k=1)
    run = island.make_run_block(OBJ, cfg, GNM, 2, migrate_every=2, migrate_k=1)
    return run(st, TGT, WM, n)[0]


def _run_sa(st, n):
    return sa.make_run_block(OBJ, SA_CFG, GNM)(st, TGT, WM, n)[0]


def _run_pt(st, n):
    return pt.make_run_block(OBJ, SA_CFG, GNM, swap_every=2)(st, TGT, WM, n)[0]


def _run_grad(st, n):
    return gradient.run_block(st, _grad_step()[1], TGT, WM, n)[0]


KINDS = {"ga": (_ga, _run_ga), "islands": (_islands, _run_islands), "sa": (_sa, _run_sa),
         "pt": (_pt, _run_pt), "grad": (_grad, _run_grad)}


def _assert_same(a, b):
    """Every field equal in bits: tensors, ints, the generator's state and
    Adam's moments, step and hyperparameters."""
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), name
        elif isinstance(x, torch.optim.Adam):
            sx, sy = x.state[a.g], y.state[b.g]
            assert sx.keys() == sy.keys()
            for k in sx:
                assert sx[k].device == sy[k].device and torch.equal(sx[k], sy[k]), k
            gx, gy = x.param_groups[0], y.param_groups[0]
            assert all(gx[k] == gy[k] for k in ("lr", "betas", "eps", "weight_decay"))
            assert y.param_groups[0]["params"][0] is b.g
        else:
            assert x == y, name


@pytest.mark.parametrize("kind", ["ga", "sa", "pt", "grad"])
def test_state_roundtrip(tmp_path, kind):
    make, run = KINDS[kind]
    st = run(make(), 2)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, st, meta={"gen": 2, "note": "x"})
    st2, meta = ckpt.load_checkpoint(path, make())
    assert meta == {"gen": 2, "note": "x"}
    _assert_same(st, st2)
    # the loaded state is independent of the saved one and takes the same
    # next step, bit for bit (Adam: the same moments, step and update)
    _assert_same(run(st, 1), run(st2, 1))


@pytest.mark.parametrize("kind", ["ga", "islands", "sa", "pt", "grad"])
def test_resume_is_bit_exact(tmp_path, kind):
    """run(10) == run(5) -> save -> load into a fresh template -> run(5)."""
    make, run = KINDS[kind]
    full = run(make(), 10)
    half = run(make(), 5)
    path = str(tmp_path / "mid.npz")
    ckpt.save_checkpoint(path, half, meta={"gen": 5})
    resumed, _ = ckpt.load_checkpoint(path, make())
    _assert_same(full, run(resumed, 5))


def _saved(tmp_path):
    path = str(tmp_path / "ok.npz")
    ckpt.save_checkpoint(path, _ga(), meta={"gen": 0})
    return path


def _rewrite(path, edit):
    """The checkpoint at path with its __meta__ edited by edit(payload)."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        payload = json.loads(str(z["__meta__"]))
    arrays = edit(payload) or arrays
    ckpt._write_npz(path, arrays, payload)


def _refuse_type(tmp_path):
    return _saved(tmp_path), _grad(), "state type mismatch"


def _refuse_pop_size(tmp_path):
    big = ga.init(_rng(), OBJ, TGT, WM, GAConfig(pop_size=8, generations=20, elite_k=1), GNM)
    return _saved(tmp_path), big, "does not match template"


def _refuse_truncated(tmp_path):
    data = open(_saved(tmp_path), "rb").read()
    bad = str(tmp_path / "truncated.npz")
    with open(bad, "wb") as f:
        f.write(data[: len(data) // 3])
    return bad, _ga(), "corrupt or truncated"


def _refuse_newer(tmp_path):
    path = _saved(tmp_path)
    _rewrite(path, lambda p: p.update(format_version=ckpt._FORMAT_VERSION + 1))
    return path, _ga(), "has format v2"


def _refuse_generator_device(tmp_path):
    """A CUDA generator's state (16 bytes: seed and Philox offset) in a file
    read into a CPU template: refused, not reseeded."""
    path = _saved(tmp_path)

    def to_cuda(payload):
        payload["generator"]["device_type"] = "cuda"
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        arrays["generator"] = np.arange(16, dtype=np.uint8)
        return arrays

    _rewrite(path, to_cuda)
    return path, _ga(), "saved on 'cuda'"


def _refuse_jax(tmp_path):
    import jax

    from ggs_tpu.config import GAConfig as JGAConfig
    from ggs_tpu.config import GenomeConfig as JGenomeConfig
    from ggs_tpu.models import ga as jga
    from ggs_tpu.ops import objective as jobjective
    from ggs_tpu.utils import checkpoint as jckpt

    jobj = jobjective.Objective(H=H, W=W, impl="xla")
    js = jga.init(jax.random.PRNGKey(1), jobj, TGT.numpy(), None,
                  JGAConfig(pop_size=4, generations=20, elite_k=1),
                  JGenomeConfig(n_splats=4, min_scale=1.0, max_scale=0.3))
    path = str(tmp_path / "ga_ckpt.npz")
    jckpt.save_checkpoint(path, js, meta={"gen": 0})
    return path, _ga(), "load_jax_checkpoint"


@pytest.mark.parametrize("case", [_refuse_type, _refuse_pop_size, _refuse_truncated,
                                  _refuse_newer, _refuse_generator_device, _refuse_jax],
                         ids=lambda f: f.__name__[8:])
def test_load_refuses(tmp_path, case):
    path, template, match = case(tmp_path)
    with pytest.raises(ValueError, match=match):
        ckpt.load_checkpoint(path, template)


def test_atomic_write_keeps_old_file(tmp_path, monkeypatch):
    """A save that fails mid-write leaves the previous checkpoint intact and
    no temporary file behind."""
    path = _saved(tmp_path)
    before = open(path, "rb").read()

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, _run_ga(_ga(), 1), meta={"gen": 1})
    assert open(path, "rb").read() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ok.npz"]
    monkeypatch.undo()
    st, meta = ckpt.load_checkpoint(path, _ga())
    assert meta == {"gen": 0} and st.gen == 0
