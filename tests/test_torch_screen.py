"""The screen-space front end's tier rule (ggs_tpu_torch/ops/screen.py) and
the layering of the port's bottom layer.

* `screen.tier` over every precision, corner_cull and cull_eps (None or a
  value), against a literal table of the rules the forward entry points
  and the gradient paths follow (the JAX package's render_pallas.py:
  1345-1421 and gradient.py:32-57); render_grad's arguments back from each
  tier (`box_tier`); "bf16" and "highest" give the same screen and the
  same slab rows.
* `ggs_tpu_torch/utils/` imports nothing from `ggs_tpu_torch.ops` but the
  known debts of utils/io.py, listed here.
"""
from __future__ import annotations

import ast
import os

import pytest
import torch

from ggs_tpu_torch.ops import codec as tcodec
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.ops import screen
from torch_inputs import axes_genomes
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

EPS = 8e-2
D = rc.DEFAULT_CULL_EPS

# (precision, cull_eps, corner_cull): (box, eps, corner_eps, mode)
RULES = {
    ("highest", None, False): ("reference", None, None, "exact"),
    ("highest", None, True): ("reference", None, None, "exact"),
    ("highest", EPS, False): ("reference", None, None, "exact"),
    ("highest", EPS, True): ("reference", None, None, "exact"),
    ("exact-tight", None, False): ("tight", None, None, "exact"),
    ("exact-tight", None, True): ("tight", None, None, "exact"),
    ("exact-tight", EPS, False): ("tight", None, None, "exact"),
    ("exact-tight", EPS, True): ("tight", None, None, "exact"),
    ("fast", None, False): ("eps", D, None, "fast"),
    ("fast", None, True): ("eps", D, D, "fast"),
    ("fast", EPS, False): ("eps", EPS, None, "fast"),
    ("fast", EPS, True): ("eps", EPS, EPS, "fast"),
    ("bf16", None, False): ("reference", None, None, "bf16"),
    ("bf16", None, True): ("reference", None, None, "bf16"),
    ("bf16", EPS, False): ("reference", None, None, "bf16"),
    ("bf16", EPS, True): ("reference", None, None, "bf16"),
}


@pytest.mark.parametrize("key", list(RULES))
def test_tier_rules(key):
    """Each precision's tier as the entry points have always decided it,
    and render_grad's (box, cull_eps, corner_cull) for it, which give the
    same screen and culls under the exact walk."""
    t = screen.tier(*key)
    assert tuple(t) == RULES[key]
    args = t.diff_args()
    assert args == dict(box="tight" if key[0] == "exact-tight" else "reference", cull_eps=t.eps,
                        corner_cull=t.corner_eps is not None)
    assert screen.box_tier(**args) == t._replace(mode="exact")


def test_unknown_tiers_raise():
    with pytest.raises(ValueError):
        screen.tier("medium")
    with pytest.raises(ValueError):
        screen.box_tier("eps")


def test_bf16_screens_as_highest():
    """"bf16" and "highest" take the same screen, so the slab rows that
    objective's sharded SSIM renders at "bf16" are those of "highest"."""
    H, W = 40, 256
    g9 = tcodec.genome_to_renderer(torch.from_numpy(axes_genomes(3, 2, 20, H, W, 0.3)))
    a = screen.screen(g9, H, W, 3.0, screen.tier("bf16"), y_origin=8)
    b = screen.screen(g9, H, W, 3.0, screen.tier("highest"), y_origin=8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rows = {p: rc.render_rows(g9, H, W, 8, 16, precision=p) for p in ("bf16", "highest")}
    assert torch.equal(rows["bf16"], rows["highest"])


UTILS = os.path.join(os.path.dirname(rc.__file__), os.pardir, "utils")
# the bottom layer's known upward imports: (file, module, name)
KNOWN_DEBTS = {
    ("io.py", "ggs_tpu_torch.ops.mask", "resize_bilinear"),
    ("io.py", "ggs_tpu_torch.ops", "codec"),  # render_genome_to_u8
    ("io.py", "ggs_tpu_torch.ops", "render"),  # render_genome_to_u8
}


def _ops_imports(path: str, name: str) -> set:
    """(file, module, name) of every import of ggs_tpu_torch.ops in a
    module of ggs_tpu_torch.utils, at any depth of its code."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [(a.name, "") for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:  # relative to ggs_tpu_torch.utils
                pkg = ["ggs_tpu_torch", "utils"][: 3 - node.level]
                base = ".".join(pkg + ([base] if base else []))
            mods = [(base, a.name) for a in node.names]
        else:
            continue
        found |= {(name, m, n) for m, n in mods if m.split(".")[:2] == ["ggs_tpu_torch", "ops"]}
    return found


def test_utils_import_nothing_from_ops():
    """utils/ is the bottom layer: block_graph and profiling know no kernel."""
    found = set()
    for name in sorted(os.listdir(UTILS)):
        if name.endswith(".py"):
            found |= _ops_imports(os.path.join(UTILS, name), name)
    assert found == KNOWN_DEBTS
