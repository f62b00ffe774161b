"""The run's own look for JAX and the JAX package, and its refusal without
a card."""
import ast
import os

import pytest
import torch

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("names,bad", [
    (["torch", "ggs_tpu_torch", "ggs_tpu_torch.ops.codec", "numpy"], []),
    (["ggs_tpu_torch", "ggs_tpu", "ggs_tpu.ops"], ["ggs_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "ggs_tpu_tools", "flaxen"], []),
])
def test_forbidden_compares_whole_top_level_names(names, bad):
    assert run.forbidden(names) == bad


def test_the_harness_sources_import_no_jax_and_no_program_internals_by_path():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not run.forbidden(mods), (f, mods)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for a machine without one")
    assert run.main(["--workload", "ga512-p32", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "CUDA" in out.err
