"""Nothing under portbench/ imports JAX or the JAX package, and the
references import nothing of the port; names are compared whole by their
top level (the part before the first dot)."""
import ast
from pathlib import Path

import pytest

from portbench import core

FORBIDDEN = set(core.FORBIDDEN)
PORT = "repro_torch"


def imported(source: str):
    """Top-level names of every import in ``source``, at any depth."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def files():
    return sorted(core.ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", files(), ids=lambda p: str(p.relative_to(core.ROOT)))
def test_no_jax_and_no_reference_package(path: Path):
    names = set(imported(path.read_text()))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path.parent.name == "reference":
        assert PORT not in names


def test_the_check_compares_whole_top_level_names():
    assert set(imported("import repro_torch.models\nfrom portbench import core")) \
        == {"repro_torch", "portbench"}
    assert set(imported("def f():\n    import jax.numpy as jnp\n")) == {"jax"}
    assert set(imported("from repro.models import moe")) == {"repro"}
    assert set(imported("importlib.import_module('flax.linen')")) == {"flax"}
    assert not {"repro_torch", "reproduce"} & FORBIDDEN
