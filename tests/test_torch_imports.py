"""Import hygiene of the PyTorch port: no JAX and nothing of the JAX package.

Every module of ``flow_timesnet_tpu_torch`` and ``chip_smoke.py`` is parsed
with ``ast``; an import of ``jax``, ``flax``, ``optax``, ``flow_timesnet_tpu``
or ``pandas`` (which the card's machine lacks) anywhere in them (top level or
inside a function) fails the test.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "flow_timesnet_tpu", "pandas")
SOURCES = sorted((REPO / "flow_timesnet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_the_port_has_modules_to_check():
    assert len(SOURCES) > 10 and all(p.is_file() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({name for name in _imported_modules(tree) if _forbidden(name)})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("name,bad", [("jax.numpy", True), ("flax.linen", True),
                                      ("flow_timesnet_tpu.ops.fold", True), ("optax", True),
                                      ("pandas", True),
                                      ("flow_timesnet_tpu_torch.ops.fold", False),
                                      ("torch", False), ("numpy", False)])
def test_forbidden_names(name, bad):
    assert _forbidden(name) is bad
