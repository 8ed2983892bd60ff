"""No module of the benchmark imports JAX, flax or the JAX package, and
the reference imports nothing of the program either (top-level names
compared whole: the program's name begins with the JAX package's)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "kvq_tpu"}


def _files(root):
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(_files(HERE)),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted(_files(os.path.join(HERE,
                                                            "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (BANNED | {"kvq_tpu_torch"})


def test_whole_names():
    assert "kvq_tpu_torch" not in BANNED  # the port itself may be imported
