"""Nothing under ``h100_bench/`` imports JAX or the JAX package, and
nothing under ``h100_bench/reference/`` imports the port. Module names
are compared by their top-level name, whole: the port's name begins with
the JAX package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
JAX = {"jax", "jaxlib", "flax", "modelcompression_tpu"}
PORT = "modelcompression_tpu_torch"


def _sources(folder):
    for root, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources(HERE)),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted(_sources(os.path.join(HERE, "reference"))),
    ids=lambda p: os.path.relpath(p, HERE))
def test_reference_takes_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)


def test_names_compared_whole():
    src = "import modelcompression_tpu_torch.models\nimport jaxlib\n"
    tree_names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_names.update(a.name.split(".", 1)[0] for a in node.names)
    assert tree_names & JAX == {"jaxlib"}
