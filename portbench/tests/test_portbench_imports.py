"""Nothing under ``portbench/`` imports JAX or the JAX package (top-level
names compared whole, so ``pytorch_ps_mpi_tpu_torch`` passes), and the
references import nothing of the port."""

import ast

import pytest

from portbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pytorch_ps_mpi_tpu"}
PORT = "pytorch_ps_mpi_tpu_torch"
FILES = sorted(spec.HERE.rglob("*.py"))


def imported(path):
    """Top-level names of every import in the file, at any depth."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(imported(path))
    assert PORT not in names
    assert names <= {"torch", "portbench", "math", "contextlib", "typing",
                     "__future__", "statistics"}


def test_the_whole_name_is_compared():
    assert "pytorch_ps_mpi_tpu_torch".split(".")[0] not in FORBIDDEN
