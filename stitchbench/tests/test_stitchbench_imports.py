"""Nothing under stitchbench/ imports JAX or the JAX package, and the
reference imports neither the port nor torch. Top-level module names are
compared whole: ``image_stitch_tpu_torch`` begins with ``image_stitch_tpu``
and is not it."""

from __future__ import annotations

import ast

import pytest

from conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "image_stitch_tpu"}
BENCH = ROOT / "stitchbench"
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import image_stitch_tpu_torch.core\nfrom image_stitch_tpu import api\n"
                     "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(probe) == {"image_stitch_tpu_torch", "image_stitch_tpu", "importlib",
                                        "jax"}
    assert top_level_imports(probe) & JAX == {"image_stitch_tpu", "jax"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (top_level_imports(path) & JAX)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert not (top_level_imports(path) & (JAX | {"image_stitch_tpu_torch", "torch"}))
    assert "image_stitch_tpu" not in path.read_text()
