"""Nothing under cardbench/ imports JAX or the JAX package; the reference imports nothing of the program.

Each module's imports are read with ``ast`` and compared by their
top-level name (the part before the first dot) whole, so the program's
name, which begins with the JAX package's, is not mistaken for it.
"""
import ast
from pathlib import Path

from cardbench.harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "pyctcdecode_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


def modules():
    files = sorted(manifest.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    return files


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        found = set(imported_tops(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    ref = manifest.BENCH_DIR / "reference"
    for path in sorted(ref.rglob("*.py")):
        found = set(imported_tops(path)) & (FORBIDDEN | {"pyctcdecode_torch", "cardbench"})
        assert not found, f"{path} imports {found}"


def test_the_comparison_is_by_whole_top_level_name(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import pyctcdecode_torch.engine\nfrom pyctcdecode_torch import x\nimport jaxtyping\n")
    assert set(imported_tops(p)) == {"pyctcdecode_torch", "jaxtyping"}
    assert not set(imported_tops(p)) & FORBIDDEN
