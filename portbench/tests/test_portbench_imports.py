"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: each import's top-level name (the
part before the first dot) compared whole, since the port's name begins
with the JAX package's."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "relationprediction_tpu"}
REFERENCE_NEVER = NEVER | {"relationprediction_torch"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((HERE / "reference").glob("*.py"))


def top_level_imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports; a relative
    import within portbench counts as ``portbench``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else
                      node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    found = top_level_imports(path)
    assert not found & REFERENCE_NEVER
    # within portbench, only the reference itself
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, "the reference imports only itself"


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import relationprediction_torch.models\n"
                 "from relationprediction_tpu import x\n")
    assert top_level_imports(f) == {"relationprediction_torch",
                                    "relationprediction_tpu"}
