"""Nothing under portbench/ imports jax or the JAX package (top-level
module names compared whole); the reference imports nothing of the port."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fft_convolution_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): _imports(p) & FORBIDDEN for p in ROOT.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    # the port's name begins with the JAX package's: compared whole, it passes
    assert "fft_convolution_tpu_torch" not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for p in (ROOT / "reference").rglob("*.py"):
        assert not _imports(p) & (FORBIDDEN | {"fft_convolution_tpu_torch"}), p


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    import sys

    from portbench import harness

    monkeypatch.setitem(sys.modules, "fft_convolution_tpu_torch_x", sys)
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
