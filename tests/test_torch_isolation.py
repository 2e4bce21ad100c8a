"""The port and chip_smoke.py import nothing of JAX or of the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_cfd")
FILES = sorted((ROOT / "tpu_cfd_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_has_files():
    assert len(FILES) > 10
    csrc = ROOT / "tpu_cfd_torch" / "ops" / "cuda" / "csrc"
    for source in ("spectral_step.cu", "spectral_conv.cu", "ffn.cu", "adam.cu"):
        assert (csrc / source).exists(), source


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"
