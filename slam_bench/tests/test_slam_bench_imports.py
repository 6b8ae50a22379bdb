"""What the benchmark may import: nothing of JAX or the JAX package
anywhere (top-level module names compared whole: the port's name begins
with the JAX package's), and nothing of the port in its reference."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "fast_lio_sam_qn_tpu"}
PORT = "fast_lio_sam_qn_tpu_torch"


def imports(path: Path) -> list[tuple[int, str]]:
    """(level, module) of every import in a file; level > 0 is relative."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(0, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.level, node.module or ""))
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    for level, mod in imports(path):
        if level == 0:
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    for level, mod in imports(path):
        assert level <= 1, (path, mod)       # nothing above reference/
        if level == 0:
            assert mod.split(".")[0] != PORT, (path, mod)


def test_loading_the_reference_and_the_checks_loads_no_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import slam_bench.check, slam_bench.gen, slam_bench.roofline;"
            "import slam_bench.reference.lio, slam_bench.reference.pgo;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {PORT})!r}];"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_a_run_refuses_when_jax_is_loaded(monkeypatch):
    from slam_bench import harness as H

    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "fast_lio_sam_qn_tpu.ops", object())
    assert H.forbidden_modules() == ["fast_lio_sam_qn_tpu.ops", "jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.delitem(sys.modules, "fast_lio_sam_qn_tpu.ops")
    assert all(m.split(".")[0] != "jax" for m in H.forbidden_modules())
