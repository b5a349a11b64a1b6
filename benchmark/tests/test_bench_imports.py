"""No module of JAX or of the JAX package in the benchmark, by the
top-level name compared whole (the port's name begins with the JAX
package's), and nothing of the program in the reference."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.run import FORBIDDEN, loaded_forbidden

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported_top_names(path) <= {"__future__", "contextlib", "math", "typing", "numpy", "torch",
                                        "benchmark"}


@pytest.mark.parametrize("name", ["ltx2-video", "ltx2-av"])
def test_a_pipeline_s_files_load_no_forbidden_module(name):
    """A configuration's pair of pipeline files, loaded by name as the harness
    loads them: the reference side, its draws taken, loads nothing of the
    program; the program side, its components built at the tiny size (which
    imports the port), loads nothing of JAX or of the JAX package."""
    code = ("import sys; from benchmark import paths; from benchmark.run import loaded_forbidden; "
            "from benchmark.tests.tiny import tiny_config, tiny_traffic; "
            f"cfg = tiny_config({name!r}); "
            "paths.reference_side(cfg).clip_shapes(cfg, tiny_traffic().params); "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('ltx'))); "
            "paths.program_side(cfg).meta_modules(cfg); print(loaded_forbidden())")
    assert run_python(code).splitlines() == ["[]", "[]"]


def test_whole_names_are_compared():
    assert "ltx_tpu_torch" not in FORBIDDEN and "ltx_tpu" in FORBIDDEN


def run_python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_a_run_and_its_reference_load_no_forbidden_module():
    """What a run imports, the program and the reference with it, loads none
    of jax, jaxlib, flax or ltx_tpu; the reference alone loads no program."""
    code = ("import sys; from benchmark import harness, calibrate; "
            "from benchmark.run import loaded_forbidden; "
            "import ltx_tpu_torch.pipeline.generate; print(loaded_forbidden())")
    assert run_python(code) == "[]"
    code = ("import sys; import benchmark.reference.pipeline; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('ltx')))")
    assert run_python(code) == "[]"


def test_the_check_sees_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "ltx_tpu.fake", object())
    assert loaded_forbidden() == ["ltx_tpu"]
