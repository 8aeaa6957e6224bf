"""The command refuses to run without a card, without the program, and
with JAX or the JAX package loaded; nothing under benchmark/ imports them."""

import ast
import os
import shutil
import subprocess
import sys

from benchmark import run, spec

ARGS = ["--workload", "gmm5k-decode", "--seed", "5", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_fails_without_a_result():
    p = _run(spec.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["rasr_tpu_torch", "rasr_tpu_torch.ops", "jaxtyping",
                                  "flaxen.x", "torch"]) == []
    assert run.forbidden_modules(["rasr_tpu.ops.frontend", "jax", "jaxlib.xla", "flax.linen"]) \
        == ["flax", "jax", "jaxlib", "rasr_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(spec.HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(run.FORBIDDEN), (path, tops & set(run.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((spec.HERE / "reference").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "rasr_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, (path, tops)


def _strings(path):
    """The string constants of a module's code, its docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_no_file_of_the_jax_side_is_named():
    for path in sorted(spec.HERE.rglob("*.py")):
        if path.name == "test_harness_run.py":
            continue
        for text in _strings(path):
            for name in ("BENCH_", "MULTICHIP_", "bench.py", "rasr_tpu/", "BASELINE"):
                assert name not in text, (path, name)
