"""Nothing the benchmark runs loads JAX or the JAX package, the reference
loads nothing of the port, and without a card the benchmark prints no
result."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "dcfa_yolo_tpu"}


def _imports(path: Path):
    """Top-level names (before the first dot, compared whole) of every
    module `path` imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules(sub: str = ""):
    return sorted((BENCH / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(BENCH)): sorted(set(_imports(p)) & JAX_SIDE)
           for p in _modules()}
    assert not {k: v for k, v in bad.items() if v}


def test_top_level_names_are_compared_whole():
    # the port's name begins with the JAX package's and must not match it
    assert "dcfa_yolo_tpu_torch" not in JAX_SIDE
    assert "dcfa_yolo_tpu_torch.infer".split(".")[0] not in JAX_SIDE


def test_reference_imports_nothing_of_the_port_or_the_harness():
    for p in _modules("reference"):
        names = set(_imports(p))
        assert "dcfa_yolo_tpu_torch" not in names, p
        assert not names & {"benchlib", "drivers"}, p


def test_harness_reads_none_of_the_jax_benchmark_files():
    for p in _modules():
        if p == Path(__file__).resolve():
            continue
        text = p.read_text()
        for name in ("BENCH_r0", "BASELINE.", "MULTICHIP_"):
            assert name not in text, (p, name)
        assert not set(_imports(p)) & {"bench", "chip_smoke", "profile_serve",
                                       "profile_train"}, p


def _run_without_card(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "serve_b1.dcfa-n",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    r = _run_without_card(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_run_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run_without_card(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
