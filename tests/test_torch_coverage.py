"""The port covers the JAX package: every module of `dcfa_yolo_tpu/` has a
module of `dcfa_yolo_tpu_torch/` at the same relative path, or an entry in
`COUNTERPARTS` naming its counterpart or saying why it has none; every
root CLI has a `python -m dcfa_yolo_tpu_torch.<cli>`."""

from __future__ import annotations

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "dcfa_yolo_tpu"
PORT_PKG = REPO / "dcfa_yolo_tpu_torch"

# JAX module (relative to dcfa_yolo_tpu/) → the port module that stands in
# for it, or "none: <why>"
COUNTERPARTS = {
    "ops/pallas_stem.py": "ops/cuda_stem.py",
    "ops/pallas_nms.py": "ops/cuda_nms.py",
    "ops/pallas_stem_train.py": "ops/cuda_stem_train.py",
    "native/__init__.py": "none: an opt-in C++ resize that is slower than PIL "
                          "on every measured host; the port requires PIL and "
                          "cv2, so it needs no fallback",
    "utils/jaxcache.py": "none: JAX's persistent compile cache; PyTorch eager "
                         "compiles nothing, and the kernels' build is cached by "
                         "ops/_build.py",
}
# root scripts of the JAX program that are not user CLIs
NOT_CLIS = {
    "__graft_entry__.py": "the JAX program's compile check and multi-chip dry "
                          "run; the port's are chip_smoke.py and "
                          "parallel/dryrun.py",
    "chip_smoke.py": "the port's own smoke run on the card",
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _has_main_guard(path: Path) -> bool:
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and isinstance(node.test.left, ast.Name)
                and node.test.left.id == "__name__"):
            return True
    return False


def test_every_jax_module_has_a_counterpart():
    missing = []
    for rel in _jax_modules():
        mapped = COUNTERPARTS.get(rel)
        if mapped is None:
            if not (PORT_PKG / rel).is_file():
                missing.append(rel)
        elif not mapped.startswith("none: "):
            assert (PORT_PKG / mapped).is_file(), (rel, mapped)
        else:
            assert len(mapped) > len("none: ") + 10, rel
    assert not missing, f"JAX modules with no port module and no map entry: {missing}"


def test_the_map_has_no_stale_entries():
    """Each mapped module exists in the JAX package and has no port module
    of its own name (else the map would hide it)."""
    modules = set(_jax_modules())
    for rel in COUNTERPARTS:
        assert rel in modules, rel
        assert not (PORT_PKG / rel).exists(), rel
    assert len(modules) >= 50


def test_every_root_cli_has_a_port_module():
    clis = sorted(p.name for p in REPO.glob("*.py") if _has_main_guard(p))
    assert {"train.py", "predict.py", "get_map.py", "bench.py", "summary.py",
            "voc_annotation.py"} <= set(clis)
    missing = []
    for name in clis:
        if name in NOT_CLIS:
            continue
        stem = name[:-3]
        module = PORT_PKG / f"{stem}.py"
        package_main = PORT_PKG / stem / "__main__.py"
        target = module if module.is_file() else package_main
        if not (target.is_file() and _has_main_guard(target)):
            missing.append(name)
    assert not missing, f"root CLIs with no python -m dcfa_yolo_tpu_torch.<cli>: {missing}"
    assert set(NOT_CLIS) <= set(clis)

