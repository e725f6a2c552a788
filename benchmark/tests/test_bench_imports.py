"""What the benchmark's files import, and the shape of BENCHMARK.json.

No module under ``benchmark/`` imports JAX, Flax or the JAX package, the
top-level name of each import (the part before the first dot) compared
whole, so ``qppvm_tpu_torch`` does not count as ``qppvm_tpu``. The plain
reference under ``benchmark/reference/`` imports nothing of the program.

    python -m pytest benchmark/tests -q
"""
import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "qppvm_tpu"}


def imported_tops(path: Path):
    """Top-level names of every import in a file, with its line."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def py_files(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", py_files(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    bad = [(top, line) for top, line in imported_tops(path) if top in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", py_files(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    bad = [(top, line) for top, line in imported_tops(path)
           if top == "qppvm_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import qppvm_tpu_torch.opt\nfrom qppvm_tpu.opt import qp\n"
                 "import jaxtyping\nimport jax.numpy\n")
    tops = [t for t, _ in imported_tops(f) if t in FORBIDDEN]
    assert tops == ["qppvm_tpu", "jax"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_finds_every_file():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = set()
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert (BENCH / "configs" / f"{c['name']}.json").is_file()
        names.add(c["name"])
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"]
        assert (BENCH / "modes" / f"{wl['mode']}.py").is_file()
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
