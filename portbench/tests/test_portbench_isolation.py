"""Nothing under portbench/ imports JAX or the JAX package (top-level module
names compared whole: ``repro_torch`` begins with ``repro``), the reference
imports nothing of the program, and a run leaves none of them in
``sys.modules``."""
from __future__ import annotations

import ast
import subprocess
import sys

from portbench.tests.conftest import PB, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def files(where):
    return [p for p in sorted(where.rglob("*.py")) if "__pycache__" not in p.parts]


def test_nothing_imports_jax_or_the_jax_package():
    for p in files(PB):
        for m in imports(p):
            assert m.split(".")[0] not in FORBIDDEN, (p, m)


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "typing", "math", "hashlib", "dataclasses", "torch", "numpy"}
    for p in files(PB / "reference") + [PB / "weights.py"]:
        for m in imports(p):
            top = m.split(".")[0]
            assert top in allowed or m in ("portbench.weights", "portbench.reference.quant",
                                           "portbench.reference.model"), (p, m)


def test_a_run_imports_none_of_them():
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from portbench.tests.conftest import tiny_config, tiny_cell, TINY_MIX\n"
        "from portbench import harness\n"
        "import portbench.reference.model\n"
        "assert not any(m.split('.')[0] == 'repro_torch' for m in sys.modules), 'ref'\n"
        "out = harness.run_cell(tiny_cell('mixtral-8x7b-int8.chat64'), "
        "tiny_config('mixtral-8x7b-int8'), TINY_MIX, harness.load_benchmark(), seed=3, "
        "seconds=1.0, traced=False, device='cpu', t_start=time.perf_counter())\n"
        "print(harness.imported_forbidden(), out['correct'])\n") % (str(ROOT / "src"), str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[] True"
