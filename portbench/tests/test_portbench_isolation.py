"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level name (the program's own name begins with the JAX package's),
and the plain reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.tests import tiny

BENCH = tiny.ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "dynamic_asr_eval_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(under: Path):
    return [p for p in under.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(BENCH / "reference"):
        tops = set(imported_tops(path))
        assert "dynamic_asr_eval_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "typing", "torch", "portbench"}, (path, tops)


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole run at a tiny size on the CPU, then its process's modules."""
    bench = tiny.write(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(tiny.ROOT)!r})\n"
        "from portbench.harness import load_cell, run_cell\n"
        "from portbench.run import forbidden_modules\n"
        f"cell = load_cell('scconformer_xl.nsti.talks', {str(bench)!r}, {str(tmp_path / 'traffic')!r})\n"
        "r = run_cell(cell, 5, 0.5, False, 'cpu', log=lambda s: None)\n"
        "print(json.dumps({'correct': r['correct'], 'found': forbidden_modules(),\n"
        "                  'dotted': sorted(m for m in sys.modules if m.split('.')[0] == 'dynamic_asr_eval_tpu')}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    line = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert line == {"correct": True, "found": [], "dotted": []}
