"""What the benchmark loads: nothing of JAX or of the JAX package in a run,
and nothing of the port in the plain reference.

    python -m pytest -q benchmark/tests/test_bench_guard.py
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "orbslamm_tpu"}


def _loaded(code: str) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_port():
    names = _loaded("import benchmark.reference.orb, benchmark.reference.hamming, "
                    "benchmark.reference.pose, benchmark.reference.ate, "
                    "benchmark.reference.precision")
    assert not names & (FORBIDDEN | {"orbslamm_tpu_torch"})


def test_a_run_loads_nothing_of_jax():
    code = ("sys.argv = ['x']\n"
            "sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "from test_bench_faults import tiny_cell\n"
            "from benchmark import harness\n"
            "res = harness.execute(tiny_cell('tum_rgbd.stream'), 7, 2, True, 'cpu')\n"
            "assert res['attempted'] > 0, res\n"
            "import benchmark.control, benchmark.init_sweep\n"
            "for p in sorted((harness.BENCH / 'metrics').glob('*.py')): harness.load_reader(p.stem)\n"
            % str(Path(__file__).resolve().parent))
    names = _loaded(code)
    assert "orbslamm_tpu_torch" in names
    assert not names & FORBIDDEN


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, f"{path}: imports {tops & FORBIDDEN}"
            if "reference" in path.parts:
                assert "orbslamm_tpu_torch" not in tops, f"{path} imports the port"
