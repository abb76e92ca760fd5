"""What a run loads and what the benchmark's modules import: no JAX, no JAX
package, no JAX-era benchmark; the reference, the roofline and the tracing
nothing of the program. Top-level names compare whole (``remo3d_tpu_torch``
begins with ``remo3d_tpu``)."""

import ast
import glob
import os
import subprocess
import sys

from h100_bench import run

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")) + [
        os.path.join(BENCH_DIR, "roofline", "__init__.py"), os.path.join(BENCH_DIR, "trace.py")]
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"remo3d_tpu_torch", "remo3d_tpu", "jax", "jaxlib", "flax"}, path


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"), recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(run.FOREIGN), path


def test_a_run_loads_no_foreign_module():
    code = (
        "import sys, time, json\n"
        "sys.path.insert(0, 'h100_bench/tests')\n"
        "from test_h100_bench_harness import small\n"
        "from h100_bench import run\n"
        "out = run.run(small('example01_2d.log_full', 6), 5, 0.1, False, device='cpu',"
        " t_start=time.perf_counter())\n"
        "assert out['correct'], out\n"
        "mods = sorted(sys.modules)\n"
        "print(json.dumps([run.foreign_modules(), [m for m in mods"
        " if m.split('.')[0] == 'remo3d_tpu_torch']]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    foreign, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert foreign == [] and "remo3d_tpu_torch.model" in port
    assert "remo3d_tpu_torch.bench" not in port


def test_without_a_card_a_run_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                          "bm3_dip30.log_full", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
