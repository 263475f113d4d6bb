"""Nothing the benchmark loads is JAX or the JAX package, by top-level name
compared whole; the references import nothing of libgdf_tpu_torch."""
import ast
import subprocess
import sys

from gdfbench import spec
from gdfbench.imports import forbidden_modules


def test_names_compared_whole():
    assert forbidden_modules(["libgdf_tpu_torch", "libgdf_tpu_torch.ops",
                              "jaxtyping", "torch"]) == []
    assert forbidden_modules(["libgdf_tpu.core", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                 "libgdf_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program():
    for path in (spec.PACKAGE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "torch"}, (path.name, tops)


def test_no_source_of_the_harness_imports_jax():
    for path in spec.PACKAGE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "libgdf_tpu"}, path


def test_a_run_loads_no_forbidden_module():
    """A whole run on the CPU, in a fresh process: afterwards sys.modules
    holds no forbidden top-level name."""
    code = (
        "import sys, time\n"
        "from gdfbench.tests._cells import run_cpu\n"
        "out = run_cpu('tpch_sf10.q3', 0.01, 0.3)\n"
        "from gdfbench.imports import forbidden_modules\n"
        "print(out['correct'], forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, "-m", "gdfbench.run", "--workload",
                          "tpch_sf10.q1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert res.returncode != 0 and res.stdout.strip() == ""
