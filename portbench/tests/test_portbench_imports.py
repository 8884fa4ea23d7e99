"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the program. Top-level names are compared
whole: the port's name, ``vittf_tpu_torch``, begins with the JAX package's."""
import ast
import subprocess
import sys

from portbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "vittf_tpu"}


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    for path in sorted((spec.BENCH_DIR / "reference").rglob("*.py")):
        assert "vittf_tpu_torch" not in top_level_imports(path), path


def test_the_run_check_compares_whole_names():
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            "sys.modules['vittf_tpu_torch_x'] = sys; sys.modules['vittf_tpu_torch'] = sys; "
            "print(run.forbidden_modules()); sys.modules['vittf_tpu.ops'] = sys; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True).stdout.split("\n")
    assert out[0] == "[]" and out[1] == "['vittf_tpu']"


def test_a_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ the run
    fails and prints no result line."""
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vits8-extract-256",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert r.returncode != 0 and '"correct"' not in r.stdout
