"""Nothing the benchmark runs loads JAX or the JAX package: top-level module
names are compared whole, so the port (``repro_torch``) passes and ``repro``
does not; and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from bench.harness import runner, spec


def test_top_level_names_compared_whole():
    assert runner.forbidden_modules(["repro_torch", "repro_torch.train.trainer", "numpy"]) == []
    assert runner.forbidden_modules(["repro.core.lars"]) == ["repro"]
    assert runner.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert runner.forbidden_modules(["jaxtyping", "reprobate"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_reads_benchmarks():
    for path in spec.BENCH.rglob("*.py"):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "repro"}, path
        assert "benchmarks" not in names, path
    for sub in ("reference", "counts"):
        for path in (spec.BENCH / sub).glob("*.py"):
            assert "repro_torch" not in set(_imports(path)), path


def test_a_process_that_loads_the_harness_and_the_program_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from bench.harness import runner, spec, faults\n"
        "from bench.reference import fp8, qwen3, resnet\n"
        "import repro_torch.launch.train, repro_torch.models.resnet\n"
        "import repro_torch.train.trainer, repro_torch.core.grad_sync\n"
        "for c in spec.benchmark()['configs']: spec.system({'family': 'resnet'})\n"
        "print(runner.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
