"""What the benchmark may load: nothing of JAX or of the JAX package
(``repro``), compared by whole top-level module name (the port,
``repro_torch``, begins with ``repro``); and a yardstick that imports
nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: The yardstick: generator, reference, comparison, roofline, readers.
YARDSTICK = ("synth.py", "reference.py", "compare.py", "roofline.py",
             "readers.py", "devtrace.py")


def imported_tops(path: Path):
    """Every top-level module name ``path`` imports (absolute imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = set(imported_tops(path))
    assert not tops & FORBIDDEN, f"{path.name} imports {tops & FORBIDDEN}"


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    path = HERE / name
    tops = set(imported_tops(path))
    assert "repro_torch" not in tops and not tops & FORBIDDEN
    text = path.read_text()
    assert "oracle" not in text and "kernels.ref" not in text


def test_whole_name_comparison():
    """``repro_torch`` is allowed and ``repro`` is not, though one name
    begins with the other."""
    from perfbench.harness import FORBIDDEN as names
    assert "repro" in names and "repro_torch" not in names


def test_a_run_loads_no_jax():
    """Every module a run loads (the harness, the generator, the metric
    readers and the program's modules they reach), in a fresh process."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from perfbench import harness, generator, devtrace, readings\n"
        "import repro_torch.core, repro_torch.serve, repro_torch.kernels.ops\n"
        "import repro_torch.obs.profile\n"
        "spec = harness.load_spec(harness.ROOT.parent)\n"
        "for m in spec['per_layer']: harness.metric_reader(m['name'])\n"
        "print(' '.join(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_card_no_result():
    """Without a CUDA card the entry exits non-zero and prints nothing on
    its standard output (on a host without a card)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not taken")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "imdb_synth.hybrid.discover", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=HERE.parent, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
