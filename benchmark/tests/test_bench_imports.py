"""What the benchmark loads: no jax, jaxlib, flax or JAX package (top-level
module names compared whole), and a reference that imports nothing of the
program."""

import ast
import subprocess
import sys

from benchmark import harness
from conftest import ROOT

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark import harness, devtrace
for cell in {cells!r}:
    c = harness.load_cell(Path({root!r}), cell)
    harness.runner(c.traffic["runner"])
    for m in c.per_layer:
        harness.load_module(Path({root!r}) / "benchmark" / "metrics" /
                            (m["name"] + ".py"), "m_" + m["name"])
devtrace.own_kernels()
{extra}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def loaded(extra=""):
    from conftest import CELLS
    code = LOAD_ALL.format(root=str(ROOT), cells=CELLS, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    """Every module run.py loads, with a tiny frame run of the program on
    the CPU: no top-level name is jax, jaxlib, flax or fovsplat."""
    extra = """
import torch
sys.path.insert(0, str(Path({root!r}) / "benchmark" / "tests"))
from conftest import tiny_run
tiny_run("ps1-frame-orbit")
""".format(root=str(ROOT))
    names = loaded(extra)
    assert "fovsplat_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "fovsplat"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    names = {"torch": sys, "fovsplat_torch": sys, "fovsplat_torch.ops": sys}
    monkeypatch.setattr(sys, "modules", dict(names))
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**names, "fovsplat.ops": sys,
                                         "jaxlib.xla": sys})
    assert harness.forbidden_modules() == ["fovsplat", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "fovsplat_torch", "fovsplat", "jax", "jaxlib", "flax"), \
                    f"{path.name} imports {n}"
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.frames, benchmark.reference.train\n"
            "import benchmark.reference.hvs, benchmark.reference.work\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "fovsplat_torch" not in eval(out.stdout.strip())


def test_run_refuses_without_a_card_or_a_cell(tmp_path):
    run = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--seed",
           "2147483700", "--seconds", "1", "--trace", "0", "--workload"]
    out = subprocess.run(run + ["no-such-cell"], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    import torch
    if not torch.cuda.is_available():
        out = subprocess.run(run + ["ours-gaze-trace"], capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 3 and out.stdout == ""
