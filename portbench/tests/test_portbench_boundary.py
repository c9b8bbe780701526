"""The import boundary: nothing the benchmark runs loads jax, jaxlib, flax or
the JAX package (``pycusdr_tpu``, by whole top-level name: the port's
``pycusdr_tpu_torch`` begins with it), and the yardstick (reference,
comparison, layout, work model, traffic, cells) loads nothing of the
measured program. Each check runs in a fresh interpreter. Without a card the
benchmark exits non-zero and prints no result."""

import re
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import run

JAX_SIDE = {"jax", "jaxlib", "flax", "pycusdr_tpu"}
YARDSTICK = ["portbench.reference.demod", "portbench.reference.spec",
             "portbench.harness.compare", "portbench.harness.layout",
             "portbench.harness.workmodel", "portbench.harness.traffic",
             "portbench.harness.cells", "portbench.harness.check"]


def _python(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def _top_level(code: str) -> set:
    out = _python(code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_yardstick_loads_nothing_of_the_program():
    mods = _top_level("import " + ", ".join(YARDSTICK))
    assert not mods & (JAX_SIDE | {"pycusdr_tpu_torch"})


def test_a_run_loads_nothing_of_the_jax_side(tiny_root):
    code = (f"from pathlib import Path\nfrom portbench import run\n"
            f"from portbench.harness import cells\n"
            f"cell = cells.load('uhf_gfsk.wb64', Path({str(tiny_root)!r}))\n"
            f"run.run(cell, 7, 0.2, False, device='cpu', n_batches=4)\n"
            f"assert run.forbidden_modules() == [], run.forbidden_modules()")
    mods = _top_level(code)
    assert "pycusdr_tpu_torch" in mods and not mods & JAX_SIDE


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pycusdr_tpu_torch.fake", object())
    assert run.forbidden_modules() == sorted(JAX_SIDE & {m.split(".")[0] for m in sys.modules})
    assert "pycusdr_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pycusdr_tpu.fake", object())
    assert "pycusdr_tpu" in run.forbidden_modules()


def test_no_source_names_the_jax_side():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|pycusdr_tpu)(\.|\s|$)", re.M)
    prog = re.compile(r"^\s*(import|from)\s+pycusdr_tpu_torch", re.M)
    for path in (ROOT / "portbench").rglob("*.py"):
        text = path.read_text()
        assert not pat.search(text), path
        if path.parent.name == "reference":
            assert not prog.search(text), path


def test_without_a_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "uhf_gfsk.c64",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
