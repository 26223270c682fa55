"""The plain reference: it imports nothing of the port and nothing of JAX,
agrees with the port at a tiny size on the CPU, and on the card tells the
control (the reference in TF32 in the program's place) from the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import control
from h100_bench.harness import FORBIDDEN_MODULES, load_cell

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
REPO = REFERENCE.parents[1]
CELLS = ["mix.pair_new", "mix.pair_post_opt", "wavlm_only.pair_new", "mix.train_step"]
BANNED = set(FORBIDDEN_MODULES) | {"knnsvc_torch"}


def test_reference_imports_nothing_of_the_port():
    """By whole top-level module name, in the sources and in a process that
    imports every reference module."""
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not {n.split(".")[0] for n in names} & BANNED, (path.name, names)
    mods = [f"h100_bench.reference.{p.stem}" for p in REFERENCE.glob("*.py") if p.stem != "__init__"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, check=True)
    assert not set(eval(p.stdout.strip().splitlines()[-1])) & BANNED


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(tiny_root, workload):
    cell = load_cell(workload, str(tiny_root))
    r = control.readings(workload, 11, "program", device="cpu", root=str(tiny_root))
    for name, limit in cell.limits["limits"].items():
        assert r[name] <= limit, (name, r[name], limit)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit_on_the_card(workload):
    """At the cell's own size: the program within every limit, the control
    over at least one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = json.loads((REFERENCE.parent / "limits" / f"{workload}.json").read_text())["limits"]
    prog = control.readings(workload, 2_718_281_828, "program")
    ctrl = control.readings(workload, 2_718_281_828, "control")
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl
