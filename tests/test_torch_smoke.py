"""`chip_smoke.py` imports only the standard library, torch, numpy and the
port, and without a CUDA device it exits non-zero and prints no result."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def test_smoke_imports_only_torch_and_the_port():
    with open(SMOKE) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    allowed = {"__future__", "ctypes", "json", "os", "re", "subprocess",
               "sys", "time", "numpy", "torch", "phi_tpu_torch"}
    assert roots <= allowed, roots - allowed


def test_smoke_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, SMOKE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no CUDA device" in res.stdout
