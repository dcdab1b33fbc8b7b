"""`chip_smoke.py` imports only the standard library, torch, numpy and the
port, and without a CUDA device it exits non-zero and prints no result; its
ptxas report names each kernel instantiation of `csrc/rows.cu`."""

import ast
import importlib.util
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
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch",
                                              "phi_tpu_torch"}
    assert roots <= allowed, roots - allowed
    assert {"phi_tpu", "jax"}.isdisjoint(roots)


def test_smoke_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, SMOKE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no CUDA device" in res.stdout


def smoke_module():
    """chip_smoke.py as a module (its main() does not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The five kernels of csrc/rows.cu as the Itanium C++ ABI mangles them
# (y: unsigned long long, Lb1E: true; g++ gives the same names for the same
# templates): the namespace, tiled_kernel<K, COMPACT, POS, NCODE>, the
# parameters.
_NS, _PARAMS = "_ZN12_GLOBAL__N_1", "EvNS_6RowsInENS_7RowsOutE"
_MANGLED = {
    "rows3": "12tiled_kernelIyLb1ELb0ELb0EE",
    "rows3w": "12tiled_kernelINS_7Key128vELb1ELb0ELb0EE",
    "rows2": "12tiled_kernelIyLb0ELb0ELb0EE",
    "rows": "12tiled_kernelIyLb0ELb1ELb0EE",
    "seq": "12tiled_kernelIyLb0ELb1ELb1EE",
}


def test_ptxas_report_names_every_instantiation():
    """A -Xptxas -v log of the five kernels (each with its own register
    count, all but the first with a spill) is parsed to the five entry
    point names, each with its own lines."""
    smoke = smoke_module()
    lines = []
    for i, kern in enumerate(_MANGLED.values()):
        sym = _NS + kern + _PARAMS
        lines += [f"ptxas info    : Compiling entry function '{sym}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {sym}",
                  f"    0 bytes stack frame, {4 * i} bytes spill stores, "
                  f"{4 * i} bytes spill loads",
                  f"ptxas info    : Used {40 + i} registers, used 1 "
                  f"barriers, 32 bytes smem, 400 bytes cmem[0]"]
    report = smoke.ptxas_report("\n".join(lines))
    assert sorted(report) == sorted(smoke.KERNELS)
    assert sorted(_MANGLED) == sorted(smoke.KERNELS)
    for i, name in enumerate(_MANGLED):
        used, spill = report[name]
        assert used.startswith(f"Used {40 + i} registers"), name
        assert smoke.spills(spill) == (i > 0), name
    assert smoke.kernel_name("_Z3fooi") == "_Z3fooi"
