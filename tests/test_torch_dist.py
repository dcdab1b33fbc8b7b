"""phi_tpu_torch/parallel/dist.py against phi_tpu/parallel/dist.py:
read_shard_bounds on tests/test_dist.py's cases, the single-process merge,
and a two-process gloo spectrum union, each process holding a disjoint
local spectrum, that must give both processes tests/test_dist.py's
union."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from phi_tpu.parallel import dist as jdist  # noqa: E402
from phi_tpu_torch.parallel import dist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args,want", [
    ((10, 0, 3), (0, 4)), ((10, 1, 3), (4, 8)), ((10, 2, 3), (8, 10)),
    ((3, 2, 4), (2, 3)), ((0, 1, 4), (0, 0))])
def test_read_shard_bounds(args, want):
    assert dist.read_shard_bounds(*args) == want
    assert jdist.read_shard_bounds(*args) == want


def test_initialize_single_process():
    assert dist.initialize() == (0, 1)


def test_merge_spectra_single_process():
    hi = np.array([2, 1, 1, 1], np.uint32)
    lo = np.array([5, 9, 3, 9], np.uint32)
    mh, ml = dist.merge_spectra(hi, lo)
    jh, jl = jdist.merge_spectra(hi, lo)
    assert mh.dtype == ml.dtype == np.uint32
    np.testing.assert_array_equal(mh, jh)
    np.testing.assert_array_equal(ml, jl)
    assert len(mh) == 3


SCRIPT = r'''
import sys
import numpy as np
from phi_tpu_torch.parallel import dist
port, pid = int(sys.argv[1]), int(sys.argv[2])
assert dist.initialize(f"127.0.0.1:{port}", 2, pid) == (pid, 2)
local = {0: (np.array([1, 5, 9], np.uint32), np.array([2, 6, 10], np.uint32)),
         1: (np.array([3, 5], np.uint32), np.array([4, 6], np.uint32))}[pid]
hi, lo = dist.merge_spectra(*local)
key = (hi.astype(np.uint64) << np.uint64(32)) | lo
print("KEYS", pid, " ".join(map(str, key)))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_spectrum_union():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(port),
                               str(i)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    want = np.unique(np.array([(1 << 32) | 2, (5 << 32) | 6, (9 << 32) | 10,
                               (3 << 32) | 4], np.uint64))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i}: {outs[i][1][-2000:]}"
        line = [ln for ln in outs[i][0].splitlines()
                if ln.startswith(f"KEYS {i} ")]
        assert line, outs[i][0]
        got = np.array(line[0].split()[2:], np.uint64)
        np.testing.assert_array_equal(got, want)
