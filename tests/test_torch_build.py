"""The kernel build under threads and processes: replica threads that
reach a kernel at once must share one ``nvcc`` run and one loaded library,
concurrent builds must never write through one temporary file, and
processes (a mesh's ranks) take the build lock one after the other.
``nvcc`` and the loader are stubbed, so this runs without the CUDA
toolkit."""
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from repro_torch.kernels import build


class _FakeProc:
    """A finished ``nvcc``: writes the library to its ``-o`` path."""

    def __init__(self, cmd, log):
        self.returncode = 0
        self._out = cmd[cmd.index("-o") + 1]
        log.append(self._out)

    def communicate(self):
        time.sleep(0.05)            # widen the window two racing builds would share
        with open(self._out, "wb") as f:
            f.write(b"\x7fELF")
        return "ptxas info    : Used 32 registers", None


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    compiles, loads = [], []
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen",
                        lambda cmd, **kw: _FakeProc(cmd, compiles))

    def cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    build._load.cache_clear()
    yield compiles, loads
    build._load.cache_clear()       # drop the stub libraries before the real loader returns


def _together(fn, n=8):
    """Run ``fn`` on ``n`` threads released at once, switching threads as
    often as the interpreter allows; re-raise any failure."""
    gate = threading.Barrier(n)
    results, errors = [None] * n, []

    def run(i):
        gate.wait()
        try:
            results[i] = fn()
        except Exception as e:              # re-raised in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def test_load_library_from_eight_threads_builds_and_loads_once(stubbed):
    compiles, loads = stubbed
    libs = _together(lambda: build.load_library("moe_gmm"))
    assert len(compiles) == 1 and len(loads) == 1
    assert all(lib is libs[0] for lib in libs)
    assert build.library_path("moe_gmm").exists()
    assert not list(build.BUILD_DIR.glob("*.tmp"))


def test_concurrent_builds_write_distinct_temporary_files(stubbed):
    """Racing callers of ``build`` queue on its file lock, and a compile
    writes into its own temporary file, renamed atomically into place."""
    compiles, _ = stubbed
    _together(lambda: build.build(["quant_matmul"]))
    assert len(compiles) >= 1
    assert len(set(compiles)) == len(compiles)
    assert build.library_path("quant_matmul").read_bytes() == b"\x7fELF"
    assert not list(build.BUILD_DIR.glob("*.tmp"))


_HOLD = """
import sys, time
from pathlib import Path
from repro_torch.kernels.build import build_lock
with build_lock(Path(sys.argv[1])):
    t0 = time.monotonic()
    time.sleep(0.5)
    print(t0, time.monotonic())
"""


def test_build_lock_serializes_processes(tmp_path):
    """Two processes that take the build lock at once hold it one after
    the other: their guarded steps never overlap."""
    root = Path(build.__file__).resolve().parents[2]
    procs = [subprocess.Popen([sys.executable, "-c", _HOLD, str(tmp_path / "kernels")],
                              stdout=subprocess.PIPE, text=True,
                              env={"PYTHONPATH": str(root), "PATH": ""}) for _ in range(2)]
    spans = sorted(tuple(map(float, p.communicate(timeout=60)[0].split())) for p in procs)
    assert all(p.returncode == 0 for p in procs)
    assert spans[0][1] <= spans[1][0], spans
