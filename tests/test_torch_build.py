"""The kernel build under threads: replica threads that reach a kernel at
once must share one ``nvcc`` run and one loaded library, and concurrent
builds must never write through one temporary file. ``nvcc`` and the loader
are stubbed, so this runs without the CUDA toolkit."""
import sys
import threading
import time

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
    """``build`` itself takes no lock: racing callers may each compile, but
    each into its own temporary file, renamed atomically into place."""
    compiles, _ = stubbed
    _together(lambda: build.build(["quant_matmul"]))
    assert len(compiles) >= 1
    assert len(set(compiles)) == len(compiles)
    assert build.library_path("quant_matmul").read_bytes() == b"\x7fELF"
    assert not list(build.BUILD_DIR.glob("*.tmp"))
