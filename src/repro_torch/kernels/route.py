"""The one test of which version of a kernel a call takes, by the device of
its tensors: CUDA tensors the hand-written kernel, CPU and ``meta``
tensors the plain PyTorch version (``meta``: the dry-run's walk of shapes,
``launch.dryrun``). Any other device raises. There is no fallback: a CUDA
tensor reaches its kernel or an error."""
from __future__ import annotations

PLAIN_DEVICES = ("cpu", "meta")


def plain(t, op: str) -> bool:
    """True when ``t`` takes ``op``'s plain version, False for its kernel."""
    kind = t.device.type
    if kind in PLAIN_DEVICES:
        return True
    if kind == "cuda":
        return False
    raise RuntimeError(f"{op}: no version for {kind} tensors (the kernel takes cuda, "
                       f"the plain version {' or '.join(PLAIN_DEVICES)})")
