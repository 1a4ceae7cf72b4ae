"""Process start to the window's opening: imports, the weights drawn and
quantized, the KV pool, the warm-up of the engine's two call shapes, and
the loop brought to steady state (every client has a first token)."""


def read(run):
    return run.setup_s
