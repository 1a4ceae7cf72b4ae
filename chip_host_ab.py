#!/usr/bin/env python3
"""Two host-side choices of the port's training slice, each timed against
the code it replaced in one process on the card's machine.

1. ``slicing``: what ``LM._run_groups`` costs the host around its layers
   on a serving call (under ``torch.inference_mode``, over a paged cache):
   the port's loop (each stacked parameter leaf unbound once a group, each
   layer called through a closure) against the loop it replaced (one
   ``t[r]`` view a leaf a layer, copied below as ``parent_run_groups``),
   with ``_apply_layer`` stubbed to return its input, so only the loop is
   timed. Full-width mixtral-8x7b trees (uninitialized bf16 on the card)
   at 8 layers (the serving model of ``chip_smoke.py`` phase 4) and 32
   (phase 7's depth); the two loops alternate, each round the mean of
   CALLS calls, and the medians over ROUNDS rounds are printed.
2. ``ckpt_io``: ``checkpoint.save_checkpoint`` then ``restore_checkpoint``
   of a qwen2.5-3b training state (bf16 parameters, fp32 AdamW moments) cut
   to IO_LAYERS layers (18.6 GB), first with ``ckpt.py`` as it is
   (``np.savez`` / ``np.load`` a shard), then with the npz writer / reader
   it replaced (``streamed_write`` / ``streamed_read`` below: each array's
   bytes streamed through ``zipfile`` in 64 MiB slices), the same shards
   and thread pool; each restore is checked bit for bit against the saved
   tree. Under TMPDIR, on the machine's disk; the two saves write ~37 GB
   (the card's machine ends a call after 45 GiB of writes).

    python3 chip_host_ab.py [OUT_DIR]

Prints the card's name and power limit, one ``HOST-AB`` JSON line, and
writes OUT_DIR/host_ab.json.
"""
import gc
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ROUNDS, CALLS = 31, 20
IO_LAYERS = 16


def parent_run_groups(self, groups_params, x, cache, *, ctx, layer_groups=None, **kw):
    """``LM._run_groups`` before the training slice, verbatim."""
    from repro_torch.models import params as params_lib
    aux_total = 0.0
    for gi, g in enumerate(layer_groups or self.cfg.layer_groups):
        gp = groups_params[gi]["layers"]
        gc = cache["groups"][gi] if cache is not None else None
        for r in range(g.repeats):
            for pos, kind in enumerate(g.pattern):
                # the r-th repeat of the stacked params / caches (views)
                p_r = params_lib.map_tree(lambda t: t[r], gp[pos])
                c_r = params_lib.map_tree(lambda t: t[r], gc[pos]) if gc else None
                x, aux = self._apply_layer(p_r, x, c_r, kind=kind, ctx=ctx, **kw)
                aux_total = aux_total + aux
    return x, aux_total


def streamed_write(path, arrays):
    """An npz file as ``np.savez`` writes it, each array's bytes streamed
    in 64 MiB slices (``ckpt.py``'s writer until it went back to
    ``np.savez``)."""
    import zipfile
    import numpy as np
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in arrays.items():
            arr = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_2_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                data = memoryview(arr.reshape(-1).view(np.uint8))
                for off in range(0, len(data), 64 << 20):
                    f.write(data[off:off + (64 << 20)])


def streamed_read(path, names):
    """The named arrays of an npz file, read in 64 MiB slices (``ckpt.py``'s
    reader until it went back to ``np.load``)."""
    import zipfile
    import numpy as np
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in names:
            with zf.open(name + ".npy") as f:
                version = np.lib.format.read_magic(f)
                read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                               else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read_header(f)
                arr = np.empty(shape, dtype=dtype, order="F" if fortran else "C")
                dst = memoryview(arr.reshape(-1, order="A").view(np.uint8))
                off = 0
                while off < len(dst):
                    n = f.readinto(dst[off:off + (64 << 20)])
                    if not n:
                        raise ValueError(f"{path}: {name} ends early")
                    off += n
                out[name] = arr
    return out


def slicing(dev) -> dict:
    import torch
    from repro_torch.configs import LayerGroup, get_config
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.params import map_tree, param_specs
    out = {}
    for layers in (8, 32):
        cfg = get_config("mixtral-8x7b").scaled(name=f"mixtral-8x7b-{layers}L", n_layers=layers,
                                                layer_groups=(LayerGroup("A", layers),))
        model = build_model(cfg)
        params = map_tree(lambda s: torch.empty(s.shape, dtype=torch.bfloat16, device=dev),
                          param_specs(cfg))
        cache = model.init_cache(4, 0, torch.bfloat16, kind="paged", num_pages=64, device=dev)
        model._apply_layer = lambda p, x, c, **kw: (x, 0.0)
        x = torch.zeros((4, 1, cfg.d_model), dtype=torch.bfloat16, device=dev)
        ctx = RunCtx(mode="chunk")
        kw = dict(ctx=ctx, positions=torch.zeros((4, 1), dtype=torch.int32, device=dev))
        loops = {"parent": lambda: parent_run_groups(model, params["groups"], x, cache, **kw),
                 "change": lambda: model._run_groups(params["groups"], x, cache, **kw)}
        times = {k: [] for k in loops}
        with torch.inference_mode():
            for _ in range(3):
                for fn in loops.values():
                    fn()
            for _ in range(ROUNDS):
                for k, fn in loops.items():
                    t0 = time.perf_counter()
                    for _ in range(CALLS):
                        fn()
                    times[k].append((time.perf_counter() - t0) / CALLS * 1e6)
        out[cfg.name] = {f"{k}_us": statistics.median(v) for k, v in times.items()}
        out[cfg.name].update({f"{k}_us_min": min(v) for k, v in times.items()})
        del params, cache, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ckpt_io() -> dict:
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import LayerGroup, get_config
    from repro_torch.models.params import map_tree, param_specs, tree_leaves
    from repro_torch.training.optimizer import adamw_init
    cfg = get_config("qwen2.5-3b").scaled(name=f"qwen2.5-3b-{IO_LAYERS}L", n_layers=IO_LAYERS,
                                          layer_groups=(LayerGroup("A", IO_LAYERS),))
    params = map_tree(lambda s: torch.empty(s.shape, dtype=torch.bfloat16).fill_(0.5),
                      param_specs(cfg))
    opt = adamw_init(params)
    for t in tree_leaves(opt.m) + tree_leaves(opt.v):
        t.fill_(0.25)
    tree = (params, (opt, None))
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    own = (ckpt._write_npz, ckpt._read_npz)
    out = dict(config=cfg.name, gb=nbytes / 1e9)
    for name, (write, read) in (("np_savez_load", own),
                                ("streamed_zip", (streamed_write, streamed_read))):
        ckpt._write_npz, ckpt._read_npz = write, read
        root = Path(tempfile.mkdtemp(prefix="host_ab_ckpt_"))
        try:
            t0 = time.perf_counter()
            ckpt.save_checkpoint(str(root), 1, tree)
            t1 = time.perf_counter()
            restored, _ = ckpt.restore_checkpoint(str(root), tree)
            t2 = time.perf_counter()
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                         tree_leaves(restored)))
            assert same, f"{name}: the restored tree differs from the saved one"
            out[name] = dict(save_s=t1 - t0, restore_s=t2 - t1,
                             save_gb_s=nbytes / 1e9 / (t1 - t0),
                             restore_gb_s=nbytes / 1e9 / (t2 - t1))
            del restored
        finally:
            ckpt._write_npz, ckpt._read_npz = own
            shutil.rmtree(root, ignore_errors=True)
        gc.collect()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_host_ab: no CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(".")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    res = dict(card=card, slicing=slicing(dev))
    print("slicing", json.dumps(res["slicing"]), flush=True)
    res["ckpt_io"] = ckpt_io()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "host_ab.json").write_text(json.dumps(res, indent=1))
    print("HOST-AB", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
