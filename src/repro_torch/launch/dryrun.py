"""Dry-run of the production meshes: one rank's program walked on ``meta``
tensors, the port's counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, on the single-pod (16, 16) and
multi-pod (2, 16, 16) meshes, the reference lowers and compiles the whole
SPMD step over 512 fake XLA devices and reads XLA's memory and cost
analyses. PyTorch has no ahead-of-time compile over abstract devices, so
the port runs **one rank's** program instead: the mesh is placed at that
rank (``Mesh.at``), the rank's parameters, cache and batch are ``meta``
tensors of their local shapes (taken from the same specs the ranks shard
by), and the model's own entry points run on them, every kernel op taking
its plain version (``kernels.route``) and every collective standing in for
its result (``distributed.collectives.record_collectives``). Nothing is
initialised and nothing is computed; the walk proves that the rank's
program runs at these shapes and counts what it does:

- ``record_collectives``: each collective's kind, result bytes and axis;
- ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of the aten ops;
- ``OpCounter`` (here): each op's input and output bytes, and the peak of
  the storages the step creates and has not yet freed.

Layers run one by one (no scan), so every layer is counted and no affine
calibration from probes is needed: ``cost.n_probes`` is 1.

The cell is the reference's: the same rules (``make_rules(mode, moe=,
multi_pod=, seq_shard=, tensor_axis=, expert_axis=)``), MoE strategy
(``tp_shardmap`` / ``ep_shardmap``), inputs (``input_shapes``, with
``DEC_START`` decoder tokens for the enc-dec prefill) and dense caches.
The train cell runs the whole step under ``TrainConfig(remat=True,
xent_chunk=, microbatches=)``: loss, backward, the gradient reduction and
AdamW, on float32 parameters and moments. The decode cell with ``--quant
int8`` runs on the int8 tree sharded by ``param_partition_specs(...,
quant="int8")``; the reference dequantizes that tree and runs
``decode_step``, and the port's int8 path (the w8a16 matmul and the int8
grouped matmul) computes the same function, so the walk runs the port's
int8 path.

``--device cuda`` is the memory proof on the card: the same rank's shards
are drawn on the card from a seeded generator, scaled as ``init_params``
scales them (``params.draw_leaf``), and the step runs through the hand
kernels, its collectives standing in as on ``meta`` (one card holds one
rank). Its values are not the sharded program's: only its shapes,
memory and launches are.

The JSON keeps the reference's keys (``dryrun.py:302-377`` there); in the
port they mean:

- ``sizes.params_local_bytes`` / ``cache_local_bytes``: the rank's bytes
  of the parameter and cache trees, each leaf's size over the product of
  its spec's axes (``roofline.local_bytes``);
- ``memory.argument_bytes``: the rank's parameters, cache (or AdamW
  moments and step) and batch rows; ``output_bytes``: the step's outputs
  that are not its arguments returned in place (the logits, the metrics);
  ``temp_bytes``: the peak of the storages the step created and still
  held, an upper bound: the plain versions run where the kernels would, so
  plain attention's (S x S) scores count at prefill and train;
- ``compiled_ok``: the walk ran to its end; ``lower_s``: the seconds of
  building the cell and walking it; ``compile_s``: 0.0 on ``meta`` (nothing
  is compiled), on ``cuda`` the first step's seconds (kernel builds);
- ``cost``: ``flops`` and ``bytes_accessed`` of the walk, ``n_probes`` 1;
  ``collectives``: ``roofline.collective_bytes`` of the log;
- ``roofline``: the H100's terms (``roofline.H100_SXM``, data sheet
  figures), ``bound_s`` the largest, ``memory_floor_s`` the rank's weights
  and cache read once over its HBM bandwidth;
- ``model_flops_global`` / ``_per_dev``, ``useful_ratio`` (the per-rank
  model FLOPs over the walk's) and ``roofline_fraction`` (their time at
  the bf16 peak over the bound);
- ``skipped``: ``shape_applicable``'s reason.

Run one cell:  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
Run every one: python -m repro_torch.launch.dryrun --all   (one process)
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.collectives import record_collectives
from repro_torch.distributed.sharding import (PartitionSpec, local_shape, make_rules,
                                              param_partition_specs, partition_spec,
                                              use_sharding)
from repro_torch.launch.mesh import make_moe_mesh, make_production_mesh
from repro_torch.launch.roofline import (H100_SXM, collective_bytes, local_bytes,
                                         model_flops, roofline)
from repro_torch.models import RunCtx, build_model
from repro_torch.models.common import resolve_device
from repro_torch.models.params import ParamSpec, draw_leaf, map_tree, tree_leaves
from repro_torch.quant.quantize import QuantizedLinear, quantize_leaf

DEC_START = 64          # enc-dec decoder segment length for prefill cells
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
_BATCH_LOGICAL = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                  "patches": ("batch", None, None), "frames": ("batch", "seq", None),
                  "positions": ("batch",)}


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """(global shape, dtype) of every model input of this cell, as the
    reference's ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        if cfg.vision is not None:
            S_text = S - cfg.vision.n_patches
            return {"tokens": ((B, S_text), i32), "labels": ((B, S_text), i32),
                    "patches": ((B, cfg.vision.n_patches, cfg.vision.d_patch), bf16)}
        if cfg.encoder is not None:
            return {"tokens": ((B, S), i32), "labels": ((B, S), i32),
                    "frames": ((B, S, cfg.d_model), bf16)}
        return {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.vision is not None:
            S_text = S - cfg.vision.n_patches
            return {"tokens": ((B, S_text), i32),
                    "patches": ((B, cfg.vision.n_patches, cfg.vision.d_patch), bf16)}
        if cfg.encoder is not None:   # encode S frames, prefill a short decoder start
            return {"tokens": ((B, DEC_START), i32), "frames": ((B, S, cfg.d_model), bf16)}
        return {"tokens": ((B, S), i32)}
    # decode: one new token against a seq_len cache
    return {"tokens": ((B, 1), i32), "positions": ((B,), i32)}


# --------------------------------------------------------------------------
# The cell: one rank's inputs and its step
# --------------------------------------------------------------------------
@dataclass
class Cell:
    """One rank's step of a cell: ``run()`` runs it once on ``args``.
    ``sizes`` and ``argument_bytes`` as the module's note says."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    rules: Any
    fn: Callable[..., Any]
    args: tuple
    sizes: Dict[str, int]
    argument_bytes: int
    grad: bool = False

    def run(self):
        with use_sharding(self.mesh, self.rules):
            if self.grad:
                return self.fn(*self.args)
            with torch.inference_mode():
                return self.fn(*self.args)


def _leaf(spec: ParamSpec, pspec, mesh, device, dtype, gen):
    """The rank's shard of one parameter: a ``meta`` tensor of its local
    shape, or on a device drawn by ``draw_leaf``; an int8 leaf where the
    spec is a ``QuantizedLinear`` of specs."""
    quant = isinstance(pspec, QuantizedLinear)
    local = local_shape(spec.shape, pspec.q if quant else pspec, mesh)
    if device.type == "meta":
        if quant:
            return QuantizedLinear(torch.empty(local, dtype=torch.int8, device=device),
                                   torch.empty(local[:-1] + (1,), dtype=torch.float32,
                                               device=device))
        return torch.empty(local, dtype=dtype, device=device)
    w = draw_leaf(spec, local, gen, device, dtype)
    return quantize_leaf(w) if quant else w


def _batch(cfg, shape, device, gen, vocab_hi: int) -> Dict[str, torch.Tensor]:
    """The global batch (the model takes the rank's rows itself), the same
    on every rank: token ids below ``vocab_hi`` (the first block of a
    vocab-split embedding, so the first rank's lookups are its own),
    positions 0 (the slot a ring split on the sequence keeps on its first
    rank), stub frames and patches from a normal; empty tensors on
    ``meta``."""
    out = {}
    for name, (shp, dt) in input_shapes(cfg, shape).items():
        if device.type == "meta":
            out[name] = torch.empty(shp, dtype=dt, device=device)
        elif name == "positions":
            out[name] = torch.zeros(shp, dtype=dt, device=device)
        elif dt == torch.int32:
            out[name] = torch.randint(0, vocab_hi, shp, generator=gen, dtype=dt, device=device)
        else:
            out[name] = torch.randn(shp, generator=gen, dtype=torch.float32,
                                    device=device).to(dt)
    return out


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, moe_mode: str = "tp",
               seq_shard: bool = False, quant: str = "none", xent_chunk: int = 0,
               microbatches: int = 1, device: str = "meta", rank: int = 0) -> Cell:
    """One rank's cell (the reference's ``build_cell`` for one rank).
    ``mesh``: a shape-only mesh, placed here at ``rank``, or a mesh already
    bound to a process group (or placed), taken as it is."""
    multi_pod = "pod" in mesh.axis_names
    factored = "tensor" in mesh.axis_names           # Exp4 mesh (data, expert, tensor)
    tensor_axis = "tensor" if factored else "model"
    expert_axis = "expert" if factored else None
    mode = "train" if shape.kind == "train" else "serve"
    rules = make_rules(mode, moe=moe_mode, multi_pod=multi_pod, seq_shard=seq_shard,
                       tensor_axis=tensor_axis, expert_axis=expert_axis)
    strategy = ({"tp": "tp_shardmap", "ep": "ep_shardmap"}[moe_mode]
                if cfg.moe is not None else "capacity")
    if not mesh.bound and not mesh.placed:
        mesh = mesh.at(rank)
    dev = torch.device(device) if device == "meta" else resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg)
    ctx = RunCtx(mode=shape.kind, mesh=mesh,
                 moe_strategy=strategy, remat=mode == "train", ep_axis=expert_axis or "data",
                 tp_axis=tensor_axis, quant="a2a_int8" if quant == "a2a_int8" else "none")
    int8 = quant == "int8" and shape.kind == "decode"
    dtype = torch.float32 if mode == "train" else torch.bfloat16
    specs = model.param_specs()
    pspecs = param_partition_specs(specs, mesh, rules, quant="int8" if int8 else "none")
    flat_specs, flat_p = [], []
    map_tree(flat_specs.append, specs, is_leaf=lambda x: isinstance(x, ParamSpec))
    map_tree(flat_p.append, pspecs,
             is_leaf=lambda x: isinstance(x, (PartitionSpec, QuantizedLinear)))
    it = iter(zip(flat_specs, flat_p))
    params = map_tree(lambda s: _leaf(*next(it), mesh, dev, dtype, gen), specs,
                      is_leaf=lambda x: isinstance(x, ParamSpec))

    def abstract(s):       # the global leaf, as the reference's abstract_params
        return torch.empty(s.shape, dtype=dtype, device="meta")
    whole = map_tree(abstract, specs, is_leaf=lambda x: isinstance(x, ParamSpec))
    if int8:
        it = iter(flat_p)
        whole = map_tree(lambda t: (QuantizedLinear(
            torch.empty(t.shape, dtype=torch.int8, device="meta"),
            torch.empty(tuple(t.shape[:-1]) + (1,), dtype=torch.float32, device="meta"))
            if isinstance(next(it), QuantizedLinear) else t), whole)
    sizes = {"params_local_bytes": local_bytes(whole, pspecs, mesh)}
    embed = pspecs["embed"]["w"]
    vocab_split = (embed.q if isinstance(embed, QuantizedLinear) else embed)[0]
    batch = _batch(cfg, shape, dev, gen, cfg.vocab // mesh.count(vocab_split))
    batch_bytes = sum(local_bytes({k: v}, {k: partition_spec(
        tuple(v.shape), _BATCH_LOGICAL[k], mesh, rules)}, mesh) for k, v in batch.items())

    if shape.kind == "train":
        from repro_torch.training.train_step import TrainConfig, make_train_step
        init_fn, step_fn = make_train_step(
            model, TrainConfig(remat=True, xent_chunk=xent_chunk, microbatches=microbatches),
            ctx)
        state = init_fn(params)
        args = (params, state, batch)
        return Cell(cfg, shape, mesh, rules, step_fn, args, sizes,
                    _tensor_bytes(params) + _tensor_bytes(state) + batch_bytes, grad=True)

    mem_len = 0
    if cfg.encoder is not None:
        mem_len = shape.seq_len if shape.kind == "prefill" else cfg.encoder.cross_attn_memory
    kw = dict(kind="dense", memory_len=mem_len)
    with use_sharding(mesh, rules):
        cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16, device=dev,
                                 **kw)
    with use_sharding(None, None):
        whole_cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16,
                                       device="meta", **kw)
    sizes["cache_local_bytes"] = local_bytes(whole_cache, cache.specs, mesh)
    arg_bytes = _tensor_bytes(params) + _tensor_bytes(dict(cache)) + batch_bytes
    if shape.kind == "prefill":
        def fn(params, batch, cache):
            return model.prefill(params, batch, cache, ctx)
        return Cell(cfg, shape, mesh, rules, fn, (params, batch, cache), sizes, arg_bytes)

    def fn(params, tokens, cache, positions):
        return model.decode_step(params, tokens, cache, positions, ctx)
    return Cell(cfg, shape, mesh, rules, fn,
                (params, batch["tokens"], cache, batch["positions"]), sizes, arg_bytes)


# --------------------------------------------------------------------------
# The walk: collectives, FLOPs, bytes and the peak of live intermediates
# --------------------------------------------------------------------------
_PARTIAL_WRITES = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
                   "index_fill_", "scatter_", "scatter_add_", "scatter_reduce_",
                   "masked_scatter_"}


def _sid(t) -> int:
    return t.untyped_storage()._cdata


def _read_bytes(t) -> int:
    """A tensor's bytes, read once: its elements, at most its storage's
    (an expanded view reads its storage, not its elements)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class OpCounter(TorchDispatchMode):
    """Sums each aten op's input and output bytes (``bytes``), an op whose
    outputs alias an input (a view, ``expand``, ``transpose``,
    ``as_strided``) counting nothing, an in-place op its written operand
    once (a scatter-like partial write only the values it writes); and
    tracks the storages ops create (``weakref.finalize`` on each, which
    works on ``meta`` too): ``peak`` is the most bytes of them alive at
    once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live: Dict[int, int] = {}
        self.cur = self.peak = 0

    def _free(self, sid: int) -> None:
        self.cur -= self.live.pop(sid, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        in_sids = {_sid(t) for t in ins}
        written = [a for a, arg in zip(args, func._schema.arguments)
                   if isinstance(a, torch.Tensor) and arg.alias_info is not None
                   and arg.alias_info.is_write]
        if not written and outs and all(_sid(t) in in_sids for t in outs):
            return out                                # an alias of its input
        written_sids = {_sid(t) for t in written}
        nbytes = sum(_read_bytes(t) for t in ins if _sid(t) not in written_sids)
        if written:
            if func._schema.name.split("::")[-1] in _PARTIAL_WRITES:
                nbytes += sum(_read_bytes(t) for t in ins if _sid(t) not in written_sids
                              and t.dtype != torch.int64 and t.dtype != torch.bool)
            else:
                nbytes += sum(_read_bytes(t) for t in written)
        for t in outs:
            sid = _sid(t)
            if sid in in_sids:
                continue
            nbytes += _read_bytes(t)
            if sid not in self.live:
                n = t.untyped_storage().nbytes()
                self.live[sid] = n
                self.cur += n
                self.peak = max(self.peak, self.cur)
                weakref.finalize(t.untyped_storage(), self._free, sid)
        self.bytes += nbytes
        return out


@dataclass
class Walk:
    out: Any
    log: List[tuple] = field(default_factory=list)
    flops: int = 0
    bytes_accessed: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    seconds: float = 0.0


def walk(cell: Cell, count: bool = True) -> Walk:
    """Runs ``cell``'s step once under ``record_collectives``, the FLOP
    counter (``count``) and ``OpCounter``."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    ops = OpCounter()
    flop_mode = FlopCounterMode(display=False) if count else None
    with record_collectives() as log:
        if flop_mode is not None:
            with flop_mode, ops:
                out = cell.run()
        else:
            with ops:
                out = cell.run()
    seen = {_sid(t) for t in tree_leaves(cell.args) if isinstance(t, torch.Tensor)}
    out_bytes = 0
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor) and _sid(t) not in seen:
            seen.add(_sid(t))
            out_bytes += t.untyped_storage().nbytes()
    return Walk(out=out, log=list(log), flops=flop_mode.get_total_flops() if count else 0,
                bytes_accessed=ops.bytes, temp_bytes=ops.peak, output_bytes=out_bytes,
                seconds=time.perf_counter() - t0)


def card_steps(cell: Cell, steps: int = 3) -> Dict[str, Any]:
    """On the card: the median seconds of ``steps`` more runs of a cell
    built on ``cuda`` (its collectives standing in, as in the walk), and
    the card's peak allocation since its last reset."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_collectives():
            cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"step_s_median": statistics.median(times), "steps": steps,
            "max_allocated_bytes": torch.cuda.max_memory_allocated()}


def profile_step(cell: Cell, top: int = 12) -> Dict[str, Any]:
    """On the card: one more run of the cell under ``torch.profiler``: the
    step's wall and device-busy milliseconds, the aten ops the host
    dispatched, and the ``top`` device times by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_collectives():
            cell.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, ops = [], 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, dev_us / 1e3, e.count))
        if e.key.startswith("aten::") and e.device_type == torch.autograd.DeviceType.CPU:
            ops += e.count
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_busy_ms": sum(r[1] for r in rows), "aten_ops": ops,
            "top": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:top]]}


# --------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, *, multi_pod: bool, moe_mode: str = "tp",
             seq_shard: bool = False, skip_cost: bool = False, quant: str = "none",
             exp4: Optional[str] = None, xent_chunk: int = 0, microbatches: int = 1,
             device: str = "meta", rank: int = 0, profile: bool = False) -> Dict[str, Any]:
    """One cell's JSON (the module's note). ``skip_cost``: the walk counts
    no FLOPs and the JSON has no ``cost`` / ``roofline``, as the
    reference's compile-only cells. ``profile`` (on ``cuda``): a profiled
    step's device time by kernel under ``card.profile``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    meta: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "multi_pod": multi_pod, "mode": shape.kind,
                            "moe": moe_mode if cfg.moe is not None else None,
                            "seq_shard": seq_shard, "quant": quant,
                            "exp4": exp4, "xent_chunk": xent_chunk,
                            "microbatches": microbatches, "rank": rank, "device": device}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        meta["skipped"] = why
        return meta
    if exp4:
        ep, tp = (int(x) for x in exp4.split("x"))
        mesh = make_moe_mesh(ep, tp, chips=256)
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    meta["mesh"] = list(mesh.devices.shape)

    t0 = time.perf_counter()
    cuda = device != "meta" and resolve_device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    cell = build_cell(cfg, shape, mesh, moe_mode=moe_mode, seq_shard=seq_shard, quant=quant,
                      xent_chunk=xent_chunk, microbatches=microbatches, device=device,
                      rank=rank)
    placed = torch.cuda.memory_allocated() - base if cuda else None
    w = walk(cell, count=not skip_cost)
    meta["lower_s"] = time.perf_counter() - t0
    meta["compile_s"] = w.seconds if cuda else 0.0
    meta["sizes"] = cell.sizes
    meta["memory"] = {"argument_bytes": cell.argument_bytes, "output_bytes": w.output_bytes,
                      "temp_bytes": w.temp_bytes}
    meta["compiled_ok"] = True
    meta["collectives"] = collective_bytes(w.log)
    if cuda:
        meta["card"] = {"name": torch.cuda.get_device_name(0),
                        "allocated_after_inputs_bytes": placed, **card_steps(cell)}
        if profile:
            meta["card"]["profile"] = profile_step(cell)
    if skip_cost:
        return meta

    meta.update(cell_costs(cell, w))
    return meta


def cell_costs(cell: Cell, w: Walk) -> Dict[str, Any]:
    """The JSON's cost keys of a walk of ``cell`` that counted FLOPs:
    ``cost``, ``roofline`` (with ``memory_floor_s``), the model FLOPs,
    ``useful_ratio`` and ``roofline_fraction``."""
    n_dev = cell.mesh.size
    terms = roofline(w.flops, w.bytes_accessed, collective_bytes(w.log)["total"])
    # memory floor: weights read once + cache streamed once (the fused lower
    # bound); bytes_accessed counts every op's operands, the upper bound
    floor_bytes = cell.sizes["params_local_bytes"] + cell.sizes.get("cache_local_bytes", 0)
    mf = model_flops(cell.cfg, cell.shape)
    ideal_s = (mf / n_dev) / H100_SXM["peak_flops_bf16"]
    return {"cost": {"flops": float(w.flops), "bytes_accessed": float(w.bytes_accessed),
                     "n_probes": 1},
            "roofline": dict(terms.as_dict(), memory_floor_s=floor_bytes / H100_SXM["hbm_bw"],
                             bound_s=terms.bound_s, hw=H100_SXM["name"]),
            "model_flops_global": mf, "model_flops_per_dev": mf / n_dev,
            "useful_ratio": (mf / n_dev) / w.flops if w.flops else 0.0,
            "roofline_fraction": ideal_s / terms.bound_s if terms.bound_s > 0 else 0.0}


def _tag(arch, shape, mesh_kind, args) -> str:
    tag = f"{arch}__{shape}__{mesh_kind}__{args.moe}"
    if args.seq_shard:
        tag += "__seqshard"
    if args.quant != "none":
        tag += f"__{args.quant}"
    if args.exp4:
        tag += f"__exp4_{args.exp4}"
    if args.xent_chunk:
        tag += f"__xc{args.xent_chunk}"
    if args.microbatches > 1:
        tag += f"__mb{args.microbatches}"
    if args.device != "meta":
        tag += f"__{args.device}"
    return tag


def _cell(args, arch, shape, mesh_kind, skip_cost):
    return run_cell(arch, shape, multi_pod=mesh_kind == "pod", moe_mode=args.moe,
                    seq_shard=args.seq_shard, skip_cost=skip_cost, quant=args.quant,
                    exp4=args.exp4, xent_chunk=args.xent_chunk,
                    microbatches=args.microbatches, device=args.device, rank=args.rank,
                    profile=args.profile)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=ALL_SHAPES + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "pod"])
    ap.add_argument("--moe", default="tp", choices=["tp", "ep"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="walk every cell of both meshes in this process")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-cost", action="store_true",
                    help="the walk and memory only (no FLOPs, no roofline)")
    ap.add_argument("--quant", default="none", choices=["none", "int8", "a2a_int8"],
                    help="int8 weight-only serving quant, or int8-compressed "
                         "MoE all-to-all dispatch (decode cells)")
    ap.add_argument("--exp4", default=None,
                    help="factored Exp4 mesh 'EPxTP' e.g. 4x4 (256 ranks)")
    ap.add_argument("--xent-chunk", type=int, default=0,
                    help=">0: sequence-chunked cross-entropy (train cells)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help=">1: gradient accumulation (train cells)")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: the walk of shapes; cuda: the memory proof on the card")
    ap.add_argument("--rank", type=int, default=0, help="the rank of the mesh walked")
    ap.add_argument("--profile", action="store_true",
                    help="with --device cuda: a profiled step's device time by kernel")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        failures = []
        t_all = time.perf_counter()
        for mesh_kind in ("single", "pod"):
            for arch in ALL_ARCHS:
                for shape in ALL_SHAPES:
                    tag = _tag(arch, shape, mesh_kind, args)
                    out_file = os.path.join(args.out, tag + ".json")
                    if os.path.exists(out_file):
                        print(f"[skip] {tag} (cached)")
                        continue
                    t0 = time.perf_counter()
                    try:
                        # the multi-pod pass proves the pod axis shards; the
                        # roofline table is single-pod only, as the reference's
                        res = _cell(args, arch, shape, mesh_kind,
                                    args.skip_cost or mesh_kind == "pod")
                    except Exception:                    # noqa: BLE001 - reported, then the next
                        failures.append(tag)
                        print(f"[FAIL] {tag}\n{traceback.format_exc()[-3000:]}", flush=True)
                        continue
                    with open(out_file, "w") as f:
                        json.dump(res, f, indent=1)
                    print(f"[ok  ] {tag} {time.perf_counter() - t0:.1f}s", flush=True)
        print(f"done in {time.perf_counter() - t_all:.1f}s; {len(failures)} failures: "
              f"{failures}")
        return 1 if failures else 0

    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape, or --all")
    res = _cell(args, args.arch, args.shape, args.mesh, args.skip_cost)
    with open(os.path.join(args.out, _tag(args.arch, args.shape, args.mesh, args) + ".json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
