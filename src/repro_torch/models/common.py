"""Shared model-runtime context (``RunCtx`` with its attention mode), device
resolution and small layer primitives, among them the two helpers through
which every layer reads its weights, plain or int8 (``QuantizedLinear``
leaves of ``quant.quantize_params_int8``): ``linear`` for a projection and
``dequant`` for a leaf read outside a matmul. Under a mesh (``RunCtx.mesh``)
a layer holds the shards ``distributed.sharding`` gives it: ``row_linear``
runs a projection whose input dims are split (the local partial product,
then a psum), a column-split projection is ``linear`` on the local columns,
and ``Layout`` carries one entry point call's specs down to the layers.
Under the sequence-parallel rule (``make_rules(seq_shard=True)``) the
residual stream between sublayers holds the rank's part of the sequence
(``Layout.seq``): a sublayer reads the whole sequence (``seq_gather``) and
its row-split partial is reduce-scattered onto the rank's part in place of
the psum (``reduce_out``)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.quant_matmul import w8a16_matmul
from repro_torch.quant.quantize import QuantizedLinear, dequant


@dataclass(frozen=True)
class RunCtx:
    """Threaded through every layer, as in the reference.

    mode: "train" | "prefill" | "decode" | "chunk" — the attention path of
        each layer: flash attention over the whole sequence (train,
        prefill; prefill also fills the dense ring cache), one new token
        over the dense ring or the paged pool (decode), or the serving
        engine's chunk over the paged pool (chunk). ``LM.prefill``,
        ``decode_step`` and ``decode_chunk`` set it themselves.

    moe_strategy: "dropless" (exact token-choice routing over the grouped
        matmul kernel: the serving engine's and the generation API's path,
        and the port's default) | "capacity" (local capacity buffers, dense
        per-expert batched products: the training path). The reference's
        default is "capacity" (``repro/models/common.py:24``); its engine
        and trainer pass their strategy explicitly, and so do the port's.
        | "tp_shardmap" (the paper's baseline TP: experts replicated, the
        expert FFN split on ``tp_axis``, down-projection partials psum'd)
        | "ep_shardmap" (the paper's hybrid TP x EP: experts split on
        ``ep_axis``, all-to-all dispatch and return). Without a mesh these
        two run "capacity", as in the reference; under a mesh only they
        run (``models.moe``).
    remat: recompute each layer in the backward instead of keeping its
        activations (``torch.utils.checkpoint``, as ``jax.checkpoint`` in
        the reference).
    mesh: a bound ``launch.mesh.Mesh`` (None: one process holds every
        weight). Under a mesh every entry point runs inside
        ``distributed.sharding.use_sharding(mesh, rules)`` on the rank's
        shards of the parameters and of a cache from ``init_cache``.
    ep_axis / tp_axis: the mesh axes of the MoE's experts and of its
        expert FFN (the reference's defaults; the Exp4 mesh's are "expert"
        and "tensor").
    quant: "none" | "a2a_int8" (``ep_shardmap``'s all-to-alls carry int8
        rows with a per-row scale).

    There is no backend knob: the kernels' ``ops`` modules dispatch on the
    tensors' device (hand-written CUDA kernel on the card, plain PyTorch on
    the CPU).
    """
    mode: str = "train"
    moe_strategy: str = "dropless"
    remat: bool = False
    mesh: Any = None
    ep_axis: str = "data"
    tp_axis: str = "model"
    quant: str = "none"

    def with_mode(self, mode: str) -> "RunCtx":
        return replace(self, mode=mode)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and there is no
    card, so nothing quietly falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path")
    return dev


def linear(x, w, n_in: int = 1):
    """x (..., *w.shape[:n_in]) contracted with w's first ``n_in`` dims ->
    (..., *w.shape[n_in:]). A plain tensor is an einsum over those dims; a
    ``QuantizedLinear`` goes to the w8a16 matmul on its int8 values, flattened
    to (K, N), with the leaf's scale over its last axis as the row scale
    (K, G): G = 1 for a (K, N) projection, G = heads for (d, H, hd)."""
    if not isinstance(w, QuantizedLinear):
        return torch.tensordot(x, w, dims=n_in)
    in_shape, out_shape = w.q.shape[:n_in], w.q.shape[n_in:]
    K, N = in_shape.numel(), out_shape.numel()
    y = w8a16_matmul(x.reshape(-1, K), w.q.reshape(K, N), row_scale=w.scale.reshape(K, -1))
    return y.reshape(*x.shape[:x.dim() - n_in], *out_shape)


def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    w = dequant(w, dt)
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w.float()).to(dt)


def rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (S,) or (B, S) absolute token positions."""
    B, S, H, hd = x.shape
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions.float()[:, :, None] * freqs           # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def seq_part(t, mesh=None, seq=None):
    """This rank's part of dim 1 (the sequence) of ``t``, which every rank
    along ``seq`` holds whole (``seq`` None: ``t``)."""
    if seq is None:
        return t
    n = t.shape[1] // mesh.count(seq)
    k = mesh.index(seq)
    return t[:, k * n:(k + 1) * n]


def reduce_out(y, mesh=None, axis=None, seq=None):
    """A sublayer's output (B, S, ...) from its partials over the mesh axis
    ``axis`` (None: every rank holds it whole): their psum, or with the
    stream's sequence split on ``seq``, this rank's part of the sum, a
    reduce-scatter where the two split the same axes."""
    from repro_torch.distributed.collectives import psum, reduce_scatter
    from repro_torch.launch.mesh import spec_axes
    if axis is not None and seq is not None and spec_axes(axis) == spec_axes(seq):
        return reduce_scatter(y, mesh, axis, dim=1)
    if axis is not None:
        y = psum(y, mesh, axis)
    return seq_part(y, mesh, seq)


def row_linear(x, w, mesh=None, axis=None, n_in: int = 1, seq=None):
    """``linear`` of a projection whose input dims are split on the mesh
    axis ``axis`` (x and w's rows both local): the local partial product,
    summed over the axis's ranks in its own dtype (``reduce_out``: onto the
    rank's part of the sequence under ``seq``). ``axis`` None: whole."""
    return reduce_out(linear(x, w, n_in), mesh, axis, seq)


def dense_mlp(p, x, act_name: str, mesh=None, axis=None, seq=None):
    """The gated MLP; under a mesh ``wi`` / ``wg`` split by columns and
    ``wo`` by rows on ``axis`` (the spec's "mlp" entry), one psum (a
    reduce-scatter onto the sequence split ``seq``)."""
    act = act_fn(act_name)
    h = linear(x, p["wi"])
    g = linear(x, p["wg"])
    return row_linear(act(g) * h, p["wo"], mesh, axis, seq=seq)


@dataclass
class Layout:
    """One entry point call's layout on this rank of a mesh: the global
    parameter specs (``param_partition_specs``), the cache's specs
    (``cache_partition_specs`` of its global shapes), the mesh axes the
    batch is split on (None: every rank holds every row) and this rank's
    rows, the global per-row inputs a replicated pool write needs, and,
    inside a layer, that layer's parameter and cache specs (``p``, ``c``:
    leading repeat dim included). ``params`` are the specs the layers see:
    under the train rules the FSDP (``embed``) dims are gathered before
    use, ``fsdp`` holds their entries (None: no leaf has one) and ``f`` the
    layer's. ``seq``: the mesh axes the residual stream's sequence is split
    on (the sequence-parallel rule; None: whole), which each sublayer
    gathers (``seq_gather``) and reduce-scatters back (``reduce_out``).
    """
    mesh: Any
    params: Any
    fsdp: Any = None
    cache: Any = None
    batch: Any = None
    B: int = 0
    rows: slice = slice(None)
    glob: Dict[str, Any] = field(default_factory=dict)
    p: Any = None
    c: Any = None
    f: Any = None
    seq: Any = None

    def seq_gather(self, t):
        """The whole sequence (dim 1) of the stream's part ``t``."""
        if self.seq is None:
            return t
        from repro_torch.distributed.collectives import all_gather
        return all_gather(t, self.mesh, self.seq, dim=1)

    def seq_part(self, t):
        """This rank's part of the sequence of ``t``, held whole."""
        return seq_part(t, self.mesh, self.seq)

    def local_rows(self, t):
        """This rank's rows (dim 0) of a global per-row tensor."""
        return t if t is None or self.batch is None else t[self.rows]

    def gather_rows(self, t):
        """Every rank's rows of a per-row tensor, in batch order."""
        if self.batch is None:
            return t
        from repro_torch.distributed.collectives import all_gather
        return all_gather(t, self.mesh, self.batch, dim=0)
