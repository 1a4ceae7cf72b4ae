"""Shared model-runtime context (``RunCtx`` with its attention mode), device
resolution and small layer primitives, among them the two helpers through
which every layer reads its weights, plain or int8 (``QuantizedLinear``
leaves of ``quant.quantize_params_int8``): ``linear`` for a projection and
``dequant`` for a leaf read outside a matmul."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Union

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
        The shard_map strategies come with the distribution slice.
    remat: recompute each layer in the backward instead of keeping its
        activations (``torch.utils.checkpoint``, as ``jax.checkpoint`` in
        the reference).

    There is no backend knob: the kernels' ``ops`` modules dispatch on the
    tensors' device (hand-written CUDA kernel on the card, plain PyTorch on
    the CPU).
    """
    mode: str = "train"
    moe_strategy: str = "dropless"
    remat: bool = False

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


def dense_mlp(p, x, act_name: str):
    act = act_fn(act_name)
    h = linear(x, p["wi"])
    g = linear(x, p["wg"])
    return linear(act(g) * h, p["wo"])
