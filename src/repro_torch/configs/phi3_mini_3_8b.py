"""phi3-mini-3.8b [dense] — RoPE SwiGLU, kv=32 => MHA. LongRoPE scaling is not
modeled (plain RoPE; noted in DESIGN.md §9). [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    layer_groups=(LayerGroup("A", 32),),
    source="arXiv:2404.14219; unverified",
)
