"""gemma2-27b [dense] — local+global alternating attention, logit softcap.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    scale_embedding=True,
    act="gelu",
    # alternating local (sliding-window) / global attention
    layer_groups=(LayerGroup("LG", 23),),
    source="arXiv:2408.00118; hf",
)
