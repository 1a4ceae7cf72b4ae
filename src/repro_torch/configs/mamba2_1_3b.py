"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
d_inner = 2*d_model = 4096, head_dim 64 => 64 SSD heads, d_state 128.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import LayerGroup, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=256),
    layer_groups=(LayerGroup("M", 48),),
    source="arXiv:2405.21060; unverified",
)
