"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2 on
every other layer. Period-8 block: attention at position 4, mamba elsewhere.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import LayerGroup, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=256),
    # 1:7 attn:mamba, MoE every other layer
    layer_groups=(LayerGroup("MMMMAMMM", 4, moe_mask="01010101"),),
    source="arXiv:2403.19887; hf",
)
