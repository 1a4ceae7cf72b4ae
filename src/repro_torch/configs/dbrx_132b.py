"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base;
unverified]"""
from repro_torch.configs.base import LayerGroup, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752),
    layer_groups=(LayerGroup("A", 40, moe_mask="1"),),
    source="hf:databricks/dbrx-base; unverified",
)
