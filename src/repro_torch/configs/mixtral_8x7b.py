"""mixtral-8x7b — the PAPER'S evaluation model (Mistral 8x7B, Jiang et al.
arXiv:2401.04088): 32L d_model=4096 32H GQA kv=8 d_ff=14336 vocab=32000,
8 experts top-2, sliding window 4096 (we model full attention + window flag
off, as Mixtral removed SWA for 8x7B). Used for the Exp4 TP x EP reproduction."""
from repro_torch.configs.base import LayerGroup, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336),
    layer_groups=(LayerGroup("A", 32, moe_mask="1"),),
    source="arXiv:2401.04088; paper's model",
)
