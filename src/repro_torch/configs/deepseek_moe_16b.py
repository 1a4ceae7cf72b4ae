"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts;
first layer dense (d_ff 10944). [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import LayerGroup, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    dense_d_ff=10944,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2, d_expert=1408),
    # layer 0 dense MLP, remaining 27 MoE
    layer_groups=(LayerGroup("A", 1, moe_mask="0"), LayerGroup("A", 27, moe_mask="1")),
    source="arXiv:2401.06066; hf",
)
