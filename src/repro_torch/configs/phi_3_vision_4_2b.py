"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUB
(precomputed patch embeddings (B, 576, 1024)); the vision projector is real.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import LayerGroup, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    vision=VisionConfig(n_patches=576, d_patch=1024),
    layer_groups=(LayerGroup("A", 32),),
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
