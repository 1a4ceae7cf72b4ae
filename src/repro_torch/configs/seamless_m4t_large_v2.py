"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal. The modality frontend
is a STUB: input_specs() supplies precomputed frame embeddings
(B, frames, d_model); the 24L encoder + 24L cross-attention decoder are real.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import EncoderConfig, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                # decoder layers (encoder layers in EncoderConfig)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    encoder=EncoderConfig(n_layers=24, cross_attn_memory=1024),
    layer_groups=(LayerGroup("A", 24),),
    source="arXiv:2308.11596; hf",
)
