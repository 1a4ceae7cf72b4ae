from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_reference

__all__ = ["flash_attention", "flash_attention_cuda", "mha_reference"]
