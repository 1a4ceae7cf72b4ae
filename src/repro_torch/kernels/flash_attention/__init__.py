from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ops import FlashAttention, flash_attention
from repro_torch.kernels.flash_attention.ref import (mha_reference, mha_reference_bwd,
                                                     mha_reference_lse)

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "mha_reference", "mha_reference_bwd", "mha_reference_lse"]
