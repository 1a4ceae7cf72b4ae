from repro_torch.kernels.paged_attention.kernel import chunked_prefill_cuda
from repro_torch.kernels.paged_attention.ops import chunked_prefill_attention
from repro_torch.kernels.paged_attention.ref import chunked_prefill_reference

__all__ = ["chunked_prefill_attention", "chunked_prefill_cuda", "chunked_prefill_reference"]
