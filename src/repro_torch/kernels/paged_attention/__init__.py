from repro_torch.kernels.paged_attention.kernel import chunked_prefill_cuda, paged_attention_cuda
from repro_torch.kernels.paged_attention.ops import chunked_prefill_attention, paged_attention
from repro_torch.kernels.paged_attention.ref import (chunked_prefill_partials,
                                                     chunked_prefill_reference, merge_partials,
                                                     paged_attention_reference)

__all__ = ["chunked_prefill_attention", "chunked_prefill_cuda", "chunked_prefill_partials",
           "chunked_prefill_reference", "merge_partials", "paged_attention",
           "paged_attention_cuda", "paged_attention_reference"]
