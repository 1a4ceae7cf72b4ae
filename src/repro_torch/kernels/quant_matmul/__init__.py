from repro_torch.kernels.quant_matmul.kernel import w8a16_matmul_cuda
from repro_torch.kernels.quant_matmul.ops import quantize_int8, w8a16_matmul
from repro_torch.kernels.quant_matmul.ref import w8a16_matmul_reference

__all__ = ["w8a16_matmul", "w8a16_matmul_cuda", "w8a16_matmul_reference", "quantize_int8"]
