from repro_torch.quant.quantize import (QuantizedLinear, dequant, dequantize_tree,
                                        fp8_cast_tree, kv_dequantize, kv_quantize,
                                        quantize_leaf, quantize_params_int8, quantizable)

__all__ = ["QuantizedLinear", "quantize_params_int8", "dequantize_tree", "dequant",
           "fp8_cast_tree", "kv_quantize", "kv_dequantize", "quantize_leaf", "quantizable"]
