"""Quantization core: quantizers, bit packing, BitLinear, the decoupled FFN."""
