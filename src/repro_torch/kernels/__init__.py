"""Hand-written CUDA kernels of the decode and prefill tiers, their plain
PyTorch versions, and the shape-dispatching inference linears (``ops``)."""
