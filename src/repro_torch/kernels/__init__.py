"""Hand-written CUDA kernels of the decode tier, their plain PyTorch
versions, and the shape-dispatching inference linears (``ops``)."""
