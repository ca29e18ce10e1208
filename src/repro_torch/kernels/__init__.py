"""Hand-written CUDA kernels of the decode and prefill tiers and of paged
attention, their plain PyTorch versions, and the shape-dispatching
inference linears and attention gates (``ops``)."""
