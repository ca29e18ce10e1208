"""PyTorch / CUDA port of the pQuant reproduction (``src/repro``).

The package mirrors the JAX package's module layout so each port module
has an obvious counterpart, and keeps its parameter trees leaf for leaf
(``repro_torch.convert`` maps one to the other).  It imports ``torch`` and
nothing of JAX or of ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version (see ``repro_torch.kernels``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
