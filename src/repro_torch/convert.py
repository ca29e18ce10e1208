"""Parameter trees between the JAX package and the port.

Both packages keep the same tree (nested dicts and lists with the same
leaf names, shapes and dtypes), so the conversion is a leaf-for-leaf map.
The JAX side hands over numpy (``jax.tree.map(np.asarray, params)``); this
module never imports JAX.  Latent and packed serving trees both convert;
integer leaves keep their dtypes (uint8 sign bits, int8 codes).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """numpy tree -> tensor tree on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree):
    """Tensor tree -> numpy tree (the inverse of :func:`params_from_numpy`)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
