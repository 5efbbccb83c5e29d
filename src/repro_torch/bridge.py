"""Carry the JAX package's parameters into the port.

The caller converts the JAX tree to numpy first (``jax.tree.map(np.asarray,
tree)`` keeps ``QuantizedTensor`` nodes and turns their codes and scales
into numpy arrays); this module imports neither ``jax`` nor ``repro``. It
walks nested dicts, tuples and lists and returns the same structure with
torch tensors on ``device``:

  * scan-stacked ``params["layers"]`` (a tuple of per-position dicts whose
    leaves carry a leading n_sp dim) keep their layout;
  * a quantized leaf (any object with ``codes``, ``scales``, ``bits``,
    ``block`` and ``orig_shape``) becomes the port's ``QuantizedTensor``;
  * stacked adapters ((n_sp, n_adapters, ...) leaves) are plain arrays.

``opt_state_to_torch`` carries a JAX ``AdamWState`` (step, mu, nu) across
as the port's, so that both packages can train on from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.quant import QuantizedTensor


def _is_quantized(x) -> bool:
    return all(hasattr(x, a) for a in
               ("codes", "scales", "bits", "block", "orig_shape"))


def to_torch(tree, device: DeviceLike = None):
    """numpy tree (as described above) -> the same tree of torch tensors."""
    device = resolve_device(device)

    def leaf(a):
        # np.array copies: JAX hands out read-only buffers
        return torch.from_numpy(np.array(a, order="C")).to(device)

    def visit(node):
        if _is_quantized(node):
            return QuantizedTensor(codes=leaf(node.codes),
                                   scales=leaf(node.scales),
                                   bits=int(node.bits), block=int(node.block),
                                   orig_shape=tuple(int(d) for d in
                                                    node.orig_shape))
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(visit(v) for v in node)
        if node is None:
            return None
        return leaf(node)

    return visit(tree)


def opt_state_to_torch(state, device: DeviceLike = None):
    """numpy ``AdamWState`` of the JAX package (``jax.tree.map(np.asarray,
    state)``) -> the port's ``optim.adamw.AdamWState`` on ``device``."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=to_torch(np.asarray(state.step, np.int32), device),
                      mu=to_torch(state.mu, device),
                      nu=to_torch(state.nu, device))
