"""Gradients of a loss over a parameter tree, whole or in microbatches.

Counterpart of ``repro/distributed/collectives.py``.
:func:`microbatch_grads` splits a global batch into ``n_micro`` slices taken
one after another, so peak activation memory drops by about ``n_micro``.
The reference scans the slices under SPMD, where each slice's
reduce-scatter overlaps the next one's compute; the port's cells run on one
device, so here nothing is reduced between slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_lib

Tree = Any


def value_and_grad(loss_fn: Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor],
                   params: Tree, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Tree]:
    """``loss_fn(params, batch)`` and its gradient tree, by autograd
    (``jax.value_and_grad``).  The parameters are not changed and their
    ``.grad`` is not touched: the loss runs on detached aliases of them.  A
    leaf the loss does not read gets zeros, as in jax."""
    with torch.enable_grad():
        live = tree_lib.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        flat = tree_lib.leaves(live)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads))
    return loss.detach(), tree_lib.map_leaves(lambda _: next(it), params)


def microbatch_grads(
    loss_fn: Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor],
    params: Tree,
    batch: Dict[str, torch.Tensor],
    n_micro: int,
) -> Tuple[torch.Tensor, Tree]:
    """Mean loss and gradients over ``n_micro`` microbatches taken in order.

    Every tensor of ``batch`` is split along dim 0 into contiguous slices;
    ``n_micro`` must divide the batch, or it raises ValueError.  The losses
    and gradients are summed in float32 in slice order and multiplied by
    ``1 / n_micro`` (the reference's order).  ``n_micro <= 1`` is one
    :func:`value_and_grad` on the whole batch, in the parameters' dtype.
    """
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    rows = {key: value.shape[0] for key, value in batch.items()}
    if any(b % n_micro for b in rows.values()):
        raise ValueError(f"n_micro ({n_micro}) must divide the batch ({rows})")
    loss_sum = grad_sum = None
    for j in range(n_micro):
        micro = {key: value[j * (rows[key] // n_micro):(j + 1) * (rows[key] // n_micro)]
                 for key, value in batch.items()}
        loss, grads = value_and_grad(loss_fn, params, micro)
        if grad_sum is None:  # 0 + x is x: the reference's zero-initialised sums
            loss_sum = loss.float()
            grad_sum = tree_lib.map_leaves(lambda g: g.float().clone(), grads)
        else:
            loss_sum = loss_sum + loss
            tree_lib.map_leaves(lambda a, g: a.add_(g.float()), grad_sum, grads)
    inv = 1.0 / n_micro
    return loss_sum * inv, tree_lib.map_leaves(lambda g: g.mul_(inv), grad_sum)
