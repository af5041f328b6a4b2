"""Optimizers: row optimizers for the factor tables (the MF training path)
and the dense ``Adam`` and ``Sgd`` over whole parameter trees (the recsys
models' cells).

Counterpart of ``repro/optim/optimizers.py``.  For the row optimizers, state lives
beside the (rows, k) table; an update touches only the gathered rows.  Every
optimizer takes the paper's pruning ``mask``, so Algorithm 3's truncated
update composes with any of them (SGD, momentum, Adagrad, AdaDelta, Adam).

Unlike the reference, which returns new arrays, :meth:`RowOptimizer.apply_rows`
updates the table and its state **in place** and returns them: at the dpmf
size a second copy of the 51 GB user table does not fit beside the first.

Duplicate row indices follow the reference exactly:

* the parameter update is a scatter-add (``kernels.scatter.add_rows``:
  ``index_add_`` on the CPU, the batch-order kernel on CUDA), so duplicates
  accumulate in batch order, as the reference's ``.at[idx].add`` does;
* adagrad's accumulator also adds every duplicate, while each duplicate's
  delta uses its own ``acc[idx] + g^2`` gathered before the update;
* momentum, adadelta and adam write their state rows back with the last
  duplicate winning (the reference's ``.at[idx].set``); ``index_put_`` does
  not promise an order among duplicates on CUDA, so the last occurrence of
  each index is picked explicitly;
* adam keeps one step count ``t`` shared by all rows.

The dense optimizers take trees of tensors (``repro_torch.tree``: the
recsys models' dicts and lists), keep their state in float32 and follow
the reference's arithmetic op for op.  They too update in place, under
``torch.no_grad()``: where the reference's cell donates its parameters
(``donate_argnums``), the port writes the new values into the same
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels.scatter import add_rows

State = Dict[str, torch.Tensor]
Tree = Any


def last_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """Positions in ``idx`` of the last occurrence of each distinct value."""
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    last = torch.ones_like(sorted_idx, dtype=torch.bool)
    last[:-1] = sorted_idx[1:] != sorted_idx[:-1]
    return order[last]


def _set_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
              keep: torch.Tensor) -> None:
    """``table[idx] = rows`` with the last duplicate winning."""
    table[idx[keep]] = rows[keep].to(table.dtype)


@dataclasses.dataclass(frozen=True)
class RowOptimizer:
    """``init(param) -> state``; ``apply_rows`` updates rows in place."""

    name: str = "sgd"
    eps: float = 1e-8
    rho: float = 0.95     # adadelta decay
    beta1: float = 0.9    # adam
    beta2: float = 0.999  # adam
    mu: float = 0.9       # momentum

    def init(self, param: torch.Tensor) -> State:
        zeros = lambda: torch.zeros_like(param)  # noqa: E731
        if self.name == "sgd":
            return {}
        if self.name == "momentum":
            return {"mom": zeros()}
        if self.name == "adagrad":
            return {"acc": zeros()}
        if self.name == "adadelta":
            return {"eg2": zeros(), "edx2": zeros()}
        if self.name == "adam":
            return {"m": zeros(), "v": zeros(),
                    "t": torch.zeros((), dtype=torch.int32, device=param.device)}
        raise ValueError(f"unknown row optimizer {self.name!r}")

    def apply_rows(
        self,
        param: torch.Tensor,
        state: State,
        idx: torch.Tensor,        # (B,) row indices (duplicates allowed)
        grad_rows: torch.Tensor,  # (B, k) gradient of the gathered rows
        mask: torch.Tensor,       # (B, k) pruning mask (Alg. 3) times row weight
        lr,
    ) -> Tuple[torch.Tensor, State]:
        """Update ``param`` and ``state`` in place; returns them."""
        g = grad_rows.float() * mask
        if self.name == "sgd":
            add_rows(param, idx, (-lr * g).to(param.dtype))
            return param, state

        if self.name == "adagrad":
            acc = state["acc"]
            acc_rows = acc[idx] + g * g
            delta = -lr * g / torch.sqrt(acc_rows + self.eps) * mask
            add_rows(param, idx, delta.to(param.dtype))
            add_rows(acc, idx, g * g)
            return param, state

        keep = last_occurrence(idx)
        if self.name == "momentum":
            # heavy ball on the masked gradient; an all-zero mask still decays
            # and writes back the row's momentum, as in the reference
            mom_rows = self.mu * state["mom"][idx] + g
            add_rows(param, idx, (-lr * mom_rows * mask).to(param.dtype))
            _set_rows(state["mom"], idx, mom_rows, keep)
            return param, state

        if self.name == "adadelta":
            eg2, edx2 = state["eg2"], state["edx2"]
            eg2_rows = self.rho * eg2[idx] + (1 - self.rho) * g * g
            edx2_old = edx2[idx]
            dx = (-torch.sqrt(edx2_old + self.eps) / torch.sqrt(eg2_rows + self.eps) * g) * mask
            edx2_rows = self.rho * edx2_old + (1 - self.rho) * dx * dx
            add_rows(param, idx, dx.to(param.dtype))
            _set_rows(eg2, idx, eg2_rows, keep)
            _set_rows(edx2, idx, edx2_rows, keep)
            return param, state

        if self.name == "adam":
            t = state["t"] + 1
            tf = t.float()
            m_rows = self.beta1 * state["m"][idx] + (1 - self.beta1) * g
            v_rows = self.beta2 * state["v"][idx] + (1 - self.beta2) * g * g
            one = torch.ones((), dtype=torch.float32, device=g.device)
            mhat = m_rows / (1 - torch.pow(one * self.beta1, tf))
            vhat = v_rows / (1 - torch.pow(one * self.beta2, tf))
            delta = -lr * mhat / (torch.sqrt(vhat) + self.eps) * mask
            add_rows(param, idx, delta.to(param.dtype))
            _set_rows(state["m"], idx, m_rows, keep)
            _set_rows(state["v"], idx, v_rows, keep)
            state["t"] = t
            return param, state
        raise ValueError(f"unknown row optimizer {self.name!r}")


# ---------------------------------------------------------------------------
# Dense optimizers (whole parameter trees)
# ---------------------------------------------------------------------------


_ADAM_BLOCK = 1 << 26  # elements of a leaf that Adam updates at once


def _zeros_f32(tree: Tree) -> Tree:
    return tree_lib.map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32), tree)


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam as the reference's: ``p - (lr * lr_scale * (m / b1c) /
    (sqrt(v / b2c) + eps) + lr * lr_scale * weight_decay * p)`` in float32,
    cast back to ``p.dtype``; ``m``, ``v`` float32 and one step count ``t``.
    A leaf larger than 2^26 elements is updated in blocks of rows along its
    first dim (a transformer's stacked layers one or a few at a time; a
    layer's stacked experts, above 2^26 themselves, a few experts at a
    time), with the same operations in the same order."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Tree) -> Dict[str, Any]:
        device = next(iter(tree_lib.leaves(params)), torch.empty(0)).device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def apply(self, params: Tree, state: Dict[str, Any], grads: Tree, lr_scale=1.0):
        """Update ``params`` and ``state`` in place; returns them."""
        t = state["t"] + 1
        tf = t.float()
        one = torch.ones((), dtype=torch.float32, device=tf.device)
        b1c = 1 - torch.pow(one * self.beta1, tf)
        b2c = 1 - torch.pow(one * self.beta2, tf)

        def upd(p, g, m, v):
            # the reference's expressions op for op, each in-place op rounding
            # as its out-of-place twin: m = b1 m + (1 - b1) g, v = b2 v +
            # (1 - b2) g g, p - lr (m / b1c) / (sqrt(v / b2c) + eps), in
            # three float32 temporaries
            g = g.float()
            m.mul_(self.beta1).add_(g * (1 - self.beta1))
            v.mul_(self.beta2).add_((g * (1 - self.beta2)).mul_(g))
            step = (m / b1c).mul_(self.lr * lr_scale)
            step.div_(torch.div(v, b2c).sqrt_().add_(self.eps))
            if self.weight_decay:
                step.add_(p.float() * (self.lr * lr_scale * self.weight_decay))
            p.copy_(step.neg_().add_(p.float()))  # p - step, rounded to p's type

        def by_blocks(p, g, m, v):
            # elementwise, so the same bits block by block; a block's float32
            # temporaries stay near _ADAM_BLOCK elements, not a leaf's size
            # (a row larger than that, one layer's stacked experts, is cut
            # along its own first dim in turn)
            if p.numel() <= _ADAM_BLOCK or p.dim() == 0:
                return upd(p, g, m, v)
            rows = _ADAM_BLOCK // p[0].numel()
            if not rows:
                for i in range(p.shape[0]):
                    by_blocks(*(t[i] for t in (p, g, m, v)))
                return None
            for lo in range(0, p.shape[0], rows):
                upd(*(t[lo:lo + rows] for t in (p, g, m, v)))

        tree_lib.map_leaves(by_blocks, params, grads, state["m"], state["v"])
        state["t"] = t
        return params, state


@dataclasses.dataclass(frozen=True)
class Sgd:
    """Plain SGD (``momentum`` 0: no state, the step in ``p``'s dtype) or
    heavy ball (a float32 momentum per leaf)."""

    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params: Tree) -> Dict[str, Any]:
        if self.momentum == 0.0:
            return {}
        return {"mom": _zeros_f32(params)}

    @torch.no_grad()
    def apply(self, params: Tree, state: Dict[str, Any], grads: Tree, lr_scale=1.0):
        """Update ``params`` (and the momentum) in place; returns them.
        Without momentum ``state`` comes back untouched."""
        if self.momentum == 0.0:
            def plain(p, g):
                # the scale in p's dtype: jax casts a Python scalar to the array's
                scale = torch.as_tensor(self.lr * lr_scale, dtype=p.dtype, device=p.device)
                p.sub_(scale * g.to(p.dtype))
            tree_lib.map_leaves(plain, params, grads)
            return params, state

        def upd(p, g, m):
            m.copy_(self.momentum * m + g.float())
            p.copy_((p.float() - self.lr * lr_scale * m).to(p.dtype))

        tree_lib.map_leaves(upd, params, grads, state["mom"])
        return params, state
