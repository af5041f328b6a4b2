"""Row optimizers for the factor tables (the MF training path).

Counterpart of the row half of ``repro/optim/optimizers.py``.  State lives
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

The dense ``Adam``/``Sgd`` of the reference (for the model zoo) are not
ported here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels.scatter import add_rows

State = Dict[str, torch.Tensor]


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
