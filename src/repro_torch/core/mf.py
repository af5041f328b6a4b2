"""MF model family (FunkSVD, BiasSVD, SVD++): the serving subset.

Counterpart of ``repro/core/mf.py``.  ``p`` is (m, k) user-major, ``q`` is
(n, k) item-major, biases are (rows, 1), ``implicit`` is SVD++'s (n + 1, k)
table whose row n is the zero padding row.  Training (``_train_step``, the
optimizers) is not part of this module yet.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ranks import effective_ranks, rank_mask
from repro_torch.device import DeviceLike, check_on, resolve_device
from repro_torch.kernels import ops as kops


class MFParams(NamedTuple):
    """Factor tables of one model; the optional fields are None for FunkSVD."""

    p: torch.Tensor                       # (m, k)
    q: torch.Tensor                       # (n, k)
    user_bias: Optional[torch.Tensor]     # (m, 1) | None
    item_bias: Optional[torch.Tensor]     # (n, 1) | None
    global_mean: Optional[torch.Tensor]   # ()     | None
    implicit: Optional[torch.Tensor]      # (n + 1, k) | None; row n is padding


def init_params(
    generator: torch.Generator,
    num_users: int,
    num_items: int,
    k: int,
    *,
    variant: str = "funk",          # funk | bias | svdpp
    init_method: str = "normal",    # normal | uniform | libmf  (paper §5.3)
    scale: float = 0.1,
    global_mean: float = 0.0,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> MFParams:
    """Random factors drawn from ``generator`` (which must live on ``device``).

    The draws differ from ``jax.random``'s for the same seed; tests that hold
    the port to the reference carry factors across with
    :func:`params_from_numpy` instead.
    """
    dev = resolve_device(device)

    def draw(rows):
        shape = (rows, k)
        if init_method == "normal":
            return scale * torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        u = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
        if init_method == "uniform":
            lim = scale * (3.0 ** 0.5)  # same std as the normal init
            return (2.0 * u - 1.0) * lim
        if init_method == "libmf":
            return u * (k ** -0.5)
        raise ValueError(f"unknown init {init_method!r}")

    p, q, y = draw(num_users), draw(num_items), draw(num_items + 1)
    with_bias = variant in ("bias", "svdpp")
    if variant == "svdpp":
        y[num_items] = 0.0
    return MFParams(
        p=p,
        q=q,
        user_bias=torch.zeros((num_users, 1), dtype=dtype, device=dev) if with_bias else None,
        item_bias=torch.zeros((num_items, 1), dtype=dtype, device=dev) if with_bias else None,
        global_mean=torch.tensor(global_mean, dtype=dtype, device=dev) if with_bias else None,
        implicit=y if variant == "svdpp" else None,
    )


def params_from_numpy(
    fields: Mapping[str, Optional[np.ndarray]], device: DeviceLike = None
) -> MFParams:
    """Build :class:`MFParams` from ``{field: array or None}`` (e.g. the
    reference's ``params._asdict()`` as numpy), on ``device``."""
    dev = resolve_device(device)

    def conv(name):
        v = fields.get(name)
        if v is None:
            return None
        # read-only arrays (e.g. views of JAX buffers) are copied first
        return torch.as_tensor(np.require(np.asarray(v), requirements="W")).to(dev)

    return MFParams(*(conv(name) for name in MFParams._fields))


def params_from_flat(
    arrays: Mapping[str, Any], prefix: str = "params__", device: DeviceLike = None
) -> MFParams:
    """Rebuild :class:`MFParams` from a flat checkpoint payload with the
    ``params__p``-style keys of the reference trainer's checkpoints."""
    return params_from_numpy(
        {name: arrays.get(prefix + name) for name in MFParams._fields}, device
    )


def _user_vector(
    params: MFParams, u: torch.Tensor, hist: Optional[torch.Tensor]
) -> torch.Tensor:
    """p_u, or SVD++'s p_u + |N(u)|^-1/2 * sum_{j in N(u)} y_j."""
    p_rows = params.p[u]
    if params.implicit is None or hist is None:
        return p_rows
    # hist: (B, H) item ids padded with num_items (the zero row of `implicit`)
    n_items = params.implicit.shape[0] - 1
    y_sum = params.implicit[hist].sum(dim=1)
    counts = (hist < n_items).float().sum(dim=1, keepdim=True)
    return p_rows + y_sum * torch.rsqrt(torch.clamp(counts, min=1.0))


def predict_pairs(
    params: MFParams,
    u: torch.Tensor,
    i: torch.Tensor,
    t_p=0.0,
    t_q=0.0,
    hist: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pruned predictions for (u, i) pairs.  Returns (pred, pair_ranks)."""
    pu = _user_vector(params, u, hist)
    qi = params.q[i]
    r_u = effective_ranks(pu, t_p)
    r_i = effective_ranks(qi, t_q)
    mask = rank_mask(torch.minimum(r_u, r_i), pu.shape[-1])
    pred = torch.sum(pu.float() * qi.float() * mask, dim=-1)
    if params.user_bias is not None:
        pred = pred + params.global_mean + params.user_bias[u, 0] + params.item_bias[i, 0]
    return pred, torch.minimum(r_u, r_i)


def predict_all_items(
    params: MFParams,
    u: torch.Tensor,
    t_p=0.0,
    t_q=0.0,
    *,
    hist: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Score a user batch against *all* items: (B, n) float32.

    The paper's "matrix multiplication" stage at recommendation time, through
    :func:`repro_torch.kernels.ops.pruned_matmul` (the hand-written kernel on
    CUDA).  ``params`` must already lie on ``device``.
    """
    dev = resolve_device(device)
    check_on(dev, p=params.p, q=params.q, u=u, hist=hist)
    pu = _user_vector(params, u, hist)
    scores = kops.pruned_matmul(pu, params.q, t_p, t_q, device=dev)
    if params.user_bias is not None:
        scores = (
            scores
            + params.global_mean
            + params.user_bias[u]
            + params.item_bias[:, 0][None, :]
        )
    return scores
