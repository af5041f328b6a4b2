"""Graph attention network (GAT, Velickovic et al. 2018) for the gat-cora arch.

Counterpart of ``repro/models/gnn.py``.  Message passing is built, as in
the reference, from edge gathers (by ``src`` and by ``dst``), per-edge
scores, a softmax over each node's incoming edges and a sum of the messages
into ``dst``.  The same forward serves full graphs (cora, ogbn-products),
sampled minibatches (``data/graphs.neighbor_sample``) and block-diagonal
molecule batches.

Every edge gather goes through ``kernels.scatter.gather_rows`` and both
segment sums through ``kernels.scatter.segment_sum`` (the messages' gather
and sum in one autograd function that recomputes the gather in its
backward, :class:`_EdgeMessages`): on the card their scatters (the
gathers' gradients, the sums) are ``add_rows`` launches that add a node's
edges in edge order, so a training step is bitwise reproducible; PyTorch's
own index backward and ``index_add_`` add them with atomics in any order.
The segment max is ``scatter_reduce``'s ``amax`` (order-free), taken
without gradient: the softmax is invariant to the shift up to its ``1e-9``
guard.  ``x @ w`` is a plain product, as the reference's ``einsum`` is.

Parameters are the reference's tree, ``{"layers": [{"w", "a_src", "a_dst",
"bias"}]}``; :func:`gnn_params_from_numpy` carries the reference's across.
:func:`init_params` draws from one explicit ``torch.Generator`` (not
``jax.random``'s draws); with ``device="meta"`` it allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.scatter import add_rows, gather_rows, segment_sum

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    d_feat: int
    n_classes: int
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    negative_slope: float = 0.2
    dtype: Any = torch.float32

    def layer_dims(self):
        """[(d_in, heads, d_out, concat?)] per layer; last layer averages."""
        dims = []
        d_in = self.d_feat
        for layer in range(self.n_layers):
            last = layer == self.n_layers - 1
            d_out = self.n_classes if last else self.d_hidden
            heads = 1 if last and self.n_layers > 1 else self.n_heads
            dims.append((d_in, heads, d_out, not last))
            d_in = heads * d_out if not last else d_out
        return dims


def init_params(generator: torch.Generator, cfg: GATConfig, device: DeviceLike = None) -> Params:
    """Glorot-scaled ``w``, attention vectors N(0, 0.1^2), zero biases, drawn
    layer by layer in the order ``w``, ``a_src``, ``a_dst``."""
    dev = resolve_device(device, meta_ok=True)

    def draw(shape, scale):
        return torch.randn(shape, generator=generator, dtype=cfg.dtype, device=dev).mul_(scale)

    layers = []
    for d_in, heads, d_out, _ in cfg.layer_dims():
        scale = (2.0 / (d_in + heads * d_out)) ** 0.5
        layers.append({
            "w": draw((d_in, heads * d_out), scale),
            "a_src": draw((heads, d_out), 0.1),
            "a_dst": draw((heads, d_out), 0.1),
            "bias": torch.zeros((heads * d_out,), dtype=cfg.dtype, device=dev),
        })
    return {"layers": layers}


def gnn_params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """A reference parameter tree of numpy arrays as tensors on ``device``
    (copies), keys and nesting kept."""
    dev = resolve_device(device)
    return tree_lib.map_leaves(lambda a: torch.as_tensor(np.array(a, copy=True)).to(dev), tree)


def _segment_max(scores: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The largest of each segment's scores (-inf for an empty one)."""
    idx = segment_ids[:, None].expand_as(scores)
    smax = torch.full((num_segments,) + scores.shape[1:], float("-inf"), dtype=scores.dtype,
                      device=scores.device)
    return smax.scatter_reduce(0, idx, scores, "amax", include_self=False)


def _segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Numerically stable softmax over edges grouped by destination node;
    ``segment_ids`` int64."""
    smax = _segment_max(scores.detach(), segment_ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))  # empty segments
    ex = torch.exp(scores - gather_rows(smax, segment_ids))
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / (gather_rows(denom, segment_ids) + 1e-9)


class _EdgeMessages(torch.autograd.Function):
    """``segment_sum(alpha[..., None] * gather_rows(h, src), dst, n)``, the
    messages summed into their destinations, keeping neither the gathered
    rows nor the messages (``(E, H, d)`` each: 15.8 GB in ogb_products'
    first layer) for the backward, which gathers ``h[src]`` again.  Its
    scatters are ``add_rows``, as the two functions' are: the sum (forward)
    and the rows' gradient into ``h`` (backward)."""

    @staticmethod
    def forward(ctx, alpha, h, src, dst, n):
        ctx.save_for_backward(alpha, h, src, dst)
        msgs = h[src].mul_(alpha[..., None])
        return segment_sum(msgs, dst, n)

    @staticmethod
    def backward(ctx, grad):
        alpha, h, src, dst = ctx.saved_tensors
        g = grad[dst]  # the gradient of each message
        rows = h[src].mul_(g)
        grad_alpha = rows.sum(dim=-1)
        del rows
        grad_h = h.new_zeros(h.shape)
        add_rows(grad_h.view(h.shape[0], -1), src, g.mul_(alpha[..., None]).view(len(src), -1))
        return grad_alpha, grad_h, None, None, None


def _edge_messages(alpha: torch.Tensor, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n: int) -> torch.Tensor:
    """:class:`_EdgeMessages`: ``(E, H)`` weights and ``(N, H, d)`` rows ->
    ``(n, H, d)`` sums."""
    return _EdgeMessages.apply(alpha, h, src, dst, n)


def gat_layer(
    x: torch.Tensor,        # (N, d_in)
    edges: torch.Tensor,    # (E, 2) [src, dst]; messages flow src -> dst
    layer: Params,
    *,
    heads: int,
    d_out: int,
    concat: bool,
    negative_slope: float,
    edge_mask: Optional[torch.Tensor] = None,  # (E,) 1/0 for padded edges
) -> torch.Tensor:
    n = x.shape[0]
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    h = torch.matmul(x, layer["w"]).reshape(n, heads, d_out)

    e_src = torch.sum(h * layer["a_src"][None], dim=-1)  # (N, H)
    e_dst = torch.sum(h * layer["a_dst"][None], dim=-1)
    scores = F.leaky_relu(gather_rows(e_src, src) + gather_rows(e_dst, dst),
                          negative_slope)  # (E, H)
    if edge_mask is not None:
        scores = torch.where(edge_mask[:, None] > 0, scores,
                             torch.tensor(-1e30, dtype=scores.dtype, device=scores.device))

    alpha = _segment_softmax(scores, dst, n)  # (E, H)
    if edge_mask is not None:
        alpha = alpha * edge_mask[:, None]
    out = _edge_messages(alpha, h, src, dst, n)  # (N, H, d_out)

    if concat:
        return F.elu(out.reshape(n, heads * d_out) + layer["bias"])
    return torch.mean(out, dim=1) + layer["bias"]


def forward(
    params: Params,
    x: torch.Tensor,
    edges: torch.Tensor,
    cfg: GATConfig,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    for layer, (_, heads, d_out, concat) in zip(params["layers"], cfg.layer_dims()):
        x = gat_layer(
            x,
            edges,
            layer,
            heads=heads,
            d_out=d_out,
            concat=concat,
            negative_slope=cfg.negative_slope,
            edge_mask=edge_mask,
        )
    return x  # (N, n_classes) logits


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: GATConfig) -> torch.Tensor:
    """Masked node-classification cross entropy (labels < 0 ignored)."""
    logits = forward(
        params, batch["features"], batch["edges"], cfg, batch.get("edge_mask")
    ).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, safe[:, None])[:, 0]
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
