"""Mixture-of-experts feed-forward: sort-based (dropping) dispatch, and its
expert-parallel form across ranks.

Counterpart of ``repro/models/moe.py``.  Tokens are ordered by their
assigned expert, placed into per-expert capacity buffers, run through the
experts as one batched product (``torch.matmul`` over the expert axis, the
reference's ``vmap``'d einsum) and combined back with their gate weights.
Tokens past an expert's capacity are dropped (GShard's capacity); shared
experts (DeepSeek) bypass the routing.  The reference's XLA ops are plain
tensor ops here; no Pallas kernel of the reference lies on this path.

Kept exactly as the reference has them: the capacity's Python float
arithmetic, the router in float32, the softmax, top-k with its gates
renormalised, the Switch/GShard aux loss, the stable sort by expert, the
exclusive prefix of the counts, positions within an expert, ``keep = pos <
cap``, the drop slot ``e * cap`` and the casts of the token path (the
gate product in ``x``'s type and the combine into an ``x``-typed table;
the expert-parallel form's float32 combine, cast once).

Where the port departs, invisibly in a value:

* Top-k is a stable descending sort of the probabilities, its first ``k``:
  ties go to the lower expert index, as ``jax.lax.top_k`` gives them
  (``torch.topk`` promises no order).
* No host sync: the counts are a ``scatter_add_`` into ``E`` zeros (not
  ``bincount``, which syncs to size its output), and nothing is indexed by
  a boolean mask.
* The dispatch buffer is a gather, not the reference's ``.at[slot].set``:
  each of the ``e * cap`` slots names the token that fills it, and the
  empty ones are left out (``gather_rows(keep=)``), so the gradient into
  the tokens is one ``add_rows`` with no padding run.
* The combine ``zeros.at[token].add(rows)`` is one ``segment_sum``: on the
  card both it and the gathers' gradients (the gates' permutation into
  sorted order among them) are ``add_rows`` launches, in batch order, so a
  training step is bitwise reproducible.  (The gates' gather from the
  probabilities touches each (token, expert) pair once: nothing to order.)
  A bfloat16 combine is summed in float32 and rounded once, where XLA
  rounds add by add: a token sums at most ``top_k`` rows, held within 2e-2
  of the reference.

:func:`route` and :func:`dispatch` split :func:`moe_ffn_xla` so that one
side's routing can be run through the other side's dispatch
(:func:`routes_recorded`, :func:`routes_replayed`): a rounding difference
can flip an expert choice at a near-tie, which changes that token's output
entirely.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import spmd
from repro_torch.kernels.scatter import gather_rows, segment_sum
from repro_torch.models.layers import gated_mlp


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    num_shared: int = 0            # always-on experts (DeepSeek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def init_moe_params(generator: torch.Generator, d_model: int, cfg: MoEConfig, *,
                    activation: str = "swiglu", dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None,
                    lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``router`` (float32) N(0, 1/d), the experts' ``wg``, ``wi`` N(0, 1/d) and
    ``wo`` N(0, 1/d_ff) of ``(E, d, d_ff)`` / ``(E, d_ff, d)``, then the shared
    experts' ``wg``, ``wi``, ``wo`` as one MLP ``num_shared * d_ff`` wide; drawn
    in that order from ``generator``.  ``lead`` prepends dims to every leaf
    (the transformer's stacked layers)."""
    dev = resolve_device(device, meta_ok=True)

    def draw(shape, scale, leaf_dtype=dtype):
        return torch.empty(tuple(lead) + shape, dtype=leaf_dtype, device=dev).normal_(
            generator=generator).mul_(scale)

    e, f = cfg.num_experts, cfg.d_ff
    scale_in, scale_out = d_model ** -0.5, f ** -0.5
    params = {
        "router": draw((d_model, e), scale_in, torch.float32),
        "wg": draw((e, d_model, f), scale_in),
        "wi": draw((e, d_model, f), scale_in),
        "wo": draw((e, f, d_model), scale_out),
    }
    if cfg.num_shared:
        sf = cfg.num_shared * f
        params["shared"] = {"wg": draw((d_model, sf), scale_in),
                            "wi": draw((d_model, sf), scale_in),
                            "wo": draw((sf, d_model), sf ** -0.5)}
    return params


def _capacity(num_tokens: int, cfg: MoEConfig) -> int:
    cap = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.top_k)


# ---------------------------------------------------------------------------
# routing, and its record and replay
# ---------------------------------------------------------------------------


class Route(NamedTuple):
    """A routing of ``T`` tokens: ``probs`` (T, E) float32, ``gates`` (T, k)
    renormalised, ``experts`` (T, k) int64 and the aux loss ()."""

    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    aux: torch.Tensor


class Recorded(NamedTuple):
    """A recorded routing: ``experts`` (T, k) and ``margin`` (T,), the k-th
    probability less the (k+1)-th (``inf`` when k == E)."""

    experts: torch.Tensor
    margin: torch.Tensor


# None, or ("record", [Recorded]) or ("replay", [expert ids], [natural expert ids]),
# a routing for each call of route() in order
_routes = None
# None, or a list of (pairs dropped, pairs) tensors, one per dispatch
_drops = None


@contextlib.contextmanager
def routes_recorded() -> Iterator[List[Recorded]]:
    """Yields a list to which every :func:`route` made inside appends its
    (detached) expert ids and margins, in call order (a layer recomputed in
    the backward records again)."""
    global _routes
    saved, store = _routes, []
    _routes = ("record", store)
    try:
        yield store
    finally:
        _routes = saved


@contextlib.contextmanager
def drops_counted() -> Iterator[list]:
    """Yields a list to which every dispatch made inside appends its dropped
    (token, expert) pairs, of the experts it runs (a 0-d tensor on the
    device: no host sync), and the number of all its pairs."""
    global _drops
    saved, _drops = _drops, []
    try:
        yield _drops
    finally:
        _drops = saved


@contextlib.contextmanager
def routes_replayed(experts: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Inside, the i-th :func:`route` takes the expert ids ``experts[i]``
    (``(T, k)``; the gates are gathered from its own probabilities and
    renormalised, the aux loss's density counts them), for a dispatch
    against the other side's routing: the same calls in the same order as
    where they were recorded, or it raises.  Yields a list that collects
    each call's own expert ids (detached), to compare."""
    global _routes
    saved, natural = _routes, []
    _routes = ("replay", list(experts), natural)
    try:
        yield natural
    finally:
        _routes = saved
    if len(natural) != len(experts):
        raise RuntimeError(f"{len(experts)} routings replayed, {len(natural)} made")


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig) -> Route:
    """The router in float32 over ``x`` (T, d): softmax, top-k (ties to the
    lower index) with the gates renormalised, and the Switch/GShard aux
    loss ``w * E * sum(density * mean prob)``."""
    e, k = cfg.num_experts, cfg.top_k
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs.detach(), dim=-1, descending=True, stable=True)
    experts = order[:, :k]
    if _routes is not None and _routes[0] == "replay":
        forced, natural = _routes[1], _routes[2]
        if len(natural) == len(forced):
            raise RuntimeError(f"more routings made than the {len(forced)} replayed")
        natural.append(experts)
        experts = forced[len(natural) - 1].to(x.device)
    elif _routes is not None:
        margin = (top[:, k - 1] - top[:, k] if k < e
                  else torch.full_like(top[:, 0], float("inf")))
        _routes[1].append(Recorded(experts, margin))
    gates = torch.gather(probs, 1, experts)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    # density: the share of (token, slot) pairs each expert takes
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, experts.reshape(-1), torch.ones(experts.numel(), dtype=torch.float32,
                                           device=x.device))
    density = counts / experts.shape[0] / k
    aux = cfg.router_aux_weight * e * torch.sum(density * torch.mean(probs, dim=0))
    return Route(probs, gates, experts, aux)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _sorted_slots(experts: torch.Tensor, e: int, cap: int, lo: int, e_loc: int):
    """The reference's sort-based slots for (T, k) expert ids, over the
    experts ``[lo, lo + e_loc)``: ``order`` (the stable sort by expert),
    ``slot`` of each sorted pair (``e_loc * cap`` for a dropped or foreign
    pair), ``keep``, and for each of the ``e_loc * cap`` slots the pair that
    fills it (``src``) and whether one does (``filled``)."""
    flat_expert = experts.reshape(-1)
    n = flat_expert.shape[0]
    dev = experts.device
    sorted_expert, order = torch.sort(flat_expert, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, 0) - counts           # exclusive prefix
    pos = torch.arange(n, device=dev) - starts[sorted_expert]
    local = (sorted_expert >= lo) & (sorted_expert < lo + e_loc)
    keep = local & (pos < cap)
    if _drops is not None:
        _drops.append((torch.sum(local & (pos >= cap)), n))
    slot = torch.where(keep, (sorted_expert - lo) * cap + pos, e_loc * cap)
    # slot s = (lo + i) * cap + p is filled by sorted pair starts[lo + i] + p
    # when p < counts[lo + i]: the buffer as a gather, not a scatter
    s = torch.arange(e_loc * cap, device=dev)
    ex, p = lo + s // cap, s % cap
    filled = p < counts[ex]
    src = torch.where(filled, starts[ex] + p, 0)
    return order, slot, keep, src, filled


def _routed(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig, r: Route,
            cap: int, activation: str, out_dtype: torch.dtype, lo: int = 0,
            e_loc: Optional[int] = None) -> torch.Tensor:
    """The experts ``[lo, lo + e_loc)`` (``params``' ``wg``/``wi``/``wo``) over
    their tokens of routing ``r``: the capacity buffers as a gather, the
    batched expert MLPs, then each token's kept rows times their gates, both
    cast to ``out_dtype``, summed into a (T, d) table of that type."""
    t, d = x.shape
    e_loc = cfg.num_experts if e_loc is None else e_loc
    order, slot, keep, src, filled = _sorted_slots(r.experts, cfg.num_experts, cap, lo, e_loc)
    token = order // cfg.top_k                           # flat_token[order]
    buf = gather_rows(x, token[src], keep=filled).reshape(e_loc, cap, d)
    out_buf = gated_mlp(buf, {"wg": params["wg"], "wi": params["wi"], "wo": params["wo"]},
                        activation).reshape(e_loc * cap, d)
    gate = gather_rows(r.gates.reshape(-1), order) * keep.float()
    rows = gather_rows(out_buf, torch.clamp(slot, max=e_loc * cap - 1), keep=keep)
    return segment_sum(rows.to(out_dtype) * gate[:, None].to(out_dtype), token, t)


def dispatch(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig, r: Route, *,
             activation: str = "swiglu") -> torch.Tensor:
    """The routed experts' output for routing ``r`` (no shared experts):
    tokens in capacity buffers by expert, the batched expert MLPs, then each
    token's kept rows times their gates (in ``x``'s type) summed into an
    ``x``-typed (T, d) table."""
    return _routed(x, params, cfg, r, _capacity(x.shape[0], cfg), activation, x.dtype)


def moe_ffn_xla(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig, *,
                activation: str = "swiglu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (output (T, d), aux ()): :func:`route`, :func:`dispatch`,
    plus the shared experts' MLP."""
    r = route(x, params["router"], cfg)
    combined = dispatch(x, params, cfg, r, activation=activation)
    if "shared" in params:
        combined = combined + gated_mlp(x, params["shared"], activation)
    return combined, r.aux


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig, *,
            activation: str = "swiglu", use_shard_map: bool = False,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The entry point: :func:`moe_ffn_shard_map` when ``use_shard_map`` and
    ``mesh`` has a ``"model"`` axis that divides the experts, else
    :func:`moe_ffn_xla` (the reference's fallback, with the mesh passed
    explicitly where it reads an ambient one)."""
    if use_shard_map and mesh is not None:
        names = spmd.axis_names(mesh)
        if "model" in names and cfg.num_experts % spmd.axis_size(mesh, "model") == 0:
            return moe_ffn_shard_map(x, params, cfg, activation=activation, mesh=mesh)
    return moe_ffn_xla(x, params, cfg, activation=activation)


# ---------------------------------------------------------------------------
# expert parallelism across ranks
# ---------------------------------------------------------------------------


class _ReplicatedReduce(torch.autograd.Function):
    """A sum (or mean) over a mesh's ``axes`` whose result every rank of them
    holds alike: the cotangent each rank receives is its own loss's, so the
    backward is the identity (times ``1 / n`` for the mean)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, mean):
        n = spmd.axis_size(mesh, axes)
        ctx.scale = 1.0 / n if mean else 1.0
        out = spmd.psum(x, mesh, axes)
        return out / n if mean else out

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale if ctx.scale != 1.0 else grad, None, None, None


class _SlabCotangents(torch.autograd.Function):
    """The identity on the routed path's inputs (the tokens and the gates)
    whose backward sums their cotangents over ``"model"`` in one psum: each
    rank's covers only its own slab's pairs, so after it every rank holds
    the whole routed path's gradient (the shared experts' and the aux
    loss's parts are each rank's alike, and are not summed)."""

    @staticmethod
    def forward(ctx, x, gates, mesh):
        ctx.mesh, ctx.split = mesh, x.numel()
        return x.view_as(x), gates.view_as(gates)

    @staticmethod
    def backward(ctx, grad_x, grad_gates):
        both = spmd.psum(torch.cat([grad_x.float().reshape(-1), grad_gates.float().reshape(-1)]),
                         ctx.mesh, "model")
        return (both[:ctx.split].reshape(grad_x.shape).to(grad_x.dtype),
                both[ctx.split:].reshape(grad_gates.shape).to(grad_gates.dtype), None)


def moe_ffn_shard_map(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig, *,
                      activation: str = "swiglu", mesh=None,
                      split_tokens: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism without a token exchange, run SPMD on every rank
    of ``mesh``: ``x`` is this rank's block of tokens (rows over the data
    axes), ``params``' ``wg``/``wi``/``wo`` its slab of ``E / n_model``
    experts (``"model"``), the router and shared experts whole.  Each rank
    routes its tokens over all E experts (capacity from its own token
    count), keeps the pairs whose expert is in its slab, runs them, and one
    psum over ``"model"`` combines the float32 parts, cast once; the aux
    loss is averaged over the data axes.  The psum's and the mean's
    backward treat their result as every rank's alike, and the tokens' and
    gates' cotangents on the routed path are summed over ``"model"``: a
    slab's gradient, the router's and the shared experts' are their rank's
    loss's (sum them over the data axes, as data parallelism does), and
    ``x``'s is its block's whole gradient, the same on every rank of
    ``"model"``.  ``split_tokens=False``: ``x`` is the whole batch on every
    rank of the data axes, and the aux loss is every rank's alike (no
    mean over them)."""
    if mesh is None:
        raise ValueError("moe_ffn_shard_map needs a mesh: pass mesh=")
    names = spmd.axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    n_model = spmd.axis_size(mesh, "model")
    e_loc = cfg.num_experts // n_model
    if params["wg"].shape[0] != e_loc:
        raise ValueError(f"expected this rank's slab of {e_loc} experts, got "
                         f"{params['wg'].shape[0]}")
    cap = _capacity(x.shape[0], cfg)  # the shard's: the reference's body computes the same

    r = route(x, params["router"], cfg)
    aux = _ReplicatedReduce.apply(r.aux, mesh, dp, True) if dp and split_tokens else r.aux
    x_routed, gates = _SlabCotangents.apply(x, r.gates, mesh)
    out_loc = _routed(x_routed, params, cfg, r._replace(gates=gates), cap, activation,
                      torch.float32, spmd.axis_index(mesh, "model") * e_loc, e_loc)
    combined = _ReplicatedReduce.apply(out_loc, mesh, "model", False).to(x.dtype)
    if "shared" in params:
        combined = combined + gated_mlp(x, params["shared"], activation)
    return combined, aux
