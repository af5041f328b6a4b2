"""Sequential recommendation served by the pruned MF engine.

Counterpart of ``repro/workloads/sequential.py``.  SASRec
(``models/recsys.py``) encodes an item-id session into a hidden state whose
dot product with the item embedding table ranks the next item: the shape of
MF serving, where a user vector scores against the item factors.  So the
final-state encodings become the rows of ``MFParams.p`` and the item
embedding table without its padding row 0 becomes ``MFParams.q``, and every
:class:`~repro_torch.serving.engine.ServingEngine` path serves sessions
unchanged: ``topk`` through the ``pruned_topk`` kernel on the card, or
``topk_sharded`` on a mesh.

Id mapping: SASRec item ids are 1-based (id 0 is the padding token), the
engine's item axis is 0-based; engine item ``j`` is item id ``j + 1``, and
:func:`serve_sessions` shifts back.  The engine's "user" ids are session
indices, row ``s`` of the ``seqs`` it was built from.  At thresholds 0 the
engine's top-k equals the dense ``dense_topk`` oracle's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import mf
from repro_torch.models import recsys
from repro_torch.serving.engine import ServingEngine


def encode_sessions(sasrec_params, seqs, cfg: recsys.SASRecConfig) -> torch.Tensor:
    """Final-position SASRec hidden states, one (d,) vector per session of
    ``seqs`` (S, L) (item ids, 0 = pad, prefix-padded): the query vector
    ``sasrec_retrieval`` scores with.  No gradient is kept."""
    table = sasrec_params["item_embed"]
    with torch.no_grad():
        seqs = torch.as_tensor(np.asarray(seqs) if not torch.is_tensor(seqs) else seqs)
        return recsys.sasrec_encode(sasrec_params, seqs.to(table.device), cfg)[:, -1]


def session_params(sasrec_params, seqs, cfg: recsys.SASRecConfig) -> mf.MFParams:
    """Session encodings and item embeddings as an :class:`~repro_torch.core.
    mf.MFParams`: ``p[s]`` is session ``s``'s vector, ``q[j]`` is item id
    ``j + 1`` (padding row 0 dropped), no biases.  ``q`` is a copy: the
    port trains in place, and an engine must keep the tables it was built
    from."""
    p = encode_sessions(sasrec_params, seqs, cfg)
    q = sasrec_params["item_embed"].detach()[1:].clone()
    return mf.MFParams(p=p, q=q, user_bias=None, item_bias=None, global_mean=None,
                       implicit=None)


def session_engine(sasrec_params, seqs, cfg: recsys.SASRecConfig, t_p=0.0, t_q=0.0,
                   **engine_kwargs) -> ServingEngine:
    """A :class:`ServingEngine` over the encoded sessions; ``engine_kwargs``
    pass through (``device``, ``max_batch``, ``block_n``, ...).  ``t_p``
    prunes session vectors and ``t_q`` item embeddings, rate 0 dense."""
    return ServingEngine(session_params(sasrec_params, seqs, cfg), t_p, t_q, **engine_kwargs)


def serve_sessions(engine: ServingEngine, session_ids, topk: int = 10, *,
                   mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k *item ids* (1-based, as SASRec speaks them) for session rows,
    through ``engine.topk`` or, with ``mesh``, ``engine.topk_sharded``
    (SPMD: every rank of the mesh calls it with the same sessions)."""
    if mesh is not None:
        scores, idx = engine.topk_sharded(session_ids, topk, mesh=mesh)
    else:
        scores, idx = engine.topk(session_ids, topk)
    return np.asarray(scores), np.asarray(idx) + 1
