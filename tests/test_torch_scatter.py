"""The batch-order row scatter (``kernels.scatter.add_rows``) on the CPU,
and the training path that now scatters through it.

Every comparison here is bitwise: ``add_rows`` is ``index_add_`` on the
CPU (float32 sums in batch order, bfloat16 tables summed in float32 and
rounded once), the reference's XLA ``.at[idx].add`` adds float32 repeats in
the same batch order, and ``add_rows_in_passes`` (the order of the CUDA kernel, written in
plain tensor ops) gives the same bits, also through whole training steps.
The CUDA kernel itself is held to the CPU's ``index_add_`` in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import mf
from repro_torch.kernels import scatter
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import RowOptimizer

CASES = [  # (rows, table rows, k): heavy repeats, k off 32, one column
    (0, 5, 4), (1, 5, 4), (257, 3, 33), (2000, 40, 128), (5000, 7, 1), (700, 1000, 130),
]


def _inputs(rows, span, k, dtype, seed=0):
    rng = np.random.default_rng(seed + rows)
    table = torch.as_tensor(rng.normal(size=(span, k)).astype(np.float32)).to(dtype)
    # a power law on the indices: a few rows take most of the batch
    idx = torch.as_tensor((span * rng.random(rows) ** 3).astype(np.int64))
    upd = torch.as_tensor((rng.normal(size=(rows, k)) * 10.0 ** rng.integers(-3, 4, (rows, 1)))
                          .astype(np.float32)).to(dtype)
    return table, idx, upd


def _sequential(table, idx, rows):
    """One add at a time in batch order, in float32; a bfloat16 table is
    rounded once at the end, a bfloat16 vector after every add (as the CPU's
    ``index_add_`` rounds them)."""
    if table.dim() == 1:
        out = table.clone()
        for j in range(idx.numel()):
            out[idx[j]] = (out[idx[j]].float() + rows[j].float()).to(table.dtype)
        return out
    out = table.float()
    for j in range(idx.numel()):
        out[idx[j]] += rows[j].float()
    return out.to(table.dtype)


@pytest.mark.parametrize("rows,span,k", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rows_is_index_add_and_batch_order(rows, span, k, dtype):
    table, idx, upd = _inputs(rows, span, k, dtype)
    want = table.clone().index_add_(0, idx, upd)
    got = scatter.add_rows(table.clone(), idx, upd)
    passes = scatter.add_rows_in_passes(table.clone(), idx, upd)
    assert got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(passes, want)
    if rows <= 2000:
        assert torch.equal(_sequential(table, idx, upd), want)


@pytest.mark.parametrize("rows,span,k", CASES[1:])
def test_add_rows_matches_the_reference_scatter(rows, span, k):
    """XLA's ``.at[idx].add`` adds repeats in batch order too: bitwise."""
    table, idx, upd = _inputs(rows, span, k, torch.float32, seed=1)
    want = np.asarray(jnp.asarray(table.numpy()).at[idx.numpy()].add(upd.numpy()))
    np.testing.assert_array_equal(scatter.add_rows(table.clone(), idx, upd).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rows_into_a_column_view_and_with_keep(dtype):
    """A bias column (``table[:, 0]``, a strided vector) and the ``keep``
    filter of the sharded step."""
    table, idx, upd = _inputs(3000, 17, 3, dtype, seed=2)
    keep = torch.as_tensor(np.random.default_rng(3).random(3000) < 0.6)
    got, want, passes = table.clone(), table.clone(), table.clone()
    scatter.add_rows(got[:, 1], idx, upd[:, 0])
    want[:, 1].index_add_(0, idx, upd[:, 0])
    scatter.add_rows_in_passes(passes[:, 1], idx, upd[:, 0])
    assert torch.equal(got, want) and torch.equal(passes, want)
    assert torch.equal(want[:, 1], _sequential(table[:, 1], idx, upd[:, 0]))
    got, want = table.clone(), table.clone()
    scatter.add_rows(got, idx, upd, keep=keep)
    want.index_add_(0, idx[keep], upd[keep])
    assert torch.equal(got, want)
    passes = scatter.add_rows_in_passes(table.clone(), idx, upd, keep=keep)
    assert torch.equal(passes, want)


def test_add_rows_launch_refuses_what_the_kernel_does_not_take():
    table = torch.zeros(4, 3)
    idx = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scatter._launch(table, idx, torch.zeros(2, 3, dtype=torch.float64), None)
    with pytest.raises(ValueError, match="do not match"):
        scatter._launch(table, idx, torch.zeros(2, 4), None)
    with pytest.raises(ValueError, match="unit column stride"):
        scatter._launch(torch.zeros(3, 4).T, idx, torch.zeros(2, 3), None)


def _step_inputs(variant, seed=0, m=30, n=12, b=512, k=16):
    rng = np.random.default_rng(seed)
    fields = {"p": rng.normal(0, 0.3, (m, k)), "q": rng.normal(0, 0.3, (n, k))}
    if variant == "bias":
        fields.update(user_bias=rng.normal(0, 0.1, (m, 1)), item_bias=rng.normal(0, 0.1, (n, 1)),
                      global_mean=np.float32(3.0))
    fields = {key: np.asarray(v, np.float32) for key, v in fields.items()}
    batch = {"user": torch.as_tensor(rng.integers(0, m, b)),
             "item": torch.as_tensor((n * rng.random(b) ** 2).astype(np.int64)),
             "rating": torch.as_tensor(rng.integers(1, 6, b).astype(np.float32)),
             "weight": torch.as_tensor(rng.uniform(0.2, 1.0, b).astype(np.float32))}
    return fields, batch


@pytest.mark.parametrize("variant", ["funk", "bias"])
@pytest.mark.parametrize("opt_name,fused", [("sgd", True), ("sgd", False), ("adagrad", False),
                                            ("momentum", False), ("adam", False)])
def test_train_step_bits_do_not_depend_on_the_scatter_route(monkeypatch, variant, opt_name,
                                                             fused):
    """A training step (heavy item repeats, weighted) gives the same bits
    whether its scatters are ``index_add_`` or added in passes of distinct
    indices, the kernel's order: the step's result is the batch-order sum."""
    fields, batch = _step_inputs(variant)
    opt = RowOptimizer(name=opt_name)
    out = []
    for route in (scatter.add_rows, scatter.add_rows_in_passes):
        monkeypatch.setattr(mf, "add_rows", route)
        monkeypatch.setattr(optimizers, "add_rows", route)
        params = mf.params_from_numpy(fields, device="cpu")
        state = mf.init_opt_state(params, opt)
        for t in (0.0, 0.2):
            mf.train_step(params, state, batch, torch.tensor(t), torch.tensor(t), 0.05,
                          torch.ones(16), opt=opt, lam=0.02, use_fused_kernel=fused)
        out.append(params)
    for got, want in zip(out[1], out[0]):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


def test_add_rows_in_passes_through_the_shard_helper():
    """``mf._add_rows`` keeps its ``keep`` filter on both routes."""
    table, idx, upd = _inputs(900, 25, 8, torch.float32, seed=4)
    keep = torch.as_tensor(np.random.default_rng(5).random(900) < 0.5)
    a, b = table.clone(), table.clone()
    mf._add_rows(a, idx, upd, keep=keep)
    mf._add_rows(b, idx, upd, keep=keep, in_passes=True)
    assert torch.equal(a, b)
