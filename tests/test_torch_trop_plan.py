"""K6t's host plan (ops/dense_scan.py ``trop_plan``): the forward
operator's non-zeros by destination row, the rows cut into pieces and dealt
out to the persistent grid's warps by balanced cost, and a torch emulation
of the product the kernel computes from it (each piece's max over its
entries started from +0, float32 maxima on the products' bits as ints, a
split row's pieces merged by max into the row's partial slot) against the
dense twin ``_trop_product`` bit for bit.

Operators: the V=32 LM ∘ HMM graph (Sp = 3,200; its final state has 1,025
in-arcs) in float32 and float64, a tie-heavy random operator (weights and
states from a few powers of two, so that many products are equal, with
denormal products and an all-zero row), and a fully dense one, each on the
default grid (2 CTAs on each of an H100's 132 SMs) and on a small one.
Inputs are made from numpy seeds.  The CUDA kernel is held against the
plain twin on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from markovmodels_tpu_torch.ops import dense_scan as ds
from _torch_port import compile_port, port_lm_graph

F64 = torch.float64


def _lm32(dtype):
    fsm, spdf, P, _ = port_lm_graph(32)
    cf = compile_port(fsm, spdf, P, strategy="dense", dtype=dtype)
    return torch.exp(cf.dense_fwd_max)[:, None] * cf.dense_fwd_exp


def _ties(dtype, Sp=320, seed=3):
    """Weights from {2^-1, 2^-2, 2^-3} at ~5 % density, one row of tiny
    weights whose products are denormal, one all-zero row."""
    rng = np.random.default_rng(seed)
    w = rng.choice([0.5, 0.25, 0.125], size=(Sp, Sp))
    w *= rng.uniform(size=(Sp, Sp)) < 0.05
    w[7] = w[7] * 2.0 ** -140
    w[11] = 0.0
    return torch.from_numpy(w).to(dtype)


def _dense(dtype, Sp=256, seed=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.01, 1.0, size=(Sp, Sp)) / Sp).to(
        dtype)


_MAKERS = {"lm32": _lm32, "ties": _ties, "dense": _dense}
CASES = [(n, dt, g) for n in _MAKERS for dt in (torch.float32, F64)
         for g in (None, 3)]


@pytest.fixture(scope="module")
def ops():
    return {}


def _case(ops, name, dtype, grid):
    key = (name, dtype)
    if key not in ops:
        ops[key] = _MAKERS[name](dtype)
    w = ops[key]
    return w, ds.trop_plan(w, grid or ds._grid("cpu"))


def _state(Sp, B, dtype, seed):
    """A state of a few powers of two (ties) and a zero column."""
    rng = np.random.default_rng(seed)
    a = 2.0 ** -rng.integers(0, 4, size=(Sp, B)).astype(np.float64)
    a *= rng.uniform(size=(Sp, B)) < 0.9
    a[:, 1] = 0.0
    return torch.from_numpy(a).to(dtype)


def _emulate(pt, a):
    """K6t's product from its plan: per piece the max over its entries of
    w * a[src] from +0 (float32 on the products' bits as ints), the whole
    rows' maxima as they are, a split row's pieces merged by max into the
    row's zeroed slot (the kernel's atomicMax on the bits)."""
    Sp, B = a.shape
    pcs = pt.pieces.long()
    n = pcs[:, 2] - pcs[:, 1]
    owner = torch.repeat_interleave(torch.arange(pcs.shape[0]), n)
    prod = pt.w[:, None] * a[pt.src.long()]  # each product one rounding
    f32 = a.dtype == torch.float32
    vals = prod.view(torch.int32) if f32 else prod
    piece = torch.zeros((pcs.shape[0], B), dtype=vals.dtype)
    piece.scatter_reduce_(0, owner[:, None].expand(-1, B), vals, "amax")
    partial = torch.zeros((max(pt.n_partials, 1), B), dtype=vals.dtype)
    whole = pcs[:, 3] < 0
    partial.scatter_reduce_(0, pcs[~whole, 3][:, None].expand(-1, B),
                            piece[~whole], "amax")
    y = torch.zeros((Sp, B), dtype=vals.dtype)
    y[pcs[whole, 0]] = piece[whole]
    parts = pt.parts.long()
    split = torch.nonzero(parts[:, 1] > 0)[:, 0]
    y[split] = partial[parts[split, 0]]
    return y.view(torch.float32) if f32 else y


@pytest.mark.parametrize("name,dtype,grid", CASES)
def test_plan_covers_every_entry_once(ops, name, dtype, grid):
    """The entries are the operator's non-zeros by row then source, in
    the operator's dtype; the pieces, in warp order, are the rows in order
    and their entry ranges tile [0, nnz) in order; a row is one piece (slot
    -1) or k pieces of one slot, (slot, k) in ``parts``, the split rows'
    slots 0, 1, .. in row order; the warps' lists are contiguous and cover
    every piece."""
    w, pt = _case(ops, name, dtype, grid)
    Sp = w.shape[0]
    rows, cols = torch.nonzero(w, as_tuple=True)
    assert torch.equal(pt.src.long(), cols) and pt.w.dtype == dtype
    assert torch.equal(pt.w, w[rows, cols])
    pcs, wp = pt.pieces.long(), pt.wp.long()
    assert wp[0] == 0 and wp[-1] == pcs.shape[0] and (wp.diff() >= 0).all()
    assert (wp.numel() - 1) == (grid or ds._grid("cpu")) * ds._WARPS
    assert pcs[0, 1] == 0 and pcs[-1, 2] == rows.numel()
    assert torch.equal(pcs[1:, 1], pcs[:-1, 2])  # contiguous, in order
    assert (pcs[:, 0].diff() >= 0).all()
    counts = torch.bincount(rows, minlength=Sp)
    k = torch.bincount(pcs[:, 0], minlength=Sp)
    assert (k >= 1).all()  # every row, with entries or without
    got = torch.zeros(Sp, dtype=torch.long).index_add_(
        0, pcs[:, 0], pcs[:, 2] - pcs[:, 1])
    assert torch.equal(got, counts)
    parts = pt.parts.long()
    split = k > 1
    assert torch.equal(parts[:, 1], torch.where(split, k, 0))
    assert (parts[~split, 0] == -1).all() and (pcs[~split[pcs[:, 0]], 3]
                                               == -1).all()
    assert torch.equal(parts[split, 0], torch.arange(pt.n_partials))
    on_split = split[pcs[:, 0]]
    assert torch.equal(pcs[on_split, 3], parts[pcs[on_split, 0], 0])


@pytest.mark.parametrize("name,dtype,grid", CASES)
def test_plan_balances_the_warps(ops, name, dtype, grid):
    """Each piece costs its entries and ds._ROW_COST; a whole row of two
    or more entries costs at most two warps' mean share, a split row's
    pieces about one share (or half the row); a warp's pieces cost at most
    one share beyond its largest piece."""
    w, pt = _case(ops, name, dtype, grid)
    pcs, wp = pt.pieces.long(), pt.wp.long()
    n_warps = wp.numel() - 1
    n = pcs[:, 2] - pcs[:, 1]
    cost = (n + ds._ROW_COST).double()
    share = float(cost.sum()) / n_warps
    whole = pcs[:, 3] < 0
    assert ((cost[whole] <= 2 * share) | (n[whole] <= 1)).all()
    rows = torch.bincount(pcs[:, 0], weights=n.double())[pcs[~whole, 0]]
    assert ((n[~whole] <= share + 1) | (n[~whole] <= rows / 2 + 1)).all()
    assert (n[~whole] >= 1).all()
    per_warp = torch.zeros(n_warps, dtype=F64).index_add_(
        0, torch.repeat_interleave(torch.arange(n_warps), wp.diff()), cost)
    assert float(per_warp.max()) <= share + float(cost.max()) + 1e-9
    if name == "lm32" and grid is None:
        # the final state's 1,025 in-arcs spread over ~42 warps' pieces;
        # no warp carries more than two shares
        fin = int(torch.bincount(pcs[:, 0]).argmax())
        assert int((pcs[:, 0] == fin).sum()) >= 40
        assert float(per_warp.max()) <= 2 * share


@pytest.mark.parametrize("name,dtype,grid", CASES)
def test_emulated_product_is_the_dense_max_bit_for_bit(ops, name, dtype,
                                                       grid):
    """The kernel's product emulated from the plan equals the twin's dense
    max of products, bit for bit, on a tie-heavy state with a zero column
    (B = 5 and 24)."""
    w, pt = _case(ops, name, dtype, grid)
    for B, seed in ((5, 0), (24, 1)):
        a = _state(w.shape[0], B, dtype, seed)
        want = ds._trop_product(w, a)
        got = _emulate(pt, a)
        assert torch.equal(got.view(torch.int64 if dtype == F64
                                    else torch.int32),
                           want.view(torch.int64 if dtype == F64
                                     else torch.int32)), (name, B)


def test_trop_operator_carries_its_plan():
    """``trop_operator`` of a float32 and a float64 V=16 graph: the
    kernel operator's forward operator with its plan on the default grid,
    cached on the graph."""
    fsm, spdf, P, _ = port_lm_graph(16)
    for dt in (torch.float32, F64):
        cf = compile_port(fsm, spdf, P, strategy="dense", dtype=dt)
        top = ds.trop_operator(cf)
        assert top is ds.trop_operator(cf)
        assert top.wf is ds.kernel_operator(cf).wf
        assert top.pt.w.dtype == dt
        assert top.pt.wp.numel() - 1 == ds._grid("cpu") * ds._WARPS
