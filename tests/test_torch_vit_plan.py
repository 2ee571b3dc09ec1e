"""The host plan of the persistent K7 (ops/vit_scan.py ``vit_plan``): the
queue of work items (row tile x 64-column tile) that the CTAs of the
cooperative grid take in every frame, and the transposed tier panels the
kernel stages; and a torch emulation of the kernel's tier rule, the max
found before the id: the value-only max over groups of g consecutive
source positions (the running value and group moving only where a group's
max is strictly greater, one resident pass of 128 positions at a time),
then the first position of the winning group whose product equals the max;
the maxima taken on the values or, as the kernel takes them, on the
products' float bits as ints.

The emulation is held bit for bit to ``block_matvec_max_arg``'s tie rule on
inputs with many exact ties, an all-zero column and denormal products, and,
inside the plain sweep, to the JAX package's K7 in interpret mode
(``pallas_block.block_fused_viterbi_fwd``).  The float64 instantiation's
rule (64 positions a pass, the maxima on the products' 64 bits as int64)
is held the same way to the float64 plain twin, on float64 ties and
float64 denormals, and inside the float64 plain sweep; and a torch
emulation of its ω argmax (a pair of words per copy under a lock for the
positive products, an atomic max of the j-word for the zero ones, items
in any order) to the twin's smallest argmax.  Graph: the 2M-arc (V=128)
LM ∘ HMM graph, the one LM ∘ HMM graph of the workloads that K7 admits (a
single affine tier), and a copy of its operator without the tier (every
row a band row); batches 128, 126 and 5 (B % 4 != 0: the kernel's scalar
branch).  Inputs are made from numpy seeds.  The CUDA
kernel itself is held against the plain twin on the card by
``chip_smoke.py`` (phases 15 and 17)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from markovmodels_tpu.ops import pallas_block as pb
from markovmodels_tpu.ops import pallas_scan as ps
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import blocked as tbl
from markovmodels_tpu_torch.ops import vit_scan as vs
from _torch_port import compile_port, inputs, jax_compiled, port_lm_graph

SC = 128  # positions resident per pass (csrc/vit_scan.cu)
SC64 = 64  # the same in the float64 instantiation (the same bytes)
GROUPS = [1, 4, 8, 32]
BATCHES = [128, 126, 5]


@functools.lru_cache(maxsize=None)
def _cf(V):
    return compile_port(*port_lm_graph(V)[:3], strategy="block")


def _kop(op):
    """The 2M-arc graph's operator ('2M'), or a copy without the tier
    ('no tier': its rows join the band rows, as chip_smoke.cut_operator
    makes them), with a fresh plan cache."""
    cf = _cf(128)
    assert vs.vit_scan_reject_reason(cf, 8) is None
    kop = bs.kernel_operator(cf, torch.float32)
    if op == "2M":
        return kop
    kd = kop.fwd
    rows = np.sort(np.concatenate([kd.band_rows.numpy(),
                                   kd.dst_rows.numpy().ravel()]))
    kd = kd._replace(W=kd.W[:0], src_rows=kd.src_rows[:0],
                     dst_rows=kd.dst_rows[:0],
                     band_rows=torch.from_numpy(rows.astype(np.int32)))
    return kop._replace(fwd=kd, plans={})


# ---------------------------------------------------------------------------
# the queue
# ---------------------------------------------------------------------------

def _tile_rows(kop):
    """(n_tiles, 64) state rows of each row tile in the plan's tile order
    (tier tiles, then band tiles), -1 where a tile has fewer rows."""
    kd = kop.fwd
    K, _, D = kd.W.shape
    dt = -(-D // 64)
    dst = np.full((K, dt * 64), -1, np.int64)
    dst[:, :D] = kd.dst_rows.numpy()
    band = kd.band_rows.numpy().astype(np.int64)
    nb = -(-len(band) // 64)
    pad = np.full(nb * 64, -1, np.int64)
    pad[:len(band)] = band
    return np.concatenate([dst.reshape(K * dt, 64), pad.reshape(nb, 64)])


@pytest.mark.parametrize("op", ["2M", "no tier"])
@pytest.mark.parametrize("B", BATCHES)
def test_every_item_once_and_every_row_once_per_frame(op, B):
    kop = _kop(op)
    pl = vs.vit_plan(kop, B)
    rows = _tile_rows(kop)
    ncb = -(-B // 64)
    assert pl.ncb == ncb
    q = pl.queue.numpy()
    assert q.shape == (len(rows) * ncb, 2) and q.dtype == np.int32
    np.testing.assert_array_equal(np.sort(q[:, 0]), np.arange(len(q)))
    for ct in range(ncb):  # each column tile covers every state row once
        tiles = q[q[:, 0] % ncb == ct, 0] // ncb
        r = rows[tiles].ravel()
        np.testing.assert_array_equal(np.sort(r[r >= 0]),
                                      np.arange(kop.Sp))


@pytest.mark.parametrize("B", BATCHES)
def test_queue_order_and_first_rows(B):
    """The documented order: every tier item, then every band item (the
    kernel takes the two parts with a position each), each in tile, then
    column-tile order; a band tile of consecutive rows carries its first
    row, every other tile -1."""
    kop = _kop("2M")
    q = vs.vit_plan(kop, B).queue.numpy()
    ncb = -(-B // 64)
    K, _, D = kop.fwd.W.shape
    n_tier = K * -(-D // 64) * ncb
    np.testing.assert_array_equal(q[:, 0], np.arange(len(q)))
    rows = _tile_rows(kop)
    first = rows[q[:, 0] // ncb]
    consec = (first >= 0).all(axis=1) & (np.diff(first, axis=1) == 1).all(
        axis=1)
    tier = np.arange(len(q)) < n_tier
    want0 = np.where(~tier & consec, first[:, 0], -1)
    np.testing.assert_array_equal(q[:, 1], want0)
    assert (q[n_tier:, 1] >= 0).any()


def test_plan_and_panels_are_cached_on_the_operator():
    kop = _kop("no tier")
    pl = vs.vit_plan(kop, 126)
    assert vs.vit_plan(kop, 126) is pl
    assert vs.vit_plan(kop, 128) is pl  # the same two column tiles
    assert vs.vit_plan(kop, 5) is not pl
    assert vs.vit_plan(kop, 5) is vs.vit_plan(kop, 64)
    kop = _kop("2M")
    assert vs.vit_plan(kop, 128) is vs.vit_plan(kop, 128)
    Wt = vs._panels_t(kop)
    assert vs._panels_t(kop) is Wt
    assert kop.plans["vit_panels"] is Wt


@pytest.mark.parametrize("op", ["2M", "no tier"])
def test_transposed_panels(op):
    kop = _kop(op)
    W = kop.fwd.W
    K, Sm, D = W.shape
    Wt = vs._panels_t(kop)
    assert Wt.dtype == torch.float32 and Wt.is_contiguous()
    assert Wt.shape == (K, D, -(-Sm // 4) * 4)
    assert torch.equal(Wt[:, :, :Sm], W.transpose(1, 2))
    assert (Wt[:, :, Sm:] == 0).all()


# ---------------------------------------------------------------------------
# the tier rule: the max before the id
# ---------------------------------------------------------------------------

def grouped_max_arg(W, Xg, g, sc=SC, bits=False):
    """The kernel's tier rule in torch: (K, Sm, D) panels and (K, Sm, B)
    gathered states -> (Y, A) (K, D, B): per resident pass of ``sc``
    positions the value-only max of each group of ``g`` products (zero
    padded), the running value and group moving where a group's max is
    strictly greater than the running value, then the first position of
    the winning group whose product equals it.  With ``bits``, every max
    and compare is taken on the products' bits as int32 (float32) or
    int64 (float64), as the kernel takes them (the bits of a non-negative
    value order as the value)."""
    K, Sm, D = W.shape
    B = Xg.shape[2]
    ibits = torch.int64 if W.dtype == torch.float64 else torch.int32
    best = torch.full((K, D, B), -1.0, dtype=W.dtype)
    ids = torch.zeros((K, D, B), dtype=torch.int32)
    if bits:
        best = torch.full((K, D, B), -1, dtype=ibits)
    for s0 in range(0, Sm, sc):
        n = min(sc, Sm - s0)
        nG = -(-n // g)
        p = W[:, s0:s0 + n, :, None] * Xg[:, s0:s0 + n, None, :]
        p = torch.cat([p, p.new_zeros((K, nG * g - n, D, B))], dim=1)
        p = p.reshape(K, nG, g, D, B)
        if bits:
            p = p.view(ibits)
        gm = p.amax(dim=2)  # one of the products, exactly
        gid = torch.full((K, D, B), -1, dtype=torch.int64)
        for G in range(nG):
            upd = gm[:, G] > best
            best = torch.where(upd, gm[:, G], best)
            gid = torch.where(upd, G, gid)
        grp = p.gather(1, gid.clamp(min=0)[:, None, None].expand(
            K, 1, g, D, B))[:, 0]
        u = torch.arange(g)[None, :, None, None]
        first = torch.where(grp == best[:, None], u, g).amin(dim=1)
        ids = torch.where(gid >= 0, (s0 + gid * g + first).int(), ids)
    return (best.view(W.dtype) if bits else best), ids


def _tied_inputs(Sm, seed, dtype=np.float32):
    """Panels and states from {0, 1/4, 1/2, 1}: many exact ties; column 1
    of the states all zero; column 2 of tiny values whose products are
    denormal (in float64: values near 1e-160 and weights near 1e-150)."""
    rng = np.random.default_rng(seed)
    tiny_x, tiny_w = (1e-20, 1e-19) if dtype == np.float32 else (1e-160,
                                                                  1e-150)
    W = rng.choice(np.array([0, 0.25, 0.5, 1], dtype), size=(3, Sm, 9))
    X = rng.choice(np.array([0, 0.25, 0.5, 1], dtype), size=(3, Sm, 4))
    X[:, :, 1] = 0
    X[:, :, 2] = rng.choice(np.array([0, 1, 2, 3], dtype) * dtype(tiny_x),
                            size=(3, Sm))
    W[1, :, 3] *= dtype(tiny_w)  # denormal products in column 2
    return torch.from_numpy(W), torch.from_numpy(X)


@pytest.mark.parametrize("bits", [False, True])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("Sm", [128, 200])
def test_grouped_rule_matches_the_tie_rule(g, Sm, bits):
    """Bit-equal values and ids to ``_tier_max_arg`` (the plain twin's
    rule: the smallest position among equal maxima), the maxima taken on
    the values or on their bits; Sm = 200 takes two resident passes."""
    W, X = _tied_inputs(Sm, seed=g + Sm)
    prod = W[1, :, 3] * X[1, :, 2]
    assert ((prod > 0) & (prod < torch.finfo(torch.float32).tiny)).any()
    Y, A = tbl._tier_max_arg(W, X)
    Yg, Ag = grouped_max_arg(W, X, g, bits=bits)
    assert torch.equal(Yg, Y) and torch.equal(Ag, A)
    assert (A[:, :, 1] == 0).all() and (Y[:, :, 1] == 0).all()
    assert (A > 0).any()


@pytest.mark.parametrize("bits", [False, True])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("Sm", [128, 200])
def test_float64_grouped_rule_matches_the_tie_rule(g, Sm, bits):
    """The float64 instantiation's rule (64 positions a pass, the maxima on
    the products' 64 bits) bit-equal to ``_tier_max_arg`` in float64 on
    float64 ties and denormal products; Sm = 200 takes four passes."""
    W, X = _tied_inputs(Sm, seed=3 * g + Sm, dtype=np.float64)
    prod = W[1, :, 3] * X[1, :, 2]
    assert ((prod > 0) & (prod < torch.finfo(torch.float64).tiny)).any()
    Y, A = tbl._tier_max_arg(W, X)
    Yg, Ag = grouped_max_arg(W, X, g, sc=SC64, bits=bits)
    assert Y.dtype == Yg.dtype == torch.float64
    assert torch.equal(Yg, Y) and torch.equal(Ag, A)
    assert (A[:, :, 1] == 0).all() and (Y[:, :, 1] == 0).all()
    assert (A > 0).any()


def omega_argmax_f64(om, a, items, order, copy_of, CM=16):
    """A torch emulation of the float64 K7's ω argmax of (om ⊙ a) (Sp, B):
    each item (a list of rows) takes its rows' lexicographic max of (the
    product's 64 bits, 2^32 - 1 - j); a zero product's j-word goes to its
    copy's zero word by a max, a positive one replaces its copy's pair when
    it is larger (under the pair's lock, after a check against the pair's
    value); items run in ``order``, item i into copy ``copy_of[i]``.  The
    frame's end takes the largest value over the copies, the largest
    j-word of the copies holding it, or the zero words' largest where
    every product is 0.  Returns (value (B,), argmax (B,))."""
    Sp, B = a.shape
    bits = (om[:, None] * a).view(torch.int64)  # >= 0: orders as the value
    jw = (0xFFFFFFFF - torch.arange(Sp, dtype=torch.int64))[:, None]
    pv = torch.zeros((CM, B), dtype=torch.int64)
    pw = torch.zeros((CM, B), dtype=torch.int64)
    zw = torch.zeros((CM, B), dtype=torch.int64)
    for i in order:
        rows = torch.as_tensor(items[i])
        v, w = bits[rows], jw[rows].expand(-1, B)
        kv = v.amax(dim=0)
        kw = torch.where(v == kv, w, -1).amax(dim=0)
        c = copy_of[i]
        zero = kv == 0
        zw[c] = torch.where(zero, torch.maximum(zw[c], kw), zw[c])
        win = ~zero & ((kv > pv[c]) | ((kv == pv[c]) & (kw > pw[c])))
        pv[c] = torch.where(win, kv, pv[c])
        pw[c] = torch.where(win, kw, pw[c])
    M = pv.amax(dim=0)
    W = torch.where(M == 0, zw.amax(dim=0),
                    torch.where(pv == M, pw, -1).amax(dim=0))
    return M.view(torch.float64), 0xFFFFFFFF - W


def test_float64_omega_argmax_matches_the_twin():
    """The emulation of the float64 ω pairs equal to the plain twin's rule
    (``viterbi_fwd_plain``: the max of ω ⊙ a and its smallest argmax) on
    tie-heavy inputs with denormal products, an all-zero column (every
    product 0: the zero words decide) and a column whose only positive
    products tie; for several item orders and copy assignments."""
    rng = np.random.default_rng(5)
    Sp, B = 200, 6
    om = rng.choice(np.array([0, 0.25, 0.5, 1.0]), size=Sp)
    a = rng.choice(np.array([0, 0.5, 1.0]), size=(Sp, B))
    a[:, 1] = 0  # every product 0
    a[:, 2] = 0
    a[[7, 90, 150], 2] = 1.0
    om[[7, 90, 150]] = 0.5  # three tied positive products
    a[:, 3] *= 1e-160
    om[::3] *= 1e-150  # denormal products
    om, a = torch.from_numpy(om), torch.from_numpy(a)
    prod = om[:, None] * a
    assert ((prod > 0) & (prod < torch.finfo(torch.float64).tiny)).any()
    want_v = prod.amax(dim=0)
    flat = torch.arange(Sp)[:, None]
    want_j = torch.where(prod == want_v, flat, Sp).amin(dim=0)
    assert want_j[1] == 0 and want_j[2] == 7
    perm = rng.permutation(Sp)
    items = [perm[i:i + 23] for i in range(0, Sp, 23)]  # scattered rows
    for seed in range(4):
        r = np.random.default_rng(seed)
        order = r.permutation(len(items))
        copy_of = r.integers(0, 16, size=len(items))
        v, j = omega_argmax_f64(om, a, items, order, copy_of)
        assert torch.equal(v, want_v) and torch.equal(j, want_j)


@pytest.fixture(scope="module")
def k7_pair():
    """The JAX package's K7 in interpret mode and the emissions it ran on:
    the 2M-arc graph, B=8, N=7, mixed lengths with 1, ±30-nat cliffs (the
    inputs of test_torch_viterbi.py)."""
    cj, ct = jax_compiled(128), _cf(128)
    lhs, lens = inputs(8, 7, ct.num_pdfs, seed=23,
                       lens=[7, 1, 5, 7, 2, 6, 4, 3], cliffs=True)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MMTPU_NO_PALLAS", "MMTPU_VIT_PALLAS", "MMTPU_NO_VITBP",
                  "MMTPU_VIT_PACKED"):
            mp.delenv(k, raising=False)
        mp.setenv("MMTPU_PALLAS_INTERPRET", "1")
        assert pb.vit_scan_supported(cj, 8)
        ext, msh = ps.prepare_emissions(jnp.asarray(lhs), jnp.asarray(lens),
                                        ct.num_pdfs)
        out_j = [np.asarray(x)
                 for x in pb.block_fused_viterbi_fwd(cj, ext, msh)]
    return out_j, torch.from_numpy(np.array(ext)), torch.from_numpy(
        np.array(msh))


@pytest.mark.parametrize("g", GROUPS)
def test_grouped_rule_in_the_sweep_matches_jax_k7(k7_pair, g, monkeypatch):
    """The plain sweep with the tier rule replaced by the emulation (on the
    products' bits, as the kernel) gives the JAX kernel's ids and ω
    argmaxes bit for bit."""
    (bj, fj, *_), ext, msh = k7_pair
    monkeypatch.setattr(tbl, "_tier_max_arg",
                        lambda W, X: grouped_max_arg(W, X, g, bits=True))
    bt, ft, *_ = vs.viterbi_fwd_plain(_cf(128), ext, msh)
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(ft.numpy(), fj)
    assert (bj < 128).any() and (bj == 255).any()


def test_float64_grouped_rule_in_the_float64_sweep():
    """The float64 plain sweep with the tier rule replaced by the float64
    emulation (64 positions a pass, on the products' 64 bits) gives the
    float64 twin's ids and ω argmaxes bit for bit, on the 2M-arc graph
    compiled float64 (B=8, N=7, mixed lengths with 1, ±30-nat cliffs); the
    JAX package's K7 refuses float64, so the twin is the reference."""
    ct = compile_port(*port_lm_graph(128)[:3], strategy="block",
                      dtype=torch.float64)
    lhs, lens = inputs(8, 7, ct.num_pdfs, seed=23,
                       lens=[7, 1, 5, 7, 2, 6, 4, 3], cliffs=True)
    ext, msh = ps_prepare(lhs, lens, ct.num_pdfs)
    bt, ft, *rest = vs.viterbi_fwd_plain(ct, ext, msh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbl, "_tier_max_arg",
                   lambda W, X: grouped_max_arg(W, X, 8, sc=SC64, bits=True))
        be, fe, *rest_e = vs.viterbi_fwd_plain(ct, ext, msh)
    assert torch.equal(be, bt) and torch.equal(fe, ft)
    assert all(torch.equal(x, y) for x, y in zip(rest, rest_e))
    assert (bt < 128).any() and (bt == 255).any()


def ps_prepare(lhs, lens, P):
    """The float64 emissions of numpy inputs (the port's prepare)."""
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    return prepare_emissions(torch.from_numpy(lhs).double(),
                             torch.from_numpy(lens), P, torch.float64)
