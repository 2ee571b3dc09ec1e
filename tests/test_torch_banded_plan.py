"""K5b's host plan of the posteriors (``banded_scan.pdf_plan``): each
stacked numerator lattice's distinct pdfs and, for each, its states in the
fixed order in which K5b sums them; and K5a's/K5b's shared-memory figures
in the admission.

The kernel writes a graph's posteriors only at the pdfs of its plan, sums
each pdf's gamma in the plan's order and scales the sums by one reciprocal
of the frame's gamma sum.  On the CPU that is held against the plain twin
``backward_plain`` through a torch emulation of those sums; the CUDA
kernel itself is held against the twin on the card by ``chip_smoke.py``
(phase 7).  Inputs are numerator lattices over random pdf sequences, made
from numpy seeds with the helpers of ``tests/test_torch_banded.py``."""
import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import banded_scan as bsc
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import compile_port, inputs, numerator, numerators

P = 24
CU = (Path(bsc.__file__).parent / "csrc" / "banded_scan.cu").read_text()


def _stack(graphs, p=P):
    return mt.stack([compile_port(f, sp, p, strategy="banded")
                     for f, sp in graphs])


def _case(name):
    """(stacked graph, lhs, lengths) of one of the plan's test cases."""
    if name == "mixed":  # test_torch_banded's mixed fixture: skip arcs too
        rng = np.random.default_rng(21)
        graphs = numerators(rng, 5, P, [6, 9, 4, 7, 5], skip=(2,), lib=mt)
        lhs, lens = inputs(5, 12, P, 4, [12, 10, 12, 9, 3])
        return _stack(graphs), lhs, lens
    if name == "stack128":  # its G = 128 stack of 4-8-state lattices
        rng = np.random.default_rng(3)
        graphs = numerators(rng, 128, P, [4 + g % 5 for g in range(128)],
                            lib=mt)
        lhs = rng.normal(size=(128, 10, P)).astype(np.float32)
        lens = np.clip(3 + rng.integers(0, 8, size=128), 0, 10).astype(
            np.int32)
        return _stack(graphs), lhs, lens
    if name == "repeated":  # pdfs repeated within a lattice, skip arcs
        rng = np.random.default_rng(7)
        graphs = [numerator(rng.integers(0, 3, size=L), P, skip=g % 2, lib=mt)
                  for g, L in enumerate([9, 12, 6, 15])]
        lhs, lens = inputs(4, 20, P, 8, [20, 17, 20, 16], cliffs=True)
        return _stack(graphs), lhs, lens
    # the step's 78-state lattices over 384 pdfs, two of them infeasible:
    # lengths 1 and 60 are shorter than the lattice, 78 is a single path
    rng = np.random.default_rng(3)
    graphs = [numerator(rng.integers(0, 384, size=78), 384, lib=mt)
              for _ in range(4)]
    lhs, lens = inputs(4, 100, 384, 11, [100, 1, 60, 78], cliffs=True)
    return _stack(graphs, 384), lhs, lens


CASES = ["mixed", "stack128", "repeated", "long"]


@functools.lru_cache(maxsize=None)
def _prepared(name):
    """(name, graph, its kernels' operator, ext, the twin's alphas,
    lengths) of a case."""
    cf, lhs, lens = _case(name)
    kop = bsc.kernel_operator(cf)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), kop.P1 - 1)
    alphas = bsc.fwd_sweep_plain(kop, ext, msh)[0]
    return name, cf, kop, ext, alphas, lens


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return _prepared(request.param)


def emulate_k5b(kop, ext, alphas):
    """K5b's posterior sums in its order, float64 before the float32 cast:
    the gamma sum of a frame in lane order (lane l adds states l, l + 32,
    ... from 0, then the xor butterfly 16 .. 1), its reciprocal (1 where it
    is 0), and each plan pdf's gamma summed over the plan's states in
    order, from 0."""
    Nf, P1, G = ext.shape
    Sp = kop.Sp
    n, pdf, seg, state = (x.long() for x in bsc.plan_fields(kop.plan, Sp))
    lanes = torch.arange(32)
    J = -(-Sp // 32)
    longest = int((seg[:, 1:] - seg[:, :-1]).max())
    posts = torch.zeros((Nf, P1, G), dtype=torch.float64)
    entry = torch.arange(Sp)[None, :] < n[:, None]  # (G, Sp) real entries
    for t, gam in bsc.gammas_plain(kop, ext, alphas):
        pad = gam.new_zeros((32 * J, G))
        pad[:Sp] = gam
        part = gam.new_zeros((32, G))
        for j in range(J):
            part = part + pad[32 * j:32 * (j + 1)]
        for d in (16, 8, 4, 2, 1):
            part = part + part[lanes ^ d]
        tot = part[0]
        rt = torch.where(tot > 0, 1.0 / tot, torch.ones_like(tot))
        ordered = gam.T.gather(1, state)  # (G, Sp): gamma in plan order
        acc = gam.new_zeros((G, Sp))
        for k in range(longest):
            idx = seg[:, :-1] + k
            ok = idx < seg[:, 1:]
            acc = acc + torch.where(
                ok, ordered.gather(1, idx.clamp(max=Sp - 1)),
                torch.zeros_like(acc))
        vals = torch.where(entry, acc * rt[:, None], torch.zeros_like(acc))
        posts[t].T.scatter_add_(1, torch.where(entry, pdf, 0), vals)
    return posts


def _plan_mask(kop):
    """(P1, G) bool: the pdfs of each graph's plan."""
    n, pdf, _, _ = (x.long() for x in bsc.plan_fields(kop.plan, kop.Sp))
    mask = torch.zeros((kop.P1, kop.G), dtype=torch.bool)
    for g in range(kop.G):
        mask[pdf[g, :n[g]], g] = True
    return mask


def test_plan_by_hand():
    spdf = np.array([[3], [1], [3], [0], [1]], dtype=np.int32)
    row = bsc.pdf_plan(spdf)[0]
    Sp = 5
    assert row[0] == 3
    assert list(row[1:4]) == [0, 1, 3]
    assert list(row[1 + Sp:2 + 2 * Sp]) == [0, 1, 3, 5, 5, 5]
    assert list(row[2 + 2 * Sp:]) == [3, 1, 4, 0, 2]


def test_plan_lists_every_state_once_under_its_pdf(case):
    _, _, kop, _, _, _ = case
    Sp = kop.Sp
    n, pdf, seg, state = (x.cpu().numpy()
                          for x in bsc.plan_fields(kop.plan, Sp))
    spdf = kop.spdf.cpu().numpy()
    assert kop.plan.dtype == torch.int32
    for g in range(kop.G):
        k = n[g]
        assert sorted(state[g]) == list(range(Sp))  # every state once
        assert (np.diff(pdf[g, :k]) > 0).all()  # distinct pdfs, ascending
        assert set(pdf[g, :k]) == set(spdf[:, g])
        assert seg[g, 0] == 0 and (seg[g, k:] == Sp).all()
        assert (np.diff(seg[g, :k + 1]) > 0).all()
        for e in range(k):
            sts = state[g, seg[g, e]:seg[g, e + 1]]
            assert (spdf[sts, g] == pdf[g, e]).all()  # under its own pdf
            assert (np.diff(sts) > 0).all()  # in ascending state order
        assert k <= Sp


def test_plan_is_cached_on_the_graph(case):
    _, cf, kop, _, _, _ = case
    assert bsc.kernel_operator(cf) is kop
    assert cf._cache["banded_scan"].plan is kop.plan
    assert kop.plan.device == cf.device


def test_emulated_k5b_sums_match_backward_plain(case):
    """The plan's order and the reciprocal move the float64 posteriors by
    a few ulps of 1: within 1e-12 of the twin's before the float32 cast."""
    _, _, kop, ext, alphas, _ = case
    ref = bsc.backward_plain(kop, ext, alphas, dtype=torch.float64)
    emu = emulate_k5b(kop, ext, alphas)
    assert float((emu - ref).abs().max()) <= 1e-12
    f32 = bsc.backward_plain(kop, ext, alphas)
    assert torch.equal(f32, ref.float())


def test_backward_plain_is_zero_outside_each_plan(case):
    """The premise of writing only a graph's own pdfs."""
    _, _, kop, ext, alphas, _ = case
    posts = bsc.backward_plain(kop, ext, alphas, dtype=torch.float64)
    outside = ~_plan_mask(kop)
    assert outside.any()
    assert (posts[:, outside] == 0).all()


def test_infeasible_lattices_give_all_zero_rows():
    _, _, kop, ext, alphas, lens = _prepared("long")
    for posts in (bsc.backward_plain(kop, ext, alphas, dtype=torch.float64),
                  emulate_k5b(kop, ext, alphas)):
        assert (posts[:, :, 1:3] == 0).all()  # lengths 1 and 60 < 78
        for g in (0, 3):  # feasible: each active frame sums to 1
            mass = posts[:lens[g], :, g].sum(dim=1)
            assert float((mass - 1).abs().max()) < 1e-12


def test_smem_words_follow_the_kernels_layout():
    """The admission's words are the buffers the kernels lay out, with the
    kernels' ring depths and warp counts, in the narrow and the wide
    instantiation (the global one takes none), at the step's shape and
    beyond; a launch takes the narrow one where its states fit in
    registers and its shared memory in a CTA, else the wide one where its
    states (5 per thread) and its shared memory fit, else the global one."""
    for name, value in (("DEPTH", bsc._DEPTH), ("YRING", bsc._YRING),
                        ("POST_WARPS", bsc._POST_WARPS),
                        ("WDEPTH", bsc._WDEPTH), ("WT", bsc._WT),
                        ("WREG", bsc._WREG), ("WPOST", bsc._WPOST),
                        ("WRING", bsc._WRING),
                        ("MAX_WJ", bsc._WIDE_J[-1]),
                        ("SMEM_MAX", bsc._SMEM_BYTES)):
        assert re.search(rf"constexpr int {name} = {value};", CU), name
    assert re.search(r"constexpr int MAX_J = (\d+);", CU).group(1) == str(
        bsc._NARROW_STATES // 32)
    D, R, W = bsc._DEPTH, bsc._YRING, bsc._POST_WARPS
    WD, WR, WW = bsc._WDEPTH, bsc._WRING, bsc._WT // 32
    for Sp, nO in ((80, 2), (8, 0), (1000, 8), (1208, 3)):
        nb, nx = max(nO, 1), max(nO - bsc._WREG, 0)
        fwd = {"X": 2 * 2 * Sp, "BW": 2 * nb * Sp, "OM": 2 * Sp,
               "AL": 2 * D * Sp, "FULL+DONE": 2 * 2 * D, "ER": D * Sp,
               "MR": D}
        bwd = {"X": 2 * 2 * Sp, "BW": 2 * nb * Sp, "OM": 2 * Sp,
               "YR": 2 * R * Sp, "GM": 2 * W * Sp, "AR": 2 * W * D * Sp,
               "FULL+EMPTY": 2 * 2 * R, "EFULL+EDONE": 2 * 2 * D,
               "ER": D * Sp, "ST": Sp}
        assert bsc._mode_words(Sp, nO, bsc.NARROW) == (
            sum(fwd.values()), sum(bwd.values()))
        fwd = {"Y": 2 * 2 * Sp, "BX": 2 * nx * Sp, "SD": 2 * 2 * WW,
               "FULL+DONE": 2 * 2 * WD, "ER": WD * Sp, "MR": WD, "EP": Sp,
               "EI": Sp, "SK": 2 * WW}
        bwd = {"Y": 2 * 2 * Sp, "BX": 2 * nx * Sp, "AR": 2 * WD * Sp,
               "GM": 2 * WR * Sp, "TT": 2 * WR * WW,
               "EFULL+EDONE": 2 * 2 * WD, "FULL+EMPTY": 2 * 2 * WR,
               "ER": WD * Sp, "EP": Sp, "EI": Sp, "SEG": Sp + 1, "POS": Sp,
               "SK": 2 * WW}
        assert bsc._mode_words(Sp, nO, bsc.WIDE) == (
            sum(fwd.values()), sum(bwd.values()))
        assert bsc._mode_words(Sp, nO, bsc.GLOBAL) == (0, 0)
    assert bsc._smem_words(80, 2) == (2760, 5744)
    assert bsc._wide(80, 2) == (False, False)
    assert bsc._wide(816, 2) == (False, False)  # K5b's narrow fits
    assert bsc._modes(824, 2) == ("narrow", "wide")
    assert bsc._modes(1032, 1) == ("wide", "wide")  # past 32 per lane
    assert bsc._modes(1280, 3) == ("wide", "wide")
    assert bsc._modes(1280, 3, 2) == ("wide", "wide")
    assert bsc._modes(1288, 3) == ("global", "global")  # past 5 per thread
    assert bsc._smem_words(824, 2) == (
        bsc._mode_words(824, 2, bsc.NARROW)[0],
        bsc._mode_words(824, 2, bsc.WIDE)[1])
    assert bsc._smem_words(1288, 3) == (0, 0)


def _reason_at(Sp, nO=3, G=128, **kw):
    """The admission's reason for a stack of G graphs of Sp states with
    nO offsets (the shapes only: the operator is zeros)."""
    rng = np.random.default_rng(21)
    cf = _stack(numerators(rng, 2, P, [6, 9], skip=(0, 1), lib=mt))
    assert len(cf.banded_offsets) == 3
    cf = dataclasses.replace(cf, alpha_hat=cf.alpha_hat.new_zeros((G, Sp)),
                             banded_offsets=cf.banded_offsets[:nO])
    return bsc.banded_scan_reject_reason(cf, G, **kw)


def test_admission_rejects_past_a_ctas_shared_memory(monkeypatch):
    """No shared-memory predicate: past a CTA's shared memory (2,504
    states) and at the JAX package's fused bound at G = 128 (24,576 states
    at three offsets) a stack is admitted, on a CUDA device too, where the
    global instantiation runs it.  What the admission still refuses for
    size is the card's free memory: the emission, alpha, posterior and
    state streams."""
    assert bsc._modes(2504, 3) == ("global", "global")
    assert (3 + 5) * 24576 * 128 * 4 <= 96 * 1024 * 1024  # JAX's VMEM rule
    for Sp in (2504, 24576):
        assert _reason_at(Sp) is None
        assert _reason_at(Sp, n_frames=128, device="cuda") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 * 10 ** 9, 80 * 10 ** 9))
    assert _reason_at(24576, n_frames=128, device="cuda:0") is None
    # N = 128: 3.2 GB of float64 alphas, ~0.05 GB of streams, 0.23 GB of
    # the global instantiation's scratch
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (2 * 10 ** 9, 80 * 10 ** 9))
    assert _reason_at(24576, n_frames=128, device="cuda:0") == (
        "emission, alpha, posterior and state streams ~3.5 GB exceed the "
        "card's 2.0 GB free (Sp = 24576, G = 128, N = 128)")
    assert _reason_at(24576, n_frames=128, device="cpu") is None
