"""The cluster instantiation of K5a/K5b (stacked numerators past the wide
K5's 1,280 states, up to what a thread block cluster of 8 CTAs holds on
chip): which instantiation and cluster size a stack takes, the cut of a
lattice into the CTAs' ranges and its halos, the local plan each CTA
builds from the graph's plan row, the shared-memory words against the
kernels' layout, and torch emulations of the kernels' fixed-order
reductions held to the plain twins, which the kernels are held to on the
card (``chip_smoke.py`` phase 8b).

A graph runs on the C CTAs of one cluster: CTA r owns states [r L, min((r
+ 1) L, Sp)), L = ceil(Sp / C) rounded up to even, thread i of its chain
the states lo + i + 256 j.  A frame's omega dot (K5a) and gamma sum (K5b)
are each thread's partial over its states in order, a butterfly over the
warp's lanes, the 8 warps' partials in warp order (the wide and global
kernels' reductions: one CTA gives their bits), then the CTAs' partials in
rank order; a pdf's posterior is each CTA's sum of the pdf's states in its
range (in order from the first, or by a warp past 32 states) added in
rank order.  Inputs: numerator lattices with skip arcs (three band
offsets; ``chip_smoke.skip_numerators``), made from numpy seeds."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu_torch.ops import banded_scan as bsc
from markovmodels_tpu_torch.ops.emissions import prepare_emissions
from _torch_port import compile_port
from test_torch_banded_wide import (_butterfly, _exp_key, _lanes_then_warps,
                                    emulate_k5a_wide, emulate_k5b_wide,
                                    skip_numerators)

P = 40
WT = bsc._WT
CU = (Path(bsc.__file__).parent / "csrc" / "banded_scan.cu").read_text()


def cluster_ranges(Sp, C):
    """[(lo, hi)] of the C CTAs of a cluster: rank r owns states lo .. hi
    - 1 (``range_len``: each range but the last L states)."""
    L = bsc._range_len(Sp, C)
    return [(r * L, min((r + 1) * L, Sp)) for r in range(C)]


@pytest.mark.parametrize("Sp, nO, tw, P1, span, modes, sizes", [
    (1208, 3, 1, 385, 2, ("wide", "wide"), (0, 0)),
    (1288, 3, 1, 385, 2, ("cluster", "cluster"), (1, 1)),
    (1408, 3, 1, 385, 2, ("cluster", "cluster"), (1, 1)),
    (1816, 3, 1, 385, 2, ("cluster", "cluster"), (1, 1)),
    (2504, 3, 1, 385, 2, ("cluster", "cluster"), (1, 1)),
    (3008, 3, 1, 385, 2, ("cluster", "cluster"), (1, 1)),
    (3008, 3, 2, 385, 2, ("cluster", "cluster"), (1, 2)),
    (6000, 3, 1, 385, 2, ("cluster", "cluster"), (1, 2)),
    (7008, 3, 1, 97, 2, ("cluster", "cluster"), (2, 3)),
    (7008, 3, 2, 97, 2, ("cluster", "cluster"), (2, 3)),
    (24576, 3, 1, 385, 2, ("cluster", "cluster"), (4, 8)),
    (24576, 3, 2, 385, 2, ("cluster", "global"), (6, 0)),
    (40000, 3, 1, 385, 2, ("cluster", "global"), (7, 0)),
    (52008, 3, 1, 385, 2, ("global", "global"), (0, 0)),
    (3008, 3, 1, 385, 17, ("global", "global"), (0, 0)),
    (3008, 8, 1, 385, 7, ("cluster", "cluster"), (1, 2)),
    (3009, 3, 1, 385, 2, ("global", "global"), (0, 0)),
])
def test_instantiation_and_cluster_size_each_shape_takes(
        Sp, nO, tw, P1, span, modes, sizes):
    """Past the wide instantiation a lattice takes the cluster one where a
    cluster of at most 8 CTAs holds its state and constants (an even Sp,
    offsets within the 16-state halos), the cluster size the smallest
    that does, else the global one; ``_smem_words`` is that
    instantiation's."""
    assert bsc._modes(Sp, nO, tw, P1, span) == modes
    assert bsc._cluster_sizes(Sp, nO, tw, P1, span) == sizes
    for k, (m, C) in enumerate(zip(modes, sizes)):
        words = bsc._smem_words(Sp, nO, tw, P1, span)[k]
        if m == "cluster":
            assert words == -(-bsc._cluster_bytes(
                Sp, nO, C, tw, P1, bool(k)) // 4)
            assert 4 * words <= bsc._SMEM_BYTES
        else:
            assert m != "global" or words == 0


def test_cluster_size_is_the_smallest_that_fits():
    """The cluster's CTAs a graph are the smallest C that fits (one CTA a
    graph wherever one CTA holds it); the C past it fit too, up to 8."""
    for Sp in (3008, 6000, 7008, 12000, 24576):
        for bwd in (False, True):
            fits = [C for C in range(1, 9)
                    if bsc._cluster_fits(Sp, 3, C, 1, 385, bwd, 2)]
            C = bsc._cluster_size(Sp, 3, 1, 385, 2, bwd)
            assert C == min(fits) and fits == list(range(C, 9))
            if bsc._cluster_fits(Sp, 3, 1, 1, 385, bwd, 2):
                assert C == 1


@pytest.mark.parametrize("Sp, C", [(1288, 1), (3008, 2), (3008, 3),
                                   (6002, 7), (24576, 8), (40000, 7),
                                   (64, 8)])
def test_ranges_own_every_state_once_and_sources_lie_next_door(Sp, C):
    """The C ranges cover the lattice, each state once and none empty,
    each range but the last L = ceil(Sp / C) rounded to even states (its
    alphas whole 16-byte units); thread i of a CTA's chain owns its states
    lo + i + 256 j.  A source s - off (forward) or s + off (backward) of
    any offset up to the halo's 16 states (and the last range's length)
    lies in the state's own range or a neighbour's, within the halo of the
    state's slot; outside the lattice it reads the zero halo of the first
    or the last CTA."""
    ranges = cluster_ranges(Sp, C)
    L = bsc._range_len(Sp, C)
    assert L % 2 == 0 and len(ranges) == C
    owner = np.full(Sp, -1)
    for r, (lo, hi) in enumerate(ranges):
        assert lo < hi and (hi - lo) % 2 == 0
        assert hi - lo == L or r == C - 1
        for tid in range(WT):
            for s in range(lo + tid, hi, WT):
                assert owner[s] == -1
                owner[s] = r
    assert (owner >= 0).all()
    last = ranges[-1][1] - ranges[-1][0]
    span = min(bsc._HMAX, last) if C > 1 else bsc._HMAX
    assert bsc._cluster_fits(Sp, 1, C, 1, 385, False, span)
    assert not bsc._cluster_fits(Sp, 1, C, 1, 385, False, bsc._HMAX + 1)
    s = np.arange(Sp)
    lo = np.array([ranges[r][0] for r in owner])
    hi = np.array([ranges[r][1] for r in owner])
    for off in range(-span, span + 1):
        for d in (-1, 1):  # K5a reads s - off, K5b s + off
            src = s - d * off
            local = src - lo  # its index in the state's CTA's slot
            assert ((local >= -bsc._HMAX) & (local < L + bsc._HMAX)).all()
            halo = (local < 0) | (local >= hi - lo)
            assert (np.abs(local[halo] - np.where(
                local[halo] < 0, 0, (hi - lo)[halo] - 1)) <= span).all()
            inside = (src >= 0) & (src < Sp)
            assert (np.abs(owner[s[inside]] - owner[src[inside]]) <= 1).all()
            out = ~inside
            assert ((owner[s[out]] == 0) | (owner[s[out]] == C - 1)).all()


def local_plan(row, Sp, lo, hi, efin=-1):
    """The kernels' ``local_plan`` in numpy: the plan row's entries with a
    state in [lo, hi) (and entry efin), in the row's order: (pdfs, row
    entries, each entry's places LSEG in the local order, the local order
    LST of the range's states, each state's local entry EI)."""
    n = int(row[0])
    pdf, seg, st = row[1:1 + n], row[1 + Sp:2 + Sp + n], row[2 + 2 * Sp:]
    ep, lge, lseg, lst = [], [], [0], []
    for e in range(n):
        sts = st[seg[e]:seg[e + 1]]
        run = sts[(sts >= lo) & (sts < hi)]
        if len(run) or e == efin:
            ep.append(int(pdf[e]))
            lge.append(e)
            lst.extend(int(s) - lo for s in run)
            lseg.append(len(lst))
    ei = np.full(hi - lo, -1)
    for k in range(len(ep)):
        ei[lst[lseg[k]:lseg[k + 1]]] = k
    return (np.array(ep), np.array(lge), np.array(lseg), np.array(lst), ei)


@pytest.fixture(scope="module")
def plan_stack():
    """A stack of three skip-arc lattices and a short one over P pdfs
    (the last of each lattice over 3 pdfs: long runs), Sp = 1,608."""
    cf = mt.stack([compile_port(f, sp, P, strategy="banded")
                   for f, sp in skip_numerators(P, (1600, 1100, 900, 60), 5,
                                                mt)])
    return bsc.kernel_operator(cf)


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8])
def test_local_plans_list_each_state_of_the_range_once(plan_stack, C):
    """Each CTA's local plan lists the states of its range once, each under
    its own pdf, ascending within an entry, entries in the row's order;
    fin's entry is in every K5a plan (its emission feeds the phony row);
    with one CTA the local plan is the plan row itself."""
    kop = plan_stack
    Sp = kop.Sp
    plan = kop.plan.numpy()
    spdf = kop.spdf.numpy()
    fin = kop.fin.numpy()
    for g in range(kop.G):
        row = plan[g]
        n = int(row[0])
        efin = int(np.searchsorted(row[1:1 + n], spdf[fin[g], g]))
        for lo, hi in cluster_ranges(Sp, C):
            ep, lge, lseg, lst, ei = local_plan(row, Sp, lo, hi, efin)
            assert sorted(lst) == list(range(hi - lo))
            assert (ei >= 0).all() and (np.diff(lge) > 0).all()
            assert efin in lge
            for k in range(len(ep)):
                sts = np.array(lst[lseg[k]:lseg[k + 1]]) + lo
                assert (spdf[sts, g] == ep[k]).all()
                assert (np.diff(sts) > 0).all()
            if C == 1:
                assert list(lseg) == list(row[1 + Sp:2 + Sp + n])
                assert list(lst) == list(row[2 + 2 * Sp:])
                assert list(ep) == list(row[1:1 + n])
        assert len(local_plan(row, Sp, 0, Sp)[0]) <= min(Sp, kop.P1)


def _carve():
    """[(name, taken by K5a, taken by K5b, element type, count
    expression)] of ClusterSmem's constructor in the .cu, in order."""
    body = CU[CU.index("struct ClusterSmem"):]
    body = body[body.index("size_t at = 0;") + 14:body.index("bytes = at;")]
    out = []
    for stmt in body.split(";"):
        stmt = " ".join(stmt.split())
        if not stmt:
            continue
        m = re.fullmatch(r"(\w+) = (.*)", stmt)
        name, rhs = m.group(1), m.group(2)
        t = re.search(r"take<([\w ]+)>\(base, at, (.*)\)", rhs)
        fwd = not rhs.startswith("BWD ? take")
        bwd = not rhs.startswith("BWD ? nullptr")
        out.append((name, fwd, bwd, t.group(1), t.group(2)))
    return out


def test_smem_words_follow_the_cluster_layout():
    """``_cluster_bytes`` is ClusterSmem's carve in the .cu, read from its
    source: each array's element type and count in order (the constants
    read from the source too), at the shapes the phases run."""
    consts = {}
    for name, value in (("CMAX", bsc._CMAX), ("HMAX", bsc._HMAX),
                        ("CPOST", bsc._CPOST), ("CRING", bsc._CRING),
                        ("PRING", bsc._PRING),
                        ("WDEPTH", bsc._WDEPTH), ("WT", bsc._WT)):
        assert re.search(rf"constexpr int {name} = {value};", CU), name
        consts[name] = value
    carve = _carve()
    assert [c[0] for c in carve][:2] == ["RG", "Y"]
    assert [c[0] for c in carve][-2:] == ["EI", "LST"]
    size = {"double": 8, "unsigned long long": 8, "int": 4, "unsigned": 4,
            "unsigned short": 2}
    for Sp, nO, tw, P1, C in ((3008, 3, 1, 385, 1), (3008, 3, 2, 385, 2),
                              (24576, 3, 1, 385, 4), (24576, 3, 1, 385, 8),
                              (1288, 8, 1, 25, 1), (40000, 3, 1, 385, 7)):
        L = bsc._range_len(Sp, C)
        env = dict(consts, L=L, nO=nO, E=min(L, P1) + 1,
                   YS=L + 2 * consts["HMAX"], D=consts["WDEPTH"],
                   WW=WT // 32)
        for bwd in (False, True):
            total = sum(
                (4 * tw if typ == "T" else size[typ]) * eval(  # noqa: S307
                    count.replace("static_cast<size_t>", ""), {}, env)
                for _, f, b, typ, count in carve if (b if bwd else f))
            assert total == bsc._cluster_bytes(Sp, nO, C, tw, P1, bwd), (
                Sp, C, bwd)
            assert bsc._mode_words(Sp, nO, "cluster", tw, C, P1)[bwd] == \
                -(-total // 4)


def _ranks(x, Sp, C):
    """(Sp, G) -> [(J, WT, G)] per CTA of C: thread i's states lo + i +
    WT j of the range along j, zero past its end."""
    out = []
    for lo, hi in cluster_ranges(Sp, C):
        J = -(-(hi - lo) // WT)
        pad = x.new_zeros((J * WT, x.shape[1]))
        pad[:hi - lo] = x[lo:hi]
        out.append(pad.reshape(J, WT, -1))
    return out


def cluster_sum(x, Sp, C):
    """A frame's sum over the states as the cluster kernels form it: per
    CTA each thread's partial in order, the butterfly, the warps in order
    (``_lanes_then_warps``); then the CTAs' sums in rank order."""
    out = None
    for th in _ranks(x, Sp, C):
        part = th[0].clone()
        for j in range(1, th.shape[0]):
            part = part + th[j]
        s = _lanes_then_warps(part)
        out = s if out is None else out + s
    return out


def emulate_k5a_cluster(kop, ext, mshift, C):
    """K5a's cluster forward in float64 at C CTAs a graph: as
    ``emulate_k5a_wide`` but the omega dot by ``cluster_sum`` (the key is
    the max of the CTAs' maxima: any order).  Returns (alphas, vfin,
    shift, ksum)."""
    Nf, _, G = ext.shape
    Sp = kop.Sp
    fin = kop.fin.long()
    cols = torch.arange(G)
    om = kop.om.double()
    alphas = torch.empty((Nf, Sp, G), dtype=torch.float64)
    ksum = torch.zeros(G, dtype=torch.float64)
    shift = torch.zeros(G, dtype=torch.float64)
    a = None
    for t in range(Nf):
        e = bsc._emission(kop, ext[t]).double()
        notfin = torch.ones((Sp, G), dtype=torch.bool)
        vf = None
        if t == 0:
            y = kop.a0.double() * e
        else:
            dot = cluster_sum(om * a, Sp, C)
            y = torch.zeros((Sp, G), dtype=torch.float64)
            for o, off in enumerate(kop.offsets):
                y = y + kop.bf[o].double() * bsc._shift_rows(a, off)
            y = y * e
            vf = dot * e[fin, cols]
            notfin[fin, cols] = False
        key = torch.zeros(G, dtype=torch.int64)
        for lo, hi in cluster_ranges(Sp, C):  # each CTA's max
            key = torch.maximum(key, torch.where(
                notfin[lo:hi], _exp_key(y[lo:hi]), 0).amax(dim=0))
        if vf is not None:
            key = torch.maximum(key, _exp_key(vf))
            y[fin, cols] = vf
        k = torch.where(key > 0, key - 1023, 0).double()
        a = y * torch.ldexp(torch.ones(G, dtype=torch.float64), -k)
        alphas[t] = a
        ksum = ksum + k
        shift = shift + mshift[t, 0].double()
    return alphas, a[fin, cols], shift, ksum


def _entry_sums(vals, runs):
    """Sums over runs of the rows of vals (each run a 1-D index array, in
    order; the sums vectorised over vals' other axis) as ``entry_sums``
    forms them: from the first where a run has up to 32 entries, else by
    a warp (lane l over l, l + 32, ... from 0, then the butterfly)."""
    out = []
    for idx in runs:
        if len(idx) <= bsc._LONG:
            acc = vals[idx[0]]
            for i in idx[1:]:
                acc = acc + vals[i]
        else:
            lanes = vals.new_zeros((32,) + vals.shape[1:])
            for k in range(0, len(idx), 32):
                chunk = torch.as_tensor(idx[k:k + 32])
                lanes[:len(chunk)] = lanes[:len(chunk)] + vals[chunk]
            acc = _butterfly(lanes[..., None])[..., 0] if lanes.dim() == 1 \
                else _butterfly(lanes)
        out.append(acc)
    return out


def emulate_k5b_cluster(kop, ext, alphas, C):
    """K5b's cluster posteriors in float64 at C CTAs a graph: the frame's
    gamma sum by ``cluster_sum``; each CTA's sum of each pdf's states in
    its range (its local plan, ``_entry_sums``), the CTAs' sums added in
    rank order, times the reciprocal of the gamma sum (divided by it
    where it is subnormal, left as it is where it is 0).  Vectorised over
    the frames."""
    Nf, P1, G = ext.shape
    Sp = kop.Sp
    plan = kop.plan.numpy()
    ranges = cluster_ranges(Sp, C)
    gam = torch.empty((Nf, Sp, G), dtype=torch.float64)
    for t, gt in bsc.gammas_plain(kop, ext, alphas):
        gam[t] = gt
    tot = cluster_sum(gam.permute(1, 0, 2).reshape(Sp, Nf * G), Sp,
                      C).reshape(Nf, G)
    rt = torch.where(tot > 0, 1.0 / tot, torch.ones_like(tot))
    small = (tot > 0) & (tot < 2.0 ** -1022)
    posts = torch.zeros((Nf, P1, G), dtype=torch.float64)
    for g in range(G):
        vals = gam[:, :, g].T  # (Sp, Nf)
        acc = {}
        for lo, hi in ranges:
            ep, lge, lseg, lst, _ = local_plan(plan[g], Sp, lo, hi)
            runs = [np.asarray(lst[lseg[k]:lseg[k + 1]]) + lo
                    for k in range(len(ep))]
            for e, v in zip(lge, _entry_sums(vals, runs)):
                acc[e] = v if e not in acc else acc[e] + v
        for e, v in acc.items():
            posts[:, int(plan[g][1 + e]), g] = torch.where(
                small[:, g], v / tot[:, g], v * rt[:, g])
    return posts


@pytest.fixture(scope="module")
def stack3008():
    """A float64 stack at Sp = 3,008 (two ~3,000-state skip-arc lattices
    beside two short ones) at N = 2,400 with ragged lengths and cliffs:
    its twin's sweep and K5b in float64."""
    cf = mt.stack([compile_port(f, sp, P, strategy="banded",
                                dtype=torch.float64)
                   for f, sp in skip_numerators(P, (3000, 2950, 300, 150),
                                                13, mt)])
    kop = bsc.kernel_operator(cf)
    assert kop.Sp == 3008 and kop.offsets == (0, 1, 2)
    rng = np.random.default_rng(14)
    N = 2400
    lhs = rng.normal(size=(4, N, P)) * 0.5
    lhs[:, 0:2, ::3] += 30.0
    lhs[:, N // 2, 1::3] -= 30.0
    lens = np.array([N, N - 20, 700, N - 50], dtype=np.int32)
    ext, msh = prepare_emissions(torch.from_numpy(lhs),
                                 torch.from_numpy(lens), P, torch.float64)
    twin = bsc.fwd_sweep_plain(kop, ext, msh)
    return kop, ext, msh, twin, bsc.backward_plain(kop, ext, twin[0],
                                                   dtype=torch.float64)


@pytest.mark.parametrize("C", [1, 3])
def test_emulated_cluster_k5a_matches_the_twin(stack3008, C):
    """The cluster K5a's fixed-order omega dot in rank order and its key
    give the twin's alphas and logZ pieces within 1e-12 (exponents
    exactly); with one CTA its order is the wide and global kernels'."""
    kop, ext, msh, (ap, vp, sp, kp), _ = stack3008
    assert bsc._modes(*bsc._kop_dims(kop)) == ("cluster", "cluster")
    ae, ve, se, ke = emulate_k5a_cluster(kop, ext, msh, C)
    assert torch.equal(ke, kp) and torch.equal(se, sp)
    assert float((ae - ap).abs().max()) <= 1e-12
    assert float(((ve - vp).abs() / vp.abs().clamp_min(1e-300)).max()) \
        <= 1e-12
    assert (vp[:2] > 0).all()
    if C == 1:
        wide = emulate_k5a_wide(kop, ext, msh)
        assert all(torch.equal(x, y) for x, y in zip(wide, (ae, ve, se, ke)))


@pytest.mark.parametrize("C", [1, 3])
def test_emulated_cluster_k5b_matches_the_twin(stack3008, C):
    """The cluster K5b's gamma sum in rank order and its pdf sums (each
    CTA's in its local order, then the CTAs' in rank order) give the
    twin's float64 posteriors within 1e-12; with one CTA they are the
    wide and global kernels' sums."""
    kop, ext, _, twin, ref = stack3008
    al = twin[0][-400:]  # the sweep's last 400 frames, from beta = 1
    sub = ext[-400:]
    ref = bsc.backward_plain(kop, sub, al, dtype=torch.float64)
    emu = emulate_k5b_cluster(kop, sub, al, C)
    assert float((emu - ref).abs().max()) <= 1e-12
    assert (ref.sum(dim=1)[:, :2] > 0.5).all()
    if C == 1:
        assert torch.equal(emu, emulate_k5b_wide(kop, sub, al))
