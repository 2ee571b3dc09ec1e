"""The card's plain routes: the 'block' graphs that the fused kernels
refuse, and general-Ĉ graphs, take the plain probability-domain scan and
the plain decode twins on a CUDA device, the counterparts of the JAX
package's XLA routes (``markovmodels_tpu/inference.py`` ``_fb_single``,
``ops/blocked.py`` and the XLA sweep of ``viterbi.py``).

Decided without a card (the rules read the graph, the batch and the
device's type; the kernels' admissions read a card only where there is
one):

* ``inference._plain_on_card`` names the first predicate that K2-K4
  refuse, the JAX package's ``block_scan_reject_reason`` in its words, for
  the one-hot reduction of ``reorder='none'`` (V=16), two tiers (V=32) and
  the generic gather/scatter (V=64); ``fast_path_report`` names the route
  and that predicate; the CPU keeps its plain path;
* the dispatcher's route, run here by deciding as for a CUDA tensor: the
  same values as the CPU's plain scan, one warning on the
  ``markovmodels_tpu_torch`` logger per graph and predicate, and none for
  a general-Ĉ 'dense' graph (the JAX package warns for 'block' graphs);
* the decode's rule (``viterbi._plain_decode``) the same way: K7's or
  K7n's refused predicate, the plain twins' paths and scores equal to the
  CPU's, one warning;
* a graph that the JAX package's fused kernels admit and only the port's
  own predicates refuse keeps the kernel route, whose admission raises.

The kernels of the admitted graphs are held to the twins on the card by
``chip_smoke.py``; phase 50 runs these routes there against the float64
oracle."""
import dataclasses
import importlib
import logging
import re
import types

import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu.ops import pallas_block as pb
from markovmodels_tpu_torch import inference as tinf
from markovmodels_tpu_torch.ops import block_scan as bs
from markovmodels_tpu_torch.ops import vit_scan as vs
from _torch_port import (compile_port, inputs, jax_compiled, port_from_jax,
                         port_lm_graph)

tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

LAYOUTS = [(16, "none"), (32, "auto"), (64, "auto")]
B, N = 4, 6
LOGGER = "markovmodels_tpu_torch"


@pytest.fixture(scope="module")
def graphs():
    return {}


def _pair(graphs, V, reorder):
    """(JAX compile, port compile) of the V-word graph as 'block'."""
    if (V, reorder) not in graphs:
        cj = jax_compiled(V, reorder)
        graphs[V, reorder] = (cj, port_from_jax(cj))
    return graphs[V, reorder]


def _as_on_card(monkeypatch):
    """Make the dispatcher and the decode decide as for a CUDA tensor
    while they run on the CPU (the plain routes they then take are the
    ones the card runs)."""
    scan_rule, decode_rule = tinf._plain_on_card, tvit._plain_decode
    monkeypatch.setattr(tinf, "_plain_on_card",
                        lambda cf, dev, b, n=None: scan_rule(cf, "cuda", b, n))
    monkeypatch.setattr(tvit, "_plain_decode", lambda cf, lhs, saved=None:
                        decode_rule(cf, types.SimpleNamespace(
                            shape=lhs.shape, device=torch.device("cuda")),
                            saved))


@pytest.mark.parametrize("V, reorder", LAYOUTS)
def test_plain_on_card_names_the_first_refused_predicate(graphs, V,
                                                         reorder):
    cj, ct = _pair(graphs, V, reorder)
    reason = tinf._plain_on_card(ct, "cuda", B)
    assert reason is not None
    assert reason == bs.block_scan_reject_reason(ct, B)
    assert reason == pb.block_scan_reject_reason(cj, B)  # JAX's words
    assert tinf._plain_on_card(ct, "cpu", B) is None
    assert tinf._plain_everywhere(ct) is None
    report = tinf.fast_path_report(ct, B, device="cuda")
    assert report == tinf._plain_on_card_line(ct, reason)
    assert report.startswith("plain torch scan on the card (one 'block' "
                             "graph") and report.endswith(reason)
    assert "CPU tensors take the plain path" in tinf.fast_path_report(
        ct, B, device="cpu")
    # the kernels' own rule still refuses it when asked
    with pytest.raises(ValueError, match="rejects this graph"):
        tinf._kernel_route(ct, "cuda", B)


@pytest.mark.parametrize("V, reorder", LAYOUTS)
def test_card_scan_route_matches_the_cpu_and_warns_once(graphs, V, reorder,
                                                        monkeypatch, caplog):
    _, ct = _pair(graphs, V, reorder)
    fsm, spdf, P, _ = port_lm_graph(V)
    lhs, lens = inputs(B, N, P, seed=V, lens=[N, 1, 4, N])
    lhs, lens = torch.from_numpy(lhs), torch.from_numpy(lens)
    want = mt.pdfposteriors(ct, lhs, lens)
    z_want = mt.forward(ct, lhs, lens)
    _as_on_card(monkeypatch)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = mt.pdfposteriors(ct, lhs, lens)
        z_got = mt.forward(ct, lhs, lens)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(z_got, z_want)
    reason = bs.block_scan_reject_reason(ct, B)
    assert [r.getMessage() for r in caplog.records] == [
        f"block-strategy graph fell off the fused fast path: {reason}"]


@pytest.mark.parametrize("V, reorder", LAYOUTS)
def test_card_decode_route_matches_the_cpu_and_warns_once(graphs, V,
                                                          reorder,
                                                          monkeypatch,
                                                          caplog):
    _, ct = _pair(graphs, V, reorder)
    fsm, spdf, P, _ = port_lm_graph(V)
    lhs, lens = inputs(B, N, P, seed=V + 1, lens=[N, 2, 5, N])
    lhs, lens = torch.from_numpy(lhs), torch.from_numpy(lens)
    want = mt.viterbi(ct, lhs, lens)
    _as_on_card(monkeypatch)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = mt.viterbi(ct, lhs, lens)
        again = mt.viterbi(ct, lhs, lens)
    for a, b in ((got, want), (again, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the route's kernel: K7 where the compressed-backpointer decode
    # applies, else K7n with the states the recompute decode keeps
    bp = tvit._bp_vit_reject_reason(ct, lhs) is None
    K = tvit._chunk_frames(ct, lhs, None)
    saved = None if bp else max(K, (N + 1) // K)
    kernel = vs.vit_scan_reject_reason(ct, B, n_frames=N, saved=saved)
    assert kernel is not None
    msgs = [r.getMessage() for r in caplog.records
            if "fell off" in r.getMessage()]
    assert len(msgs) == 1 and msgs[0].endswith(kernel)
    assert msgs[0].startswith("block-strategy Viterbi fell off the sweep "
                              "kernels: the ")
    assert ("(K7)" if bp else "(K7n)") in msgs[0]


def test_general_c_hat_dense_takes_the_plain_route_without_a_warning(
        monkeypatch, caplog):
    """A general-Ĉ 'dense' graph: K6a/K6b's admission names the predicate,
    the route is the plain one, and, as in the JAX package (which warns
    for 'block' graphs only), nothing is logged."""
    fsm, spdf, P, _ = port_lm_graph(8)
    S1 = len(spdf)
    rows = np.r_[np.arange(S1), 1]
    cols = np.r_[spdf, (spdf[1] + 1) % P]
    C = mt.hostsparse.spmat_from_coo(rows, cols, np.zeros(len(rows)),
                                     (S1, P + 1), mt.LOG)
    ct = compile_port(fsm, C, P, strategy="dense")
    assert ct.multi_pdf
    assert tinf._plain_on_card(ct, "cuda", B) == "general multi-pdf C-hat"
    lhs, lens = inputs(B, N, P, seed=3, lens=[N, 3, 1, N])
    lhs, lens = torch.from_numpy(lhs), torch.from_numpy(lens)
    want = mt.pdfposteriors(ct, lhs, lens)
    _as_on_card(monkeypatch)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = mt.pdfposteriors(ct, lhs, lens)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not caplog.records


@pytest.fixture(scope="module")
def admitted():
    """The V=128 'block' graph, which both packages' fused kernels take."""
    cj = jax_compiled(128)
    return cj, port_from_jax(cj)


@pytest.mark.parametrize("predicate", ["limits", "bf16 tile"])
def test_a_port_only_refusal_raises_on_the_card(admitted, predicate):
    """A graph that the JAX package's fused scan admits, refused by one of
    the port's own predicates (the kernels' limits of ``_kernel_checks``,
    the bf16 tier tile), keeps the kernel route on the card, whose
    admission then raises: it does not take the plain route."""
    cj, ct = admitted
    assert pb.block_scan_reject_reason(cj, B) is None
    assert pb.vit_scan_supported(cj, B)
    assert bs.block_scan_admission(ct, B) == (None, True)
    if predicate == "limits":
        bad = dataclasses.replace(ct, _cache={})
        plan = bs._full_plan_explain(bad)[0]
        reason = "forward operator: tier writes a state row twice"
        bad._cache[("kernel_checks", plan[0], plan[1])] = reason
    else:
        # the JAX package's admission reads no precision
        assert pb.block_scan_reject_reason(
            dataclasses.replace(cj, precision="bf16"), B) is None
        bad = dataclasses.replace(ct, precision="bf16", _cache={})
        kop = bs.kernel_operator(bad)
        bad._cache[("block_scan", torch.bfloat16)] = kop._replace(
            bwd=kop.bwd._replace(W=kop.bwd.W[:, :120]))
        reason = ("backward operator: bf16 tier depth Sm = 120 not a "
                  "multiple of the tensor-core step 16")
    assert bs.block_scan_admission(bad, B) == (reason, False)
    assert tinf._plain_on_card(bad, "cuda", B, N) is None
    with pytest.raises(ValueError, match=re.escape(reason)):
        tinf._kernel_route(bad, "cuda", B, N)
    assert tinf.fast_path_report(bad, B, device="cuda") == (
        f"error - the CUDA blocked scan rejects this graph: {reason}")
    card = types.SimpleNamespace(shape=(B, N, ct.num_pdfs),
                                 device=torch.device("cuda"))
    for saved in (None, 4):
        want = (reason, False) if predicate == "limits" else (None, True)
        assert vs.vit_scan_admission(bad, B, n_frames=N, saved=saved) == want
        assert tvit._plain_decode(bad, card, saved=saved) is None
        if predicate == "limits":
            with pytest.raises(ValueError, match=re.escape(reason)):
                vs._check_graph(bad, B, N, "cuda", saved=saved)
