"""The port's LF-MMI training step: ``logmarginal`` (a torch.autograd
Function whose gradient is the posterior matrix) and ``lfmmi_loss``
(stacked banded numerators against the V=128 block denominator), against
the JAX package's ``jax.value_and_grad(lfmmi_loss)`` and against the
posteriors themselves.  Inputs are made from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import markovmodels_tpu_torch as mt
from markovmodels_tpu import inference as inf
from _torch_port import (compile_port, inputs, jax_compiled, numerators,
                         port_lm_graph)

B, N = 4, 8
LENS = [8, 7, 8, 5]
NUM_LENGTHS = [5, 3, 6, 4]  # lattice states; all feasible within LENS


@pytest.fixture(scope="module")
def graphs():
    fsm, spdf, P, _ = port_lm_graph(128)
    nums = numerators(np.random.default_rng(13), B, P, NUM_LENGTHS)
    nums_t = numerators(np.random.default_rng(13), B, P, NUM_LENGTHS, lib=mt)
    num_j = inf.stack([inf.compile_fsm(f, sp, P, strategy="banded")
                       for f, sp in nums])
    num_t = mt.stack([compile_port(f, sp, P, strategy="banded")
                      for f, sp in nums_t])
    den_t = compile_port(fsm, spdf, P, strategy="block")
    return (num_j, jax_compiled(128)), (num_t, den_t), P


@pytest.fixture(scope="module")
def data(graphs):
    return inputs(B, N, graphs[2], seed=17, lens=LENS)


def _step(num, den, lhs, lens):
    x = torch.from_numpy(lhs).requires_grad_()
    loss = mt.lfmmi_loss(num, den, x, torch.from_numpy(lens))
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.fixture(scope="module")
def port_step(graphs, data):
    return _step(*graphs[1], *data)


def test_lfmmi_loss_and_gradient_match_jax(graphs, data, port_step):
    (num_j, den_j), _, _ = graphs
    lhs, lens = data
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MMTPU_PALLAS_INTERPRET", "MMTPU_NO_PALLAS"):
            mp.delenv(k, raising=False)
        mp.setenv("MMTPU_NO_PALLAS", "1")
        loss_j, grad_j = jax.value_and_grad(
            lambda x: inf.lfmmi_loss(num_j, den_j, x,
                                     jnp.asarray(lens)).sum()
        )(jnp.asarray(lhs))
    loss_t, grad_t = port_step
    assert np.isfinite(loss_t).all()
    np.testing.assert_allclose(loss_t.sum(), float(loss_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(grad_t, np.asarray(grad_j), atol=1e-5, rtol=0)


def test_gradient_is_den_minus_num_posteriors(graphs, data, port_step):
    (num, den), lhs, lens = graphs[1], *data
    x, L = torch.from_numpy(lhs), torch.from_numpy(lens)
    pn, _ = mt.pdfposteriors(num, x, L)
    pd, _ = mt.pdfposteriors(den, x, L)
    grad = port_step[1]
    np.testing.assert_allclose(grad, (pd - pn).numpy(), atol=1e-6, rtol=0)
    # both posteriors sum to 1 on active frames: the gradient sums to 0
    for b, n in enumerate(lens):
        np.testing.assert_allclose(grad[b, :n].sum(axis=1), 0.0, atol=1e-5)
        assert (grad[b, n:] == 0).all()


@pytest.mark.parametrize("which", ["num", "den"])
def test_logmarginal_gradient_is_the_posteriors(graphs, data, which):
    num, den = graphs[1]
    cf = num if which == "num" else den
    lhs, lens = data
    L = torch.from_numpy(lens)
    x = torch.from_numpy(lhs).requires_grad_()
    z = mt.logmarginal(cf, x, L)
    z.sum().backward()
    posts, z_ref = mt.pdfposteriors(cf, torch.from_numpy(lhs), L)
    assert torch.equal(z.detach(), z_ref)
    np.testing.assert_allclose(x.grad.numpy(), posts.numpy(), atol=1e-6,
                               rtol=0)
    # finite differences of logZ on three coordinates
    f = lambda y: float(mt.forward(cf, torch.from_numpy(y), L)[0])
    eps = 1e-3
    for t, p in [(0, 0), (3, 5), (lens[0] - 1, 17)]:
        lp, lm = lhs.copy(), lhs.copy()
        lp[0, t, p] += eps
        lm[0, t, p] -= eps
        fd = (f(lp) - f(lm)) / (2 * eps)
        np.testing.assert_allclose(float(x.grad[0, t, p]), fd, atol=5e-3)


def test_logmarginal_scales_the_gradient_per_sequence(graphs, data):
    """The backward multiplies each sequence's posteriors by its own
    incoming gradient; the graph and the lengths get none."""
    num, _ = graphs[1]
    lhs, lens = data
    x = torch.from_numpy(lhs).requires_grad_()
    w = torch.tensor([1.0, -2.0, 0.5, 0.0])
    (mt.logmarginal(num, x, torch.from_numpy(lens)) * w).sum().backward()
    posts, _ = mt.pdfposteriors(num, torch.from_numpy(lhs),
                                torch.from_numpy(lens))
    np.testing.assert_allclose(x.grad.numpy(),
                               (w[:, None, None] * posts).numpy(),
                               atol=1e-6, rtol=0)
    assert not num.alpha_hat.requires_grad
