"""Shared checks of ``tests/test_torch_lm.py`` and ``tests/test_torch_lm_moe.py``:
one SMOKE LM config run through the JAX package and the port from the same
parameters (JAX's ``init_lm`` draw, carried across by ``convert``) and the
same numpy tokens.

Tolerances (fp32 SMOKE widths; both sides sum matmuls and reductions in
other orders, and the online softmax rescales in another order):
* hidden states, logits, caches: rtol 1e-4 / atol 1e-5;
* loss and aux loss: rtol 1e-5;
* gradients: each leaf within 1e-4 x (max |JAX grad of that leaf|) + 1e-7;
* one train step: loss and grad norm rtol 1e-5; new params within 1e-5
  where |g| > 1e-3 x max|g| of the leaf, and within 2 x lr elsewhere: Adam's
  first step is lr x g / (|g| + eps), so a gradient at rounding level moves
  its parameter by up to lr on either side;
* decode against the train forward at the same position: rtol 2e-3 / atol
  2e-3 (``tests/test_models_smoke.py``'s bound for the JAX pair).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import named_leaves as jnamed
from repro.models import lm as jlm
from repro.optim import adam as jadam

from repro_torch.common.pytree import named_leaves, tree_map
from repro_torch.convert import adam_state_from_numpy, lm_params_from_numpy
from repro_torch.models import lm
from repro_torch.optim.adam import adam_init

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Runs a module's tests on one intra-op thread: at SMOKE widths the
    port's ops are small, and beside the suite's other workers a thread
    pool a worker oversubscribes the cores (a bf16 forward of 28 layers took
    60x its time alone).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.as_tensor(np.array(x))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def port_cfg(jcfg):
    return lm.LMConfig.from_dict(jcfg.to_dict())


def setup(jcfg, seed=0, B=2, T_=32):
    cfg = port_cfg(jcfg)
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    params = lm_params_from_numpy(to_np(jparams), cfg, device="cpu")
    toks = np.random.default_rng(seed + 1).integers(0, jcfg.vocab, (B, T_)).astype(np.int32)
    return cfg, jparams, params, toks


def check_forward_loss_grads(jcfg):
    cfg, jparams, params, toks = setup(jcfg)
    labels = np.roll(toks, -1, axis=1)
    jh, jaux = jax.jit(functools.partial(jlm.forward_train, cfg=jcfg))(jparams,
                                                                        jnp.asarray(toks))
    h, aux = lm.forward_train(params, T(toks).long(), cfg)
    close(h, jh, msg="hidden")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    jl = jlm.lm_loss(jparams, jh, jnp.asarray(labels), jcfg)
    np.testing.assert_allclose(float(lm.lm_loss(params, h, T(labels).long(), cfg)), float(jl),
                               rtol=1e-5)

    def jloss(p):
        hh, a = jlm.forward_train(p, jnp.asarray(toks), jcfg)
        return jlm.lm_loss(p, hh, jnp.asarray(labels), jcfg) + jcfg.aux_loss_coef * a

    jg = jax.jit(jax.grad(jloss))(jparams)
    leaves = {n: t.detach().requires_grad_(True) for n, t in named_leaves(params)}
    it = iter(leaves.values())
    tp = tree_map(lambda _: next(it), params)
    hh, a = lm.forward_train(tp, T(toks).long(), cfg)
    tot = lm.lm_loss(tp, hh, T(labels).long(), cfg) + cfg.aux_loss_coef * a
    grads = torch.autograd.grad(tot, list(leaves.values()))
    want = jnamed(jg)
    assert [n for n, _ in want] == list(leaves)
    for (n, w), g in zip(want, grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=n)


def check_train_step(jcfg):
    cfg, jparams, params, toks = setup(jcfg, seed=2)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jopt = jadam.adam_init(jparams)
    jp2, jo2, jm = jax.jit(jlm.make_train_step(jcfg))(
        jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = adam_state_from_numpy(to_np(jopt), device="cpu")
    for a, b in zip(named_leaves(opt), named_leaves(adam_init(params))):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    p2, o2, m = lm.make_train_step(cfg, optimizer=object())(
        params, opt, {k: T(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert np.float32(m["lr"]) == np.asarray(jm["lr"]) and int(o2.step) == int(jo2.step) == 1
    mu = dict(named_leaves(o2.mu))
    for (n, got), (_, want), (_, jmu) in zip(named_leaves(p2), jnamed(jp2), jnamed(jo2.mu)):
        want, jmu = np.asarray(want), np.asarray(jmu)
        big = np.abs(jmu) > 1e-3 * np.abs(jmu).max()
        np.testing.assert_allclose(got.numpy()[big], want[big], rtol=0, atol=1e-5, err_msg=n)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3, err_msg=n)
        np.testing.assert_allclose(mu[n].numpy(), jmu, rtol=0,
                                   atol=1e-4 * np.abs(jmu).max() + 1e-9, err_msg=n)


def check_prefill_decode(jcfg, steps=3):
    cfg, jparams, params, toks = setup(jcfg, seed=3, T_=16)
    cache_len = 16 + steps + 2
    jlogits, jcaches = jlm.prefill(jparams, jnp.asarray(toks), jcfg, cache_len)
    logits, caches = lm.prefill(params, T(toks).long(), cfg, cache_len)
    close(logits, jlogits, msg="prefill logits")
    for (n, a), (_, b) in zip(named_leaves(caches), jnamed(jcaches)):
        close(a, b, msg=n)
    jstep, step = jlm.make_decode_step(jcfg), lm.make_decode_step(cfg)
    tok = toks[:, -1:]
    for s in range(steps):
        kv_len = 17 + s
        jnxt, jlg, jcaches = jstep(jparams, jnp.asarray(tok), jcaches, kv_len)
        nxt, lg, caches2 = step(params, T(tok).long(), caches, kv_len)
        assert caches2 is caches
        close(lg, jlg, msg=f"decode step {s}")
        assert np.array_equal(nxt.numpy(), np.asarray(jnxt)) and nxt.dtype == torch.int32
        tok = np.asarray(jnxt)
    for (n, a), (_, b) in zip(named_leaves(caches), jnamed(jcaches)):
        close(a, b, msg=n)
    zeros = lm.init_cache(cfg, 2, cache_len, device="cpu")
    jzeros = jlm.init_cache(jcfg, 2, cache_len)
    assert [(n, tuple(t.shape), t.dtype) for n, t in named_leaves(zeros)] == [
        (n, tuple(np.shape(t)), torch.float32) for n, t in jnamed(jzeros)]


def check_decode_matches_train(jcfg):
    """The port's decode logits equal its own train forward's at the same
    position (the twin of ``test_lm_decode_matches_train_dense``)."""
    cfg, _, params, toks = setup(jcfg, seed=4, T_=24)
    h, _ = lm.forward_train(params, T(toks).long(), cfg)
    ref = lm._readout(params, h[:, -1], cfg)
    _, caches = lm.make_prefill_step(cfg, 32)(params, T(toks[:, :-1]).long())
    _, lg, _ = lm.make_decode_step(cfg)(params, T(toks[:, -1:]).long(), caches, 24)
    close(lg, ref.detach(), rtol=2e-3, atol=2e-3)


def check_init_lm(jcfg):
    """init_lm gives JAX's tree: names, shapes, dtypes; each leaf's std within
    4 / sqrt(n) of JAX's, relative (four standard errors of the difference of
    two independent draws of n values; only the law can agree:
    torch.Generator against Threefry)."""
    cfg = port_cfg(jcfg)
    port = named_leaves(lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu"))
    ref = jnamed(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (n, a), (_, b) in zip(port, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.dtype == cfg.pdtype, n
        if b.std() == 0:
            assert np.array_equal(a.numpy(), b), n
        else:
            bound = 4 / np.sqrt(b.size)
            assert abs(float(a.std()) / float(b.std()) - 1) < bound, (n, float(a.std()), b.std())
    two = named_leaves(lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(port, two))
    stacked = [a for n, a in port if n.startswith("stack_") and n.endswith("kernel")
               or n.endswith("/wq")]
    assert all(not torch.equal(t[0], t[-1]) for t in stacked if t.shape[0] > 1)
