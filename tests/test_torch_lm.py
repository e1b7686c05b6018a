"""The port's dense LMs (gemma-7b, qwen2.5-32b, granite-20b) held against the
JAX package at their SMOKE widths, plus what all five configs share:
``param_count`` / ``active_param_count`` at full width, the configs value for
value, ``init_lm``'s tree, and ``convert``'s round trip.  Tolerances are
those of ``tests/_torch_lm_parity.py``.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from _torch_lm_parity import one_torch_thread  # noqa: F401 (a fixture)
from _torch_lm_parity import (check_decode_matches_train, check_forward_loss_grads,
                              check_init_lm, check_prefill_decode, check_train_step, to_np)
from repro.common.pytree import named_leaves as jnamed
from repro.models import lm as jlm

from repro_torch.common.pytree import named_leaves
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import lm

DENSE = ["gemma_7b", "qwen2_5_32b", "granite_20b"]
ALL = DENSE + ["llama4_maverick_400b", "deepseek_v3_671b"]


def jax_cfg(name):
    return importlib.import_module(f"repro.configs.{name}")


def port_cfg_module(name):
    return importlib.import_module(f"repro_torch.configs.{name}")


@pytest.mark.parametrize("name", DENSE)
def test_forward_loss_and_grads_match_jax(name):
    check_forward_loss_grads(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("name", DENSE)
def test_train_step_matches_jax(name):
    check_train_step(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_jax(name):
    check_prefill_decode(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_train(name):
    check_decode_matches_train(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("name", ALL)
def test_configs_match_jax_value_for_value(name):
    j, p = jax_cfg(name), port_cfg_module(name)
    assert p.FAMILY == j.FAMILY == "lm"
    assert p.SHAPES == j.SHAPES
    assert getattr(p, "USE_ADAM8", None) == getattr(j, "USE_ADAM8", None)
    for which in ("CONFIG", "SMOKE"):
        assert getattr(p, which).to_dict() == getattr(j, which).to_dict()
    assert [f.name for f in dataclasses.fields(lm.LMConfig)] == [
        f.name for f in dataclasses.fields(jlm.LMConfig)]
    assert p.CONFIG.pdtype == torch.bfloat16 and p.SMOKE.cdtype == torch.float32


@pytest.mark.parametrize("name", ALL)
def test_param_counts_equal_jax(name):
    j, p = jax_cfg(name), port_cfg_module(name)
    assert lm.param_count(p.CONFIG) == jlm.param_count(j.CONFIG)
    assert lm.active_param_count(p.CONFIG) == jlm.active_param_count(j.CONFIG)
    assert lm.layer_stacks(p.CONFIG) == [
        (n, tuple(lm.LayerSpec(s.is_moe, s.chunk) for s in blk))
        for n, blk in jlm.layer_stacks(j.CONFIG)]
    assert lm.param_count(p.SMOKE) == sum(t.numel() for _, t in named_leaves(
        lm.init_lm(torch.Generator().manual_seed(0), p.SMOKE, device="cpu"))
        if not _is_norm_or_bias(_))


def _is_norm_or_bias(name):
    """Leaves param_count leaves out (norm scales and biases, as JAX's)."""
    return any(s in name for s in ("ln1", "ln2", "final_norm", "q_norm", "kv_norm", "/bias",
                                   "/bq", "/bk", "/bv"))


@pytest.mark.parametrize("name", ["gemma_7b", "granite_20b", "deepseek_v3_671b"])
def test_init_lm_matches_jax_tree(name):
    check_init_lm(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(dtype):
    """JAX params -> port -> numpy: JAX's named_leaves, name for name, the
    arrays bit for bit (bf16 through fp32, which holds every bf16 value)."""
    jcfg = jax_cfg("deepseek_v3_671b").SMOKE.replace(param_dtype=dtype)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(to_np(jparams), lm.LMConfig.from_dict(jcfg.to_dict()),
                                  device="cpu")
    back = lm_params_to_numpy(params)
    want = jnamed(jparams)
    assert list(back) == [n for n, _ in want]
    for n, w in want:
        w = np.asarray(w)
        assert back[n].shape == w.shape
        assert np.array_equal(back[n], w.astype(np.float32)), n
        if dtype == "bfloat16":
            assert np.array_equal(params_leaf(params, n).view(torch.int16).numpy(),
                                  w.view(np.int16)), n
    flat = lm_params_from_numpy(dict(jnamed(to_np(jparams))), lm.LMConfig.from_dict(
        jcfg.to_dict()), device="cpu")
    assert [n for n, _ in named_leaves(flat)] == list(back)
    with pytest.raises(ValueError, match="dtype"):
        lm_params_from_numpy(to_np(jparams), lm.LMConfig.from_dict(
            jcfg.replace(param_dtype="float16").to_dict()), device="cpu")


def params_leaf(params, name):
    return dict(named_leaves(params))[name]


def test_mesh_is_refused_until_the_sharding_rules(tmp_path):
    """The mesh forms came with the sharding rules: on a one-rank (1, 1)
    gloo mesh (no collective moves anything) the mesh form of
    ``forward_train`` equals the single-device form, and the ``ep`` MoE
    refuses experts its mesh does not divide, as JAX's does (on the layout
    of rank 0 of a (4, 2) mesh)."""
    from _torch_one_rank import one_rank_mesh

    cfg = port_cfg_module("gemma_7b").SMOKE
    params = lm.init_lm(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(0))
    h0, _ = lm.forward_train(params, toks, cfg)
    with one_rank_mesh(tmp_path) as mesh:
        h1, _ = lm.forward_train(params, toks, cfg, mesh=mesh)
    assert torch.allclose(h0, h1, rtol=1e-5, atol=1e-6)
    ds = port_cfg_module("deepseek_v3_671b").SMOKE
    lay = lm.MeshLayout(None, {"data": 4, "model": 2}, {"data": 0, "model": 0}, 4, 16)
    with pytest.raises(ValueError, match="does not divide"):
        lm._moe_weights(ds, {"wo": torch.zeros(2, 32, 16)}, lay, False)


@pytest.mark.parametrize("name,n_layers,prefix", [("gemma_7b", 28, 0),
                                                  ("deepseek_v3_671b", 2, 1)])
def test_bf16_logit_tolerance(name, n_layers, prefix):
    """Where ``lm.BF16_LOGIT_RTOL`` comes from: at SMOKE width and the depth
    the card runs, bf16 logits (decode and train forward) sit within half of
    it from the fp32 logits of the same parameters, relative to max |logit|,
    on four seeds; so two bf16 evaluations sit within it of each other."""
    from repro_torch.common.pytree import tree_map

    base = port_cfg_module(name).SMOKE.replace(n_layers=n_layers)
    if prefix:
        base = base.replace(prefix_dense_layers=prefix)
    cfg = base.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    for seed in range(4):
        p = lm.init_lm(torch.Generator().manual_seed(seed), cfg, device="cpu")
        p32 = tree_map(lambda t: t.float(), p)
        toks = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            h, _ = lm.forward_train(p32, toks, base)
            ref = lm._readout(p32, h[:, -1], base)
            hb, _ = lm.forward_train(p, toks, cfg)
            train = lm._readout(p, hb[:, -1], cfg).float()
            _, caches = lm.prefill(p, toks[:, :-1], cfg, 72)
            _, dec, _ = lm.make_decode_step(cfg)(p, toks[:, -1:], caches, 64)
        scale = float(ref.abs().max())
        for got in (train, dec.float()):
            assert float((got - ref).abs().max()) <= lm.BF16_LOGIT_RTOL / 2 * scale
        assert float((dec.float() - train).abs().max()) <= lm.BF16_LOGIT_RTOL * scale
