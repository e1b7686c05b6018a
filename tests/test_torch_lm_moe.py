"""The port's MoE LMs (llama4-maverick-400b and deepseek-v3-671b) held
against the JAX package at their SMOKE widths: chunked attention with full
attention every 4th layer, dense/MoE alternation, MLA, the dense prefix and
the shared expert, all on one device (``moe_apply_dense``).  Tolerances are
those of ``tests/_torch_lm_parity.py``.
"""
import importlib

import pytest

from _torch_lm_parity import one_torch_thread  # noqa: F401 (a fixture)
from _torch_lm_parity import (check_decode_matches_train, check_forward_loss_grads,
                              check_init_lm, check_prefill_decode, check_train_step)

from repro_torch.models import lm

MOE = ["llama4_maverick_400b", "deepseek_v3_671b"]


def jax_cfg(name):
    return importlib.import_module(f"repro.configs.{name}")


@pytest.mark.parametrize("name", MOE)
def test_forward_loss_and_grads_match_jax(name):
    check_forward_loss_grads(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("name", MOE)
def test_train_step_matches_jax(name):
    check_train_step(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_match_jax(name):
    check_prefill_decode(jax_cfg(name).SMOKE)


@pytest.mark.parametrize("name", MOE)
def test_decode_matches_train(name):
    check_decode_matches_train(jax_cfg(name).SMOKE)


def test_init_lm_matches_jax_tree():
    check_init_lm(jax_cfg("llama4_maverick_400b").SMOKE)


def test_llama4_layer_pattern():
    from repro_torch.configs.llama4_maverick_400b import CONFIG

    stacks = lm.layer_stacks(CONFIG)
    assert len(stacks) == 1
    n_blocks, block = stacks[0]
    assert n_blocks * len(block) == 48
    assert [s.is_moe for s in block] == [False, True, False, True]
    assert block[3].chunk == 0 and block[0].chunk == 8192  # full attention every 4th


def test_deepseek_layer_pattern():
    from repro_torch.configs.deepseek_v3_671b import CONFIG

    stacks = lm.layer_stacks(CONFIG)
    assert stacks[0][0] == 3 and not stacks[0][1][0].is_moe      # dense prefix
    assert stacks[1][0] == 58 and stacks[1][1][0].is_moe
    cut = lm.layer_stacks(CONFIG.replace(n_layers=2, prefix_dense_layers=1))
    assert cut == [(1, (lm.LayerSpec(False, 0),)), (1, (lm.LayerSpec(True, 0),))]
