"""The MoE LMs' mesh forms on eight gloo ranks against the JAX package's on
eight forced host devices (``tests/_torch_dist_parity.py`` says how, and
states the tolerances): ``forward_train``, loss, gradients, one train step,
prefill and 3 decode steps of deepseek-v3's SMOKE config (MLA, the ``ep``
MoE) on (2, 2, 2) ("pod", "data", "model") and of llama4-maverick's (the
``ffslice`` MoE, chunked attention) on (4, 2), whose 4 "data" ranks its 4
experts divide.
"""
import numpy as np
import pytest

from _torch_dist_parity import close, grads_close, params_close, run

LM_ARCHS = ["deepseek-v3-671b", "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module")
def runs(run_forced8, tmp_path_factory):
    return run(run_forced8, tmp_path_factory.mktemp("dist_lm"), False, LM_ARCHS)


def test_jax_mesh_forms_ran(runs):
    """Every JAX mesh form ran on this jax (none fell back to mesh=None);
    ROADMAP Queue 3 lists any that does not."""
    _, want, _, _ = runs
    assert str(want["failed"]) == "", str(want["failed"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_loss_and_gradients(runs, arch):
    _, want, got, _ = runs
    pre = f"lm/{arch}/"
    close(got[pre + "hidden"], want[pre + "hidden"], msg="hidden")
    close(got[pre + "loss"], want[pre + "loss"], rtol=1e-5, atol=0)
    close(got[pre + "aux"], want[pre + "aux"], rtol=1e-5, atol=1e-7)
    close(got[pre + "aux_forward"], want[pre + "aux"], rtol=1e-5, atol=1e-7)
    names = [k for k in want if k.startswith(pre + "grads/")]
    assert names and all(n in got for n in names)
    for n in names:
        grads_close(got[n], want[n], msg=n)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step(runs, arch):
    _, want, got, _ = runs
    pre = f"lm/{arch}/"
    close(got[pre + "step_loss"], want[pre + "step_loss"], rtol=1e-5, atol=0)
    close(got[pre + "step_grad_norm"], want[pre + "step_grad_norm"], rtol=1e-5, atol=0)
    for k in want:
        if k.startswith(pre + "step_params/"):
            g = want[pre + "grads/" + k[len(pre + "step_params/"):]]
            params_close(got[k], want[k], g, msg=k)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode(runs, arch):
    _, want, got, per_rank = runs
    pre = f"lm/{arch}/"
    close(got[pre + "prefill_logits"], want[pre + "prefill_logits"], msg="prefill")
    for s in range(3):
        close(got[pre + f"decode_logits_{s}"], want[pre + f"decode_logits_{s}"], msg=f"step {s}")
    names = [k for k in want if k.startswith(pre + "decode_caches/")]
    assert names
    for n in names:
        close(got[n], want[n], msg=n)
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r[pre + "decode_logits_2"], got[pre + "decode_logits_2"])
