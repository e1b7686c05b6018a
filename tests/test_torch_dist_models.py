"""The models' mesh forms on eight gloo ranks against the JAX package's on
eight forced host devices (``tests/_torch_dist_parity.py`` says how, and
states the tolerances): the twins of
``test_sharded_embedding_lookup_multi_device`` and
``test_gnn_sharded_forward_matches_unsharded``, the GNN's ``loss_fn`` and
one train step, on (2, 4) ("data", "model"); one train step of the four
SMOKE recsys archs on (2, 4) (the port's serve step against its
single-device form), and two-tower's retrieval step (k 10, duplicated
candidates so that ties break by index); gemma-7b's ``forward_train``,
loss, gradients, one train step, prefill and 3 decode steps (GQA,
context-parallel) on (2, 4); ``ShardedLoader(shardings=)`` and
``restore_tree(shardings=)`` of a JAX-saved checkpoint.  The MoE LMs are
in ``tests/test_torch_dist_lm.py``.
"""
import numpy as np
import pytest

from _torch_dist_parity import RECSYS_ARCHS, close, grads_close, mu_close, params_close, run

LM_ARCHS = ["gemma-7b"]


@pytest.fixture(scope="module")
def runs(run_forced8, tmp_path_factory):
    return run(run_forced8, tmp_path_factory.mktemp("dist_models"), True, LM_ARCHS)


def test_jax_mesh_forms_ran(runs):
    """Every JAX mesh form ran on this jax (none fell back to mesh=None);
    ROADMAP Queue 3 lists any that does not."""
    _, want, _, _ = runs
    assert str(want["failed"]) == "", str(want["failed"])


def test_sharded_embedding_lookup_multi_device(runs):
    z, want, got, per_rank = runs
    np.testing.assert_array_equal(got["lookup"], z["lookup/table"][z["lookup/ids"]])
    np.testing.assert_array_equal(got["lookup"], want["lookup"])
    assert all(np.array_equal(r["lookup"], got["lookup"]) for r in per_rank)


def test_gnn_sharded_forward_matches_unsharded(runs):
    z, want, got, _ = runs
    close(got["gnn/forward"], want["gnn/forward"])
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import gnn
    import torch

    cfg = gnn.GNNConfig(n_layers=2, d_hidden=16, d_node_in=8, d_edge_in=4, d_out=2)
    p = params_from_numpy({k[len("gnn/params/"):]: v for k, v in z.items()
                           if k.startswith("gnn/params/")}, device="cpu")
    with torch.no_grad():
        single = gnn.forward(p, *(torch.as_tensor(z["gnn/batch/" + k]).long() if "ers" in k
                                  else torch.as_tensor(z["gnn/batch/" + k])
                                  for k in ("node_feat", "edge_feat", "senders", "receivers")),
                             cfg)
    close(got["gnn/forward"], single.numpy(), rtol=1e-3, atol=1e-3)


def test_gnn_loss_and_train_step(runs):
    _, want, got, _ = runs
    close(got["gnn/loss"], want["gnn/loss"], rtol=1e-5, atol=0)
    close(got["gnn/step_loss"], want["gnn/step_loss"], rtol=1e-5, atol=0)
    close(got["gnn/step_grad_norm"], want["gnn/step_grad_norm"], rtol=1e-5, atol=0)
    _step_close(got, want, "gnn/")


def _step_close(got, want, pre):
    """Every leaf's new first moment, then its parameter by that moment."""
    names = [k[len(pre + "step_mu/"):] for k in want if k.startswith(pre + "step_mu/")]
    assert names and sorted(names) == sorted(
        k[len(pre + "step_params/"):] for k in want if k.startswith(pre + "step_params/"))
    for n in names:
        mu = want[pre + "step_mu/" + n]
        mu_close(got[pre + "step_mu/" + n], mu, msg=n)
        params_close(got[pre + "step_params/" + n], want[pre + "step_params/" + n], mu, msg=n)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_train_step(runs, arch):
    _, want, got, _ = runs
    pre = f"recsys/{arch}/"
    close(got[pre + "loss"], want[pre + "loss"], rtol=1e-5, atol=0)
    close(got[pre + "grad_norm"], want[pre + "grad_norm"], rtol=1e-5, atol=0)
    _step_close(got, want, pre)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_serve_step(runs, arch):
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import recsys

    z, _, got, _ = runs
    pre = f"recsys/{arch}/"
    p = params_from_numpy({k[len(pre + "params/"):]: v for k, v in z.items()
                           if k.startswith(pre + "params/")}, device="cpu")
    b = {k[len(pre + "batch/"):]: torch.as_tensor(v) for k, v in z.items()
         if k.startswith(pre + "batch/") and not k.endswith("/labels")}
    b = {k: v if v.is_floating_point() else v.long() for k, v in b.items()}
    close(got[pre + "serve"], recsys.make_serve_step(get_arch(arch).SMOKE)(p, b).numpy())


def test_two_tower_retrieval_step(runs):
    _, want, got, per_rank = runs
    pre = "recsys/two-tower-retrieval/"
    np.testing.assert_array_equal(got[pre + "retrieval_ids"], want[pre + "retrieval_ids"])
    close(got[pre + "retrieval_scores"], want[pre + "retrieval_scores"], rtol=1e-5, atol=1e-6)
    assert all(np.array_equal(r[pre + "retrieval_ids"], got[pre + "retrieval_ids"])
               for r in per_rank)


def test_ep_moe_refuses_experts_the_mesh_does_not_divide():
    """JAX's ``ep`` MoE cannot split deepseek's 4 SMOKE experts over an
    8-way ("model", "data"); the port raises ``ValueError`` there too (on a
    one-rank view of a (2, 4) mesh's layout)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import lm

    cfg = get_arch("deepseek-v3-671b").SMOKE
    lay = lm.MeshLayout(None, {"data": 2, "model": 4}, {"data": 0, "model": 0}, 2, 512)
    p = {"wi_0": torch.zeros(1, 32, 32), "wi_1": torch.zeros(1, 32, 32),
         "wo": torch.zeros(1, 16, 64)}
    with pytest.raises(ValueError, match="does not divide"):
        lm._moe_weights(cfg, p, lay, False)


def test_loader_and_checkpoint_blocks(runs):
    z, _, _, per_rank = runs
    for r in per_rank:
        i, j = (int(c) for c in r["coord"])
        for b in range(3):
            np.testing.assert_array_equal(r[f"loader/{b}/ids"], z["loader/ids"][b][4 * i:4 * i + 4])
            np.testing.assert_array_equal(r[f"loader/{b}/labels"],
                                          z["loader/labels"][b][4 * i:4 * i + 4])
            np.testing.assert_array_equal(r[f"loader/{b}/w"], z["loader/w"])
        assert int(r["ckpt/step"]) == 5
        for k, v in r.items():
            if not k.startswith("ckpt/blocks/"):
                continue
            whole = z["ckpt/params/" + k[len("ckpt/blocks/"):]]
            if k.endswith("/embedding"):          # rows over "model"
                rows = whole.shape[0] // 4
                whole = whole[j * rows:(j + 1) * rows]
            np.testing.assert_array_equal(v, whole, err_msg=k)


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
