"""Shared machinery of ``tests/test_torch_dist_models.py`` and
``tests/test_torch_dist_lm.py``: the models' mesh forms on eight gloo ranks
(``tests/_torch_dist_ranks.py``, spawned once a file) beside the JAX
package's mesh forms on eight forced host devices (``AxisType.Auto``
meshes, one ``run_forced8`` subprocess a file), on the same numpy inputs
and JAX-drawn parameters.

Where a JAX mesh form raises on the installed jax, its section falls back
to JAX's ``mesh=None`` form on the same inputs and the failure is listed
(each file's ``test_jax_mesh_forms_ran``).

Tolerances: the LM's are ``tests/_torch_lm_parity.py``'s (hidden, logits,
caches rtol 1e-4 / atol 1e-5 x max(1, max |JAX value|): the mesh sums its
partial products in another order; loss rtol 1e-5; gradients 1e-4 x max
|JAX grad| + 1e-7 a leaf; a train step's parameters 1e-5 where |g| >
1e-3 max |g|, 2 lr elsewhere), the recsys and GNN ones those of
``test_torch_recsys.py`` / ``test_torch_gnn.py`` (losses rtol 1e-5,
outputs rtol 1e-4 / atol 1e-5; a step's new first moments each leaf
within 1e-4 x its max + 1e-9, and its parameters by the same 1e-5 / 2 lr
rule, the moments standing for the gradients); the lookup, the loader and
the checkpoint are exact.
"""
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np

from repro.checkpoint.manager import save as jsave
from repro.common.pytree import named_leaves as jnamed
from repro.configs.registry import get_arch as jget_arch
from repro.data import synthetic
from repro.models import gnn as jgnn
from repro.models import lm as jlm
from repro.models import recsys as jrecsys

RANKS = pathlib.Path(__file__).with_name("_torch_dist_ranks.py")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
#: arch -> (mesh shape, axis names, batch, sequence): every sequence long
#: enough for the context-parallel attention (T / |model| >= 128)
LM_CASES = {"gemma-7b": ((2, 4), ("data", "model"), 2, 512),
            "deepseek-v3-671b": ((2, 2, 2), ("pod", "data", "model"), 4, 256),
            "llama4-maverick-400b-a17b": ((4, 2), ("data", "model"), 4, 256)}
RECSYS_ARCHS = ("deepfm", "xdeepfm", "bst", "two-tower-retrieval")
LR = 1e-3

_JAX = """
import contextlib, numpy as np, jax, jax.numpy as jnp
from repro.common import compat
from repro.common.pytree import named_leaves
from repro.configs.registry import get_arch
from repro.models import gnn, lm, recsys
from repro.optim import adam_init, adam_update

z = dict(np.load("{inputs}"))
out, failed = {{}}, []
auto = lambda n: (compat.AxisType.Auto,) * n


def tree(prefix):
    t = {{}}
    for k, v in z.items():
        if k.startswith(prefix):
            node = t
            *head, last = k[len(prefix):].split("/")
            for part in head:
                node = node.setdefault(part, {{}})
            node[last] = jnp.asarray(v)
    return t


def put(prefix, t):
    for n, v in named_leaves(t):
        out[prefix + n] = np.asarray(v)


def attempt(tag, fn, mesh):
    try:
        with compat.set_mesh(mesh):
            return fn(mesh)
    except Exception as e:  # the mesh form fails on this jax: its mesh=None form
        failed.append(f"{{tag}}: {{type(e).__name__}}: {{str(e)[:200]}}")
        return fn(None)


mesh24 = compat.make_mesh((2, 4), ("data", "model"), axis_types=auto(2))
mesh222 = compat.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=auto(3))

models = {models}
if models:
    # the lookup
    def lookup(m):
        t, i = jnp.asarray(z["lookup/table"]), jnp.asarray(z["lookup/ids"])
        if m is None:
            return jnp.take(t, i, axis=0)
        return jax.jit(lambda t, i: recsys.sharded_embedding_lookup(t, i, m))(t, i)
    out["lookup"] = np.asarray(attempt("sharded_embedding_lookup", lookup, mesh24))

    # the GNN
    gcfg = gnn.GNNConfig(n_layers=2, d_hidden=16, d_node_in=8, d_edge_in=4, d_out=2)
    gp, gb = tree("gnn/params/"), tree("gnn/batch/")
    def gnn_all(m):
        f = jax.jit(lambda p, b: gnn.forward(p, b["node_feat"], b["edge_feat"], b["senders"],
                                             b["receivers"], gcfg, m))
        step = jax.jit(gnn.make_train_step(gcfg, m))
        return f(gp, gb), step(gp, adam_init(gp), gb)
    fwd, (new, opt, met) = attempt("gnn", gnn_all, mesh24)
    out["gnn/forward"], out["gnn/loss"] = np.asarray(fwd), np.asarray(met["loss"])
    put("gnn/step_params/", new)
    put("gnn/step_mu/", opt.mu)
    out["gnn/step_loss"], out["gnn/step_grad_norm"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])

    # the recsys archs
    for arch in {recsys_archs}:
        cfg = get_arch(arch).SMOKE
        pre = f"recsys/{{arch}}/"
        p, b = tree(pre + "params/"), tree(pre + "batch/")
        def rs(m):
            return jax.jit(recsys.make_train_step(cfg, m))(p, adam_init(p), b)
        new, opt, met = attempt(arch, rs, mesh24)
        put(pre + "step_params/", new)
        put(pre + "step_mu/", opt.mu)
        out[pre + "loss"], out[pre + "grad_norm"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])
        if cfg.model == "two_tower":
            q, cand = {{"ids": jnp.asarray(z[pre + "query"])}}, jnp.asarray(z[pre + "candidates"])
            def ret(m):
                if m is None:
                    return jax.lax.top_k(recsys.two_tower_user(p, q["ids"], cfg) @ cand.T, 10)
                return jax.jit(recsys.make_retrieval_step(cfg, m, k=10))(p, q, cand)
            top, ids = attempt("make_retrieval_step", ret, mesh24)
            out[pre + "retrieval_scores"], out[pre + "retrieval_ids"] = np.asarray(top), np.asarray(ids)

# the LMs
for arch, (shape, names, B, T) in {lm_cases}.items():
    cfg = get_arch(arch).SMOKE
    pre = f"lm/{{arch}}/"
    p = tree(pre + "params/")
    toks, labels = jnp.asarray(z[pre + "tokens"]), jnp.asarray(z[pre + "labels"])
    mesh = compat.make_mesh(shape, names, axis_types=auto(len(shape)))

    def train(m):
        def lf(p):
            h, aux = lm.forward_train(p, toks, cfg, m)
            loss = lm.lm_loss(p, h, labels, cfg)
            return loss + cfg.aux_loss_coef * aux, (h, aux, loss)
        (_, (h, aux, loss)), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(p)
        # make_train_step's update of these gradients (not its whole step again)
        new, _, met = jax.jit(lambda g, p: adam_update(g, adam_init(p), p, lr=1e-3,
                                                      grad_clip=1.0))(g, p)
        return h, aux, loss, g, new, dict(met, loss=loss)
    h, aux, loss, g, new, met = attempt(arch + " train", train, mesh)
    out[pre + "hidden"], out[pre + "aux"], out[pre + "loss"] = map(np.asarray, (h, aux, loss))
    put(pre + "grads/", g)
    put(pre + "step_params/", new)
    out[pre + "step_loss"], out[pre + "step_grad_norm"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])

    def serve(m):
        logits, caches = jax.jit(lambda p, t: lm.prefill(p, t, cfg, T + {pad}, m))(p, toks)
        dec = jax.jit(lambda p, t, c, n: lm.decode(p, t, c, n, cfg, m))
        outs = []
        for s in range({steps}):
            d, caches = dec(p, jnp.asarray(z[pre + "decode_tokens"][s]), caches,
                            jnp.asarray(T + 1 + s))
            outs.append(d)
        return logits, outs, caches
    logits, outs, caches = attempt(arch + " serve", serve, mesh)
    out[pre + "prefill_logits"] = np.asarray(logits)
    for s, d in enumerate(outs):
        out[pre + f"decode_logits_{{s}}"] = np.asarray(d)
    put(pre + "decode_caches/", caches)

out["failed"] = np.array("\\n".join(failed))
np.savez("{out}", **out)
print("OK")
"""


def _np(tree):
    return {n: np.asarray(v) for n, v in jnamed(tree)}


def _inputs(work, models: bool, lm_archs):
    rng = np.random.default_rng(0)
    z = {}
    if models:
        _model_inputs(work, rng, z)
    for i, (arch, (_, _, B, T)) in enumerate(LM_CASES.items()):
        if arch not in lm_archs:
            continue
        cfg = jget_arch(arch).SMOKE
        pre = f"lm/{arch}/"
        z.update({pre + "params/" + n: v for n, v in _np(
            jlm.init_lm(jax.random.PRNGKey(20 + i), cfg)).items()})
        z[pre + "tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        z[pre + "labels"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        z[pre + "decode_tokens"] = rng.integers(0, cfg.vocab, (3, B, 1)).astype(np.int32)
    path = work / "inputs.npz"
    np.savez(path, **z)
    return path, z


def _model_inputs(work, rng, z):
    z |= {"lookup/table": rng.standard_normal((40, 8)).astype(np.float32),
         "lookup/ids": rng.integers(0, 40, (6, 3)).astype(np.int32)}
    # GNN: 64 nodes, its edges cut to a multiple of 8
    g = synthetic.make_mesh_graph(64, d_feat=8, d_edge=4, d_out=2, seed=0)
    cfg = jgnn.GNNConfig(n_layers=2, d_hidden=16, d_node_in=8, d_edge_in=4, d_out=2)
    E = g.senders.shape[0] - g.senders.shape[0] % 8
    z.update({f"gnn/params/{n}": v for n, v in _np(jgnn.init_gnn(jax.random.PRNGKey(0),
                                                                  cfg)).items()})
    z.update({"gnn/batch/node_feat": np.asarray(g.node_feat, np.float32),
              "gnn/batch/edge_feat": np.asarray(g.edge_feat[:E], np.float32),
              "gnn/batch/senders": np.asarray(g.senders[:E], np.int32),
              "gnn/batch/receivers": np.asarray(g.receivers[:E], np.int32),
              "gnn/batch/labels": rng.standard_normal((64, 2)).astype(np.float32),
              "gnn/batch/label_mask": (rng.random(64) < 0.8).astype(np.float32)})
    for i, arch in enumerate(RECSYS_ARCHS):
        cfg = jget_arch(arch).SMOKE
        pre = f"recsys/{arch}/"
        z.update({pre + "params/" + n: v for n, v in _np(
            jrecsys.init_recsys(jax.random.PRNGKey(10 + i), cfg)).items()})
        B = 16
        if cfg.model == "bst":
            b = {"history": rng.integers(0, cfg.n_items, (B, cfg.seq_len)),
                 "target_item": rng.integers(0, cfg.n_items, B)}
        else:
            b = {"ids": np.stack([rng.integers(0, v, B) for v in cfg.vocab_sizes], 1)}
        if cfg.model == "two_tower":
            b["item"] = rng.integers(0, cfg.n_items, B)
            b["logq"] = (0.1 * rng.standard_normal(B)).astype(np.float32)
            cand = rng.standard_normal((512, cfg.out_dim)).astype(np.float32)
            cand[300:310] = cand[40:50]          # ties across shards: the lower index wins
            z[pre + "candidates"] = cand
            z[pre + "query"] = np.stack([rng.integers(0, v, 1) for v in cfg.vocab_sizes],
                                        1).astype(np.int32)
        b["labels"] = (rng.random(B) < 0.5).astype(np.float32)
        z.update({pre + "batch/" + k: (v.astype(np.int32) if v.dtype.kind == "i" else v)
                  for k, v in b.items()})
    z["loader/ids"] = rng.integers(0, 100, (3, 8, 5)).astype(np.int32)
    z["loader/labels"] = rng.standard_normal((3, 8)).astype(np.float32)
    z["loader/w"] = rng.standard_normal(4).astype(np.float32)
    ck = {n: v for n, v in z.items() if n.startswith("recsys/deepfm/params/")}
    z.update({"ckpt/params/" + n[len("recsys/deepfm/params/"):]: v for n, v in ck.items()})
    jsave(work / "ckpt", 5, {n[len("recsys/deepfm/params/"):]: v for n, v in ck.items()})


def run(run_forced8, work, models: bool, lm_archs):
    """(inputs, JAX results, rank 0's results, every rank's results) of the
    model cases (``models``: the lookup, the GNN, the recsys archs, the
    loader and the checkpoint) and the LMs of ``lm_archs``."""
    path, z = _inputs(work, models, lm_archs)
    ranks = work / "ranks"
    ranks.mkdir()
    cases = ",".join((["models"] if models else []) + list(lm_archs))
    port = subprocess.Popen([sys.executable, str(RANKS), str(path), str(work / "ckpt"),
                             str(ranks), cases], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                                 "OMP_NUM_THREADS": "1"})
    try:
        code = _JAX.format(inputs=path, out=work / "jax.npz", recsys_archs=RECSYS_ARCHS,
                           models=models, lm_cases={a: LM_CASES[a] for a in lm_archs},
                           pad=8, steps=3)
        assert "OK" in run_forced8(textwrap.dedent(code))
    finally:
        _, err = port.communicate(timeout=300)
    assert port.returncode == 0, err[-4000:]
    per_rank = [dict(np.load(ranks / f"rank_{r}.npz")) for r in range(8)]
    return z, dict(np.load(work / "jax.npz")), per_rank[0], per_rank


def close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    """Within rtol, and atol x max(1, max |want|): the absolute part scaled to
    the tensor, since the mesh sums its partial products in another order."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol, atol=atol * scale,
                               err_msg=msg)


def grads_close(got, want, msg=""):
    tol = 1e-4 * np.abs(want).max() + 1e-7
    assert np.abs(got - want).max() <= tol, (msg, np.abs(got - want).max(), tol)


def mu_close(got, want, msg=""):
    """A step's new first moment (the clipped gradient x 0.1): each leaf
    within 1e-4 x its max + 1e-9 (``_torch_model_parity.check_step``)."""
    tol = 1e-4 * np.abs(want).max(initial=0.0) + 1e-9
    assert np.abs(got - want).max(initial=0.0) <= tol, (msg, np.abs(got - want).max(), tol)


def params_close(got, want, grad, msg=""):
    """A stepped parameter: 1e-5 where its gradient (or new first moment,
    ``grad``) is above 1e-3 x its max, 2 lr elsewhere (Adam's first step
    moves a rounding-level gradient's parameter by up to lr either way)."""
    big = np.abs(grad) > 1e-3 * np.abs(grad).max()
    assert np.abs(got - want)[big].max(initial=0) <= 1e-5 + 1e-5 * np.abs(want).max(), msg
    assert np.abs(got - want).max() <= 2 * LR + 1e-5, msg


