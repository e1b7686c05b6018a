"""The port's mesh forms on eight gloo ranks, held against the JAX package's
on eight forced host devices (``AxisType.Auto`` meshes) and against the
port's single-device forms.

One spawn of ``tests/_torch_nn_ranks.py`` (8 ranks) and one JAX run
(``run_forced8``) on the same inputs: ``moe_apply`` in the ``ep`` layout on
(2, 2, 2) ("pod", "data", "model") and ``ffslice`` on (2, 4) ("data",
"model"), both bodies, at capacity factors 8 (no token dropped: equal to
``moe_apply_dense``) and 1 (tokens dropped); ``flash_attention_cp`` on (4,
2) ("data", "model"), causal and chunked; ``ef_int8_allreduce`` over the
"data" axis of that mesh, three steps.

Tolerances: MoE outputs rtol 1e-5 / atol 1e-6 (the expert sums cross the
mesh in another order); the token-gather body's aux loss rtol 1e-6 (the
weight-gather body's is each shard's own, which JAX's replicated out-spec
does not show); attention rtol 1e-5 / atol 2e-6 (as ``test_torch_nn``);
the all-reduce atol 1e-5 (as ``test_torch_pytree_optim``).  Ranks that
hold the same block return it bit for bit.
"""
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.common.pytree import named_leaves as jnamed
from repro.nn import moe as jmoe

from repro_torch.nn import attention, moe
from repro_torch.optim.compress import dequantize_int8, quantize_int8

RANKS = pathlib.Path(__file__).with_name("_torch_nn_ranks.py")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
#: (layout, mesh shape); a rank's coordinate is its index in row-major order
MESHES = {"ep": (2, 2, 2), "ffslice": (2, 4)}
TAGS = [(layout, body, factor) for layout in MESHES
        for body in ("gather_tokens", "gather_weights") for factor in (8.0, 1.0)]

_JAX = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.common import compat
from repro.nn import attention, moe
from repro.optim.compress import ef_int8_allreduce

z = dict(np.load("{inputs}"))
params, shared = {{}}, {{}}
for k, v in z.items():
    if k.startswith("moe/shared/"):
        node = shared
        *head, last = k[len("moe/shared/"):].split("/")
        for part in head:
            node = node.setdefault(part, {{}})
        node[last] = jnp.asarray(v)
    elif k.startswith("moe/"):
        params[k[4:]] = jnp.asarray(v)
params["shared"] = shared
x = jnp.asarray(z["moe_x"])
out = {{}}
auto = lambda n: (compat.AxisType.Auto,) * n
for layout, shape, names in (("ep", (2, 2, 2), ("pod", "data", "model")),
                             ("ffslice", (2, 4), ("data", "model"))):
    mesh = compat.make_mesh(shape, names, axis_types=auto(len(shape)))
    with compat.set_mesh(mesh):
        for body, thr in (("gather_tokens", 4096), ("gather_weights", 0)):
            for factor in (8.0, 1.0):
                fn = jax.jit(lambda p, x: moe.moe_apply(
                    p, x, layout=layout, n_experts=8, top_k=2, mesh=mesh,
                    capacity_factor=factor, token_gather_threshold=thr))
                y, aux = fn(params, x)
                tag = f"{{layout}}_{{body}}_{{factor:g}}"
                out[tag + "_y"], out[tag + "_aux"] = np.asarray(y), np.asarray(aux)
mesh = compat.make_mesh((4, 2), ("data", "model"), axis_types=auto(2))
with compat.set_mesh(mesh):
    for chunk in (None, 4):
        fn = jax.jit(lambda q, k, v, pos: attention.flash_attention_cp(
            q, k, v, pos, mesh, chunk=chunk, q_block=8, kv_block=4))
        out[f"cp_{{chunk}}"] = np.asarray(fn(*(jnp.asarray(z[n]) for n in ("q", "k", "v", "pos"))))

    def body(g, e):
        red, err = ef_int8_allreduce({{"g": g[0]}}, {{"g": e[0]}}, "data")
        return red["g"][None], err["g"][None]

    ef = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                                  out_specs=(P("data"), P("data")), check_vma=False))
    err = jnp.zeros(z["ef_g"].shape[1:])
    for s, g in enumerate(z["ef_g"]):
        red, err = ef(jnp.asarray(g), err)
        out[f"ef_{{s}}_reduced"], out[f"ef_{{s}}_error"] = np.asarray(red), np.asarray(err)
np.savez("{out}", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(run_forced8, tmp_path_factory):
    """(inputs, JAX results, per-rank port results)."""
    work = tmp_path_factory.mktemp("nn_mesh")
    rng = np.random.default_rng(0)
    p = jmoe.init_moe(jax.random.PRNGKey(1), 8, 32, 64, gated=True, n_shared=1)
    inputs = {"moe/" + n: np.asarray(v) for n, v in jnamed(p)}
    inputs["moe_x"] = rng.standard_normal((4, 64, 32)).astype(np.float32)
    for n, shape in (("q", (4, 16, 4, 8)), ("k", (4, 16, 2, 8)), ("v", (4, 16, 2, 12))):
        inputs[n] = rng.standard_normal(shape).astype(np.float32)
    inputs["pos"] = np.broadcast_to(np.arange(16), (4, 16)).astype(np.int32).copy()
    inputs["ef_g"] = (3 * rng.standard_normal((3, 4, 40))).astype(np.float32)
    path = work / "inputs.npz"
    np.savez(path, **inputs)
    assert "OK" in run_forced8(textwrap.dedent(_JAX.format(inputs=path, out=work / "jax.npz")))
    ranks = work / "ranks"
    ranks.mkdir()
    res = subprocess.run([sys.executable, str(RANKS), str(path), str(ranks)],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    return (inputs, dict(np.load(work / "jax.npz")),
            [dict(np.load(ranks / f"rank_{r}.npz")) for r in range(8)])


def _moe_params(inputs):
    p = {k[4:]: torch.as_tensor(v) for k, v in inputs.items()
         if k.startswith("moe/") and not k.startswith("moe/shared/")}
    p["shared"] = {"wi_0": {"kernel": torch.as_tensor(inputs["moe/shared/wi_0/kernel"])},
                   "wi_1": {"kernel": torch.as_tensor(inputs["moe/shared/wi_1/kernel"])},
                   "wo": {"kernel": torch.as_tensor(inputs["moe/shared/wo/kernel"])}}
    return p


def _token_shard(layout, rank):
    """The rank's token block index (its batch-axis coordinates folded) and
    the count of blocks."""
    shape = MESHES[layout]
    coord = np.unravel_index(rank, shape)
    batch = coord[:-1]                         # every axis but "model"
    return int(np.ravel_multi_index(batch, shape[:-1])), int(np.prod(shape[:-1]))


@pytest.mark.parametrize("layout,body,factor", TAGS)
def test_moe_apply_on_eight_ranks_matches_jax(runs, layout, body, factor):
    inputs, want, ranks = runs
    tag = f"{layout}_{body}_{factor:g}"
    y_jax = want[tag + "_y"].reshape(-1, 32)
    blocks = {}
    for r, res in enumerate(ranks):
        idx, n = _token_shard(layout, r)
        rows = y_jax.shape[0] // n
        np.testing.assert_allclose(res[tag + "_y"], y_jax[idx * rows:(idx + 1) * rows],
                                   rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        if idx in blocks:
            assert np.array_equal(blocks[idx], res[tag + "_y"])
        blocks[idx] = res[tag + "_y"]
        if body == "gather_tokens":
            np.testing.assert_allclose(res[tag + "_aux"], want[tag + "_aux"], rtol=1e-6)
    y_port = np.concatenate([blocks[i] for i in sorted(blocks)])
    dense, aux = moe.moe_apply_dense(_moe_params(inputs), torch.as_tensor(inputs["moe_x"]),
                                     n_experts=8, top_k=2)
    err = np.abs(y_port - dense.reshape(-1, 32).numpy()).max()
    if factor == 8.0:     # nothing dropped: the single-device form
        assert err < 1e-5, err
        if body == "gather_tokens":
            np.testing.assert_allclose(ranks[0][tag + "_aux"], float(aux), rtol=1e-6)
    else:                 # capacity 1.0 drops pairs: the outputs part
        assert err > 1e-3, err


@pytest.mark.parametrize("chunk", [None, 4])
def test_flash_attention_cp_on_eight_ranks_matches_jax(runs, chunk):
    inputs, want, ranks = runs
    q, k, v, pos = (torch.as_tensor(inputs[n]) for n in ("q", "k", "v", "pos"))
    single = attention.flash_attention(q, k, v, pos, torch.arange(16), chunk=chunk,
                                       q_block=8, kv_block=4).numpy()
    np.testing.assert_allclose(want[f"cp_{chunk}"], single, rtol=1e-5, atol=2e-6)
    full = np.zeros_like(single)
    for res in ranks:
        i, j = res["coord"]
        full[i:i + 1, 8 * j:8 * (j + 1)] = res[f"cp_{chunk}"]
    np.testing.assert_allclose(full, want[f"cp_{chunk}"], rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(full, single, rtol=1e-5, atol=2e-6)


def test_ef_int8_allreduce_on_eight_ranks_matches_jax(runs):
    inputs, want, ranks = runs
    err = np.zeros((4, 40), np.float32)
    for s, g in enumerate(inputs["ef_g"]):
        local = []
        for i in range(4):
            q, scale = quantize_int8(torch.as_tensor(g[i] + err[i]))
            deq = dequantize_int8(q, scale).numpy()
            local.append(deq)
            err[i] = g[i] + err[i] - deq
        mean = np.mean(local, axis=0)
        for res in ranks:
            i = res["coord"][0]
            np.testing.assert_allclose(res[f"ef_{s}_reduced"], want[f"ef_{s}_reduced"][i],
                                       rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(res[f"ef_{s}_reduced"], mean, rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(res[f"ef_{s}_error"], want[f"ef_{s}_error"][i],
                                       rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(res[f"ef_{s}_error"], err[i], rtol=1e-6, atol=1e-5)
