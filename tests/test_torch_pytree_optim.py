"""The port's pytree helpers and optimizers held against the JAX package.

Twins of ``tests/test_optim.py``'s eight tests run on the port, and each
port function is held to its JAX twin on the same numpy inputs.

Tolerances, with their reasons:
* pytree names and order: equal (the same rule); ``tree_global_norm``:
  rtol 1e-6 (fp32 sums of the same leaves in the same order, each leaf's
  reduction in its own order).
* Adam / AdamW on nested trees, with schedules and ``moment_dtype``: rtol
  1e-6 / atol 1e-7 (the same fp32 formula; only libm rounding).
* 8-bit Adam: int8 codes equal except where the scaled moment lies within
  1e-4 of a half (XLA may fuse the moment update into an FMA, moving a
  half-way value by one ulp); scales and parameters rtol 1e-6.
* int8 compression: the error-feedback all-reduce on a one-rank gloo group
  equals JAX's jitted one on a one-device mesh within 1e-5 (XLA fuses the
  residual ``g - q * scale`` into an FMA: an ulp of |g| a step, carried
  into the next step's codes).
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

from _torch_lm_parity import one_torch_thread  # noqa: F401 (a fixture)
from repro.common import pytree as jpt
from repro.optim import adam as jadam
from repro.optim import adam8bit as jadam8
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule

from repro_torch import optim
from repro_torch.common import pytree as pt
from repro_torch.convert import adam8_state_from_numpy, adam_state_from_numpy
from repro_torch.optim.adam import adam_init, adam_update, adamw, clip_by_global_norm
from repro_torch.optim.adam8bit import Q8, _dequantize, _quantize, adam8_init, adam8_update
from repro_torch.optim.compress import dequantize_int8, ef_int8_allreduce, quantize_int8
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine


def T(x):
    return torch.as_tensor(np.array(x))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Pair(NamedTuple):
    left: object
    right: object


def _tree(rng, xp):
    """A tree with every node kind: nested dicts (keys out of order), a list,
    a tuple, a NamedTuple and a None."""
    a = lambda *s: xp(rng.standard_normal(s).astype(np.float32))
    return {"zeta": {"b": a(3), "a": a(2, 2)}, "alpha": [a(4), (a(1), a(2, 3))],
            "mid": Pair(a(5), {"y": a(2), "x": a(3)}), "none": None, "10": a(2), "9": a(1)}


# --------------------------------------------------------------------------
# twins of tests/test_optim.py
# --------------------------------------------------------------------------

def test_adam_first_step_matches_closed_form():
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([0.1, -0.2])}
    new, _, _ = adam_update(grads, adam_init(params), params, lr=0.01, grad_clip=None)
    np.testing.assert_allclose(new["w"].numpy(), [1.0 - 0.01, 2.0 + 0.01], rtol=1e-4)


def test_clip_by_global_norm():
    grads = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    total = torch.sqrt(clipped["a"][0] ** 2 + clipped["b"][0] ** 2)
    assert abs(float(total) - 1.0) < 1e-5


def test_adam_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    st = adam_init(params)
    for _ in range(200):
        params, st, _ = adam_update({"w": 2 * params["w"]}, st, params, lr=0.1, grad_clip=None)
    assert float(params["w"].abs().max()) < 0.05


def test_adam8_tracks_adam():
    p1 = {"w": T(np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32))}
    p2 = {"w": p1["w"].clone()}
    s1, s2 = adam_init(p1), adam8_init(p2)
    rng = np.random.default_rng(1)
    for _ in range(20):
        g = {"w": T((rng.standard_normal((8, 64)) * 0.1).astype(np.float32))}
        p1, s1, _ = adam_update(g, s1, p1, lr=0.01, grad_clip=None)
        p2, s2, _ = adam8_update(g, s2, p2, lr=0.01, grad_clip=None)
    diff = float((p1["w"] - p2["w"]).abs().max())
    assert diff < 0.15, diff  # int8 moments: bounded drift, not bit-exact


def test_q8_shapes_and_sharding_friendliness():
    """Per-row scales: no flat reshape."""
    x = T(np.random.default_rng(0).standard_normal((4, 6, 32)).astype(np.float32))
    q = _quantize(x)
    assert q.q.shape == x.shape and q.q.dtype == torch.int8
    assert q.scale.shape == (4, 6)
    err = (_dequantize(q) - x).abs()
    assert float((err - q.scale[..., None] / 2).max()) <= 1e-6


def test_schedule_warmup_then_decay():
    lr = linear_warmup_cosine(1.0, warmup_steps=10, total_steps=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert abs(float(lr(torch.tensor(10))) - 1.0) < 0.11
    assert float(lr(torch.tensor(100))) < 0.2


def test_int8_compression_roundtrip():
    x = T((np.random.default_rng(0).standard_normal(100) * 3).astype(np.float32))
    q, s = quantize_int8(x)
    assert float((dequantize_int8(q, s) - x).abs().max()) <= float(s) / 2 + 1e-6


@pytest.fixture(scope="module")
def pod_mesh(tmp_path_factory):
    """A gloo process group of world size 1 and its ("pod",) mesh."""
    store = tmp_path_factory.mktemp("pg") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    finally:
        tdist.destroy_process_group()


def test_ef_int8_allreduce_error_feedback(pod_mesh):
    """Over many steps the error-feedback compression is unbiased, and each
    step equals JAX's on a one-device ("pod",) mesh."""
    from jax.sharding import PartitionSpec as P

    from repro.common.compat import AxisType, make_mesh, shard_map

    jmesh = make_mesh((1,), ("pod",), axis_types=(AxisType.Auto,))
    rng = np.random.default_rng(0)
    g_true = [rng.standard_normal(32).astype(np.float32) for _ in range(30)]
    err, jerr = {"g": torch.zeros(32)}, {"g": jnp.zeros(32)}
    sent = torch.zeros(32)
    jstep = jax.jit(shard_map(lambda g, e: jcompress.ef_int8_allreduce({"g": g}, e, "pod"),
                              mesh=jmesh, in_specs=(P(), P()), out_specs=(P(), P()),
                              check_vma=False))
    for g in g_true:
        red, err = ef_int8_allreduce({"g": T(g)}, err, pod_mesh.get_group("pod"))
        jred, jerr = jstep(jnp.asarray(g), jerr)
        np.testing.assert_allclose(red["g"].numpy(), np.asarray(jred["g"]), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(err["g"].numpy(), np.asarray(jerr["g"]), rtol=1e-6, atol=1e-5)
        sent = sent + red["g"]
    np.testing.assert_allclose(sent.numpy(), sum(g_true), atol=0.2)


# --------------------------------------------------------------------------
# pytree helpers against JAX
# --------------------------------------------------------------------------

def test_named_leaves_order_and_names_match_jax():
    jt = _tree(np.random.default_rng(0), jnp.asarray)
    tt = jax.tree_util.tree_map(T, jt)
    tt = {**tt, "mid": Pair(*tt["mid"])}
    want = jpt.named_leaves(jt, prefix="p/")
    got = pt.named_leaves(tt, prefix="p/")
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert [np.asarray(x).shape for x in jax.tree_util.tree_leaves(jt)] == [
        tuple(x.shape) for x in pt.tree_leaves(tt)]
    names = pt.tree_leaves(pt.tree_map_with_name(lambda n, x: n, tt))
    assert names == [n for n, _ in jpt.named_leaves(jt)]


def test_tree_reductions_and_maps_match_jax():
    rng = np.random.default_rng(1)
    jt = _tree(rng, jnp.asarray)
    tt = jax.tree_util.tree_map(T, jt)
    np.testing.assert_allclose(float(pt.tree_global_norm(tt)), float(jpt.tree_global_norm(jt)),
                               rtol=1e-6)
    assert float(pt.tree_global_norm({})) == 0.0
    assert pt.tree_size(tt) == jpt.tree_size(jt)
    assert pt.tree_bytes(tt) == jpt.tree_bytes(jt)
    half = pt.tree_cast(tt, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in pt.tree_leaves(half))
    assert pt.tree_bytes(half) == pt.tree_bytes(tt) // 2
    for got, want in [(pt.tree_add(tt, tt), jpt.tree_add(jt, jt)),
                      (pt.tree_scale(tt, 3.0), jpt.tree_scale(jt, 3.0)),
                      (pt.tree_where(torch.tensor(False), tt, pt.tree_zeros_like(tt)),
                       jpt.tree_where(False, jt, jpt.tree_zeros_like(jt)))]:
        for (n, a), (m, b) in zip(pt.named_leaves(got), jpt.named_leaves(want)):
            assert n == m
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="structures differ"):
        pt.tree_map(torch.add, {"a": torch.ones(1)}, {"b": torch.ones(1)})


# --------------------------------------------------------------------------
# optimizers against JAX
# --------------------------------------------------------------------------

def _params(rng):
    return {"stack_0": {"pos_0": {"attn": {"wq": rng.standard_normal((2, 4, 3))},
                                  "ln1": {"scale": rng.standard_normal(4)}}},
            "embed": {"embedding": rng.standard_normal((6, 4))}}


@pytest.mark.parametrize("case", ["clipped", "schedule", "adamw", "moment_bf16"])
def test_adam_on_trees_matches_jax(case):
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(lambda x: x.astype(np.float32), _params(rng))
    kw = {"clipped": dict(lr=3e-3, grad_clip=0.5),
          "schedule": dict(grad_clip=None),
          "adamw": dict(lr=1e-2, grad_clip=1.0),
          "moment_bf16": dict(lr=1e-2, grad_clip=None)}[case]
    moment = case == "moment_bf16"
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(T, params)
    js = jadam.adam_init(jp, jnp.bfloat16) if moment else jadam.adam_init(jp)
    ts = adam_init(tp, torch.bfloat16) if moment else adam_init(tp)
    for step in range(5):
        grads = jax.tree_util.tree_map(lambda x: (3 * rng.standard_normal(x.shape)).astype(
            np.float32), params)
        if case == "schedule":
            jkw, tkw = dict(lr=jschedule.linear_warmup_cosine(0.1, 2, 5)), dict(
                lr=linear_warmup_cosine(0.1, 2, 5))
        else:
            jkw = tkw = kw
        if case == "adamw":
            jp, js, jm = jadam.adamw(**kw)(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
            tp, ts, tm = adamw(**kw)(jax.tree_util.tree_map(T, grads), ts, tp)
        else:
            jp, js, jm = jadam.adam_update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
                                           **{**kw, **jkw})
            tp, ts, tm = adam_update(jax.tree_util.tree_map(T, grads), ts, tp, **{**kw, **tkw})
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for tree, jtree in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for (n, a), (m, b) in zip(pt.named_leaves(tree), jpt.named_leaves(jtree)):
            assert n == m and a.dtype == torch.float32 and np.asarray(b).dtype == np.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=n)


def test_schedules_match_jax():
    for ours, theirs in [(cosine_schedule(0.3, 50, 0.2), jschedule.cosine_schedule(0.3, 50, 0.2)),
                         (linear_warmup_cosine(1.0, 10, 100),
                          jschedule.linear_warmup_cosine(1.0, 10, 100))]:
        for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            np.testing.assert_allclose(float(ours(torch.tensor(s, dtype=torch.int32))),
                                       float(theirs(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_adam8_codes_match_jax():
    """Each step from JAX's state (carried through convert): parameters and
    scales as JAX's, codes equal except at half-way roundings, which are
    counted: the moment over its row scale, recomputed in fp64, within 1e-4
    of a half."""
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.standard_normal((8, 64)).astype(np.float32)},
              "b": rng.standard_normal((3, 5, 16)).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadam8.adam8_init(jp)
    init = adam8_state_from_numpy(to_np(js), device="cpu")
    assert isinstance(init.mu["a"]["w"], Q8) and float(init.mu["b"].scale.max()) == float(np.float32(1e-12))
    for a, b in zip(pt.tree_leaves(init), pt.tree_leaves(adam8_init(
            jax.tree_util.tree_map(T, params)))):
        assert torch.equal(a, b)
    halfway = 0
    for _ in range(6):
        grads = jax.tree_util.tree_map(
            lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32), params)
        ts = adam8_state_from_numpy(to_np(js), device="cpu")
        prev = {n: x.numpy() for n, x in pt.named_leaves(ts)}
        tp, ts, _ = adam8_update(jax.tree_util.tree_map(T, grads), ts,
                                 jax.tree_util.tree_map(T, to_np(jp)), lr=1e-2,
                                 weight_decay=0.01, grad_clip=None)
        jp, js, _ = jadam8.adam8_update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
                                        lr=1e-2, weight_decay=0.01, grad_clip=None)
        for (n, a), (_, b) in zip(pt.named_leaves(tp), jpt.named_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7,
                                       err_msg=n)
        got = {n: x.numpy() for n, x in pt.named_leaves(ts)}
        want = {n: np.asarray(x) for n, x in jpt.named_leaves(js)}
        assert list(got) == list(want)
        for n in got:
            if not n.endswith("/q"):
                np.testing.assert_allclose(got[n], want[n], rtol=1e-6, err_msg=n)
                continue
            bad = got[n] != want[n]
            if not bad.any():
                continue
            row = n[:-2]
            g = pt.named_leaves(grads)
            g = dict(g)[row.split("/", 1)[1]].astype(np.float64)
            old = prev[row + "/q"] * prev[row + "/scale"][..., None].astype(np.float64)
            mom = 0.9 * old + 0.1 * g if n.startswith("mu/") else 0.999 * old + 0.001 * g * g
            frac = np.abs(mom / want[row + "/scale"][..., None].astype(np.float64)) % 1.0
            assert (np.abs(frac[bad] - 0.5) < 1e-4).all(), n
            assert (np.abs(got[n][bad].astype(int) - want[n][bad].astype(int)) == 1).all(), n
            halfway += int(bad.sum())
    assert halfway <= 8, halfway


def test_optim_exports_jax_names():
    import repro.optim as joptim

    assert sorted(optim.__all__) == sorted(joptim.__all__)
    for name in optim.__all__:
        assert callable(getattr(optim, name))


def test_adam_state_crosses_from_jax():
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x.astype(np.float32)), _params(rng))
    js = jadam.adam_init(params)
    grads = jax.tree_util.tree_map(lambda x: x * 0.5, params)
    _, js, _ = jadam.adam_update(grads, js, params)
    ts = adam_state_from_numpy(to_np(js), device="cpu")
    assert int(ts.step) == 1
    for (n, a), (m, b) in zip(pt.named_leaves(ts), jpt.named_leaves(js)):
        assert n == m
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_prng_seq_matches_jax_in_law():
    """PRNGSeq: a seed (or a generator) gives the same sequence again; the
    streams are distinct; ``take`` continues the sequence as ``next`` does;
    draws from its generators have JAX's law (Threefry cannot be replayed:
    mean and std of N(0, 1) draws within 4 standard errors of JAX's)."""
    from repro.common.prng import PRNGSeq as JaxSeq

    from repro_torch.common.prng import PRNGSeq

    a, b = PRNGSeq(5, "cpu"), PRNGSeq(torch.Generator().manual_seed(5), "cpu")
    draws = [torch.randn(4, generator=next(a)) for _ in range(3)]
    again = [torch.randn(4, generator=g) for g in b.take(3)]
    assert all(torch.equal(x, y) for x, y in zip(draws, again))
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(torch.randn(4, generator=next(a)), draws[0])
    n = 4096
    ours = torch.cat([torch.randn(n, generator=g) for g in PRNGSeq(0, "cpu").take(4)])
    theirs = np.concatenate([np.asarray(jax.random.normal(k, (n,))) for k in JaxSeq(0).take(4)])
    se = 1 / np.sqrt(4 * n)
    assert abs(float(ours.mean()) - theirs.mean()) < 4 * np.sqrt(2) * se
    assert abs(float(ours.std()) - theirs.std()) < 4 * se
