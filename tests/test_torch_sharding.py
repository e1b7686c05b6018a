"""The port's sharding rules held statically against the JAX package's: the
twins of the 6 tests of ``tests/test_sharding_rules.py`` (every parameter
leaf of every arch resolves to a spec whose axes divide the production
meshes), the rule tables entry by entry, every leaf's name and resolved
spec for the 10 model archs at full size (meta init against
``jax.eval_shape``), and ``dist.sharding.local_block`` against
``NamedSharding``'s ``addressable_shards`` on (2, 2, 2) and (2, 4) meshes
(one forced-8 JAX subprocess)."""
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.common.pytree import tree_map_with_name as jtree_map_with_name
from repro.configs.registry import get_arch as jget_arch
from repro.dist import sharding as jsh
from repro.launch.cells import _resolve_spec as j_resolve_spec

from repro_torch.common.pytree import named_leaves
from repro_torch.configs.registry import get_arch
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import P

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
LM_ARCHS = ["qwen2.5-32b", "granite-20b", "gemma-7b", "llama4-maverick-400b-a17b",
            "deepseek-v3-671b"]
RECSYS_ARCHS = ["deepfm", "xdeepfm", "bst", "two-tower-retrieval"]
MODEL_ARCHS = LM_ARCHS + RECSYS_ARCHS + ["meshgraphnet"]


def _check_divisible(name, shape, spec, mesh_shape):
    for dim, axis in zip(shape, tuple(spec)):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        factor = int(np.prod([mesh_shape[a] for a in axes]))
        assert dim % factor == 0, f"{name}: dim {dim} not divisible by {factor} ({spec})"


def _port_params(arch):
    mod = get_arch(arch)
    if mod.FAMILY == "lm":
        from repro_torch.models import lm

        return lm.init_lm(0, mod.CONFIG, device="meta"), lm.lm_rules(mod.CONFIG)
    if mod.FAMILY == "recsys":
        from repro_torch.models import recsys

        return recsys.init_recsys(0, mod.CONFIG, device="meta"), sh.RECSYS_RULES
    from repro_torch.models import gnn

    return gnn.init_gnn(0, mod.CONFIG, device="meta"), sh.GNN_RULES


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_shardings_divide(arch, mesh_name):
    params, rules = _port_params(arch)
    for name, leaf in named_leaves(params):
        spec = sh.resolve_spec(rules, name, leaf.dim())
        _check_divisible(f"{arch}:{name}", leaf.shape, spec, MESHES[mesh_name])
        sh.local_shape(tuple(leaf.shape), spec, MESHES[mesh_name])


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_param_shardings_divide(arch):
    params, rules = _port_params(arch)
    for name, leaf in named_leaves(params):
        spec = sh.resolve_spec(rules, name, leaf.dim())
        _check_divisible(f"{arch}:{name}", leaf.shape, spec, MESHES["single"])


def test_lm_shape_cells_batch_divisible():
    """Train/prefill batch dims divide the data axes on both meshes."""
    for arch in LM_ARCHS:
        for name, spec in get_arch(arch).SHAPES.items():
            gb = spec["global_batch"]
            if spec["kind"] in ("train", "prefill"):
                assert gb % 32 == 0 or gb == 32, (arch, name, gb)
            assert spec["seq"] % 16 == 0  # model-axis seq sharding


def test_rules_first_match_wins():
    rules = sh.ShardingRules(rules=((r"special/w$", P("model")), (r".*", P())))
    assert rules.spec("special/w", 1) == P("model")
    assert rules.spec("other/w", 2) == P()


def test_rule_rank_overflow_raises():
    rules = sh.ShardingRules(rules=((r".*", P("data", "model")),))
    with pytest.raises(ValueError):
        rules.spec("w", 1)


def _jax_entries(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


@pytest.mark.parametrize("table", ["LM_RULES", "LM_RULES_FFSLICE", "RECSYS_RULES",
                                   "GNN_RULES"])
def test_rule_tables_equal_jax(table):
    port, jax_rules = getattr(sh, table).rules, getattr(jsh, table).rules
    assert len(port) == len(jax_rules)
    for (pat, spec), (jpat, jspec) in zip(port, jax_rules):
        assert pat == jpat
        assert tuple(spec) == _jax_entries(jspec), (pat, spec, jspec)


def _jax_params(arch):
    mod = jget_arch(arch)
    key = jax.random.PRNGKey(0)
    if mod.FAMILY == "lm":
        from repro.models import lm

        cfg = mod.CONFIG
        rules = jsh.LM_RULES_FFSLICE if cfg.moe_layout == "ffslice" and cfg.moe_n_experts \
            else jsh.LM_RULES
        return jax.eval_shape(lambda: lm.init_lm(key, cfg)), rules
    if mod.FAMILY == "recsys":
        from repro.models import recsys

        return jax.eval_shape(lambda: recsys.init_recsys(key, mod.CONFIG)), jsh.RECSYS_RULES
    from repro.models import gnn

    return jax.eval_shape(lambda: gnn.init_gnn(key, mod.CONFIG)), jsh.GNN_RULES


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_every_leaf_resolves_as_jax(arch):
    params, rules = _port_params(arch)
    jparams, jrules = _jax_params(arch)
    want = {}
    jtree_map_with_name(lambda n, x: want.__setitem__(
        n, (tuple(x.shape), _jax_entries(j_resolve_spec(jrules, n, len(x.shape))))), jparams)
    got = {n: (tuple(x.shape), tuple(sh.resolve_spec(rules, n, x.dim())))
           for n, x in named_leaves(params)}
    assert got == want


CASES = [
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6), (("model", "data"), None, None)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 8), (None, ("pod", "data"))),
    ((2, 2, 2), ("pod", "data", "model"), (16, 3), (("pod", "data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 6, 8), (None, "data", "model")),
    ((2, 4), ("data", "model"), (8, 12), ("data", "model")),
    ((2, 4), ("data", "model"), (16, 2), (("data", "model"), None)),
    ((2, 4), ("data", "model"), (8, 4, 2), (("model", "data"), None, None)),
    ((2, 4), ("data", "model"), (4, 8), ("model",)),
    ((2, 4), ("data", "model"), (3, 8), (None, "model")),
]

_JAX = """
import json, numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.common import compat
cases = json.loads('''{cases}''')
out = []
for shape, names, xshape, spec in cases:
    mesh = compat.make_mesh(tuple(shape), tuple(names),
                            axis_types=(compat.AxisType.Auto,) * len(shape))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    x = jax.device_put(np.arange(int(np.prod(xshape))).reshape(xshape),
                       NamedSharding(mesh, spec))
    rows = []
    for s in x.addressable_shards:
        coord = [int(c) for c in np.argwhere(mesh.devices == s.device)[0]]
        rows.append([coord, [[sl.start or 0, sl.stop if sl.stop is not None else n]
                             for sl, n in zip(s.index, xshape)]])
    out.append(rows)
print("RESULT" + json.dumps(out))
"""


def test_local_block_matches_addressable_shards(run_forced8):
    stdout = run_forced8(_JAX.format(cases=json.dumps(CASES)))
    result = json.loads(re.search(r"RESULT(.*)", stdout).group(1))
    for (shape, names, xshape, spec), rows in zip(CASES, result):
        x = torch.arange(int(np.prod(xshape))).reshape(xshape)
        p = P(*spec)
        assert len(rows) == int(np.prod(shape))
        for coord, index in rows:
            c = dict(zip(names, coord))
            block = sh.local_block(x, p, dict(zip(names, shape)), coordinate=c)
            want = x[tuple(slice(a, b) for a, b in index)]
            assert torch.equal(block, want), (shape, spec, coord)
            assert tuple(block.shape) == sh.local_shape(xshape, p, dict(zip(names, shape)))
