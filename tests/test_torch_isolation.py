"""The port stands alone: it imports neither jax nor the JAX package, keeps
its kernel build lazy, and its entry points run on the card unless the
caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SRC = PKG.parent


def test_importing_every_module_pulls_in_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
               or k == "repro" or k.startswith("repro.")]
        assert not bad, bad
        assert "triton" not in sys.modules
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    # with serving, fleet and lifecycle (14 modules), the launchers (4), the examples (6),
    # the model layer (18: common/{pytree,prng,collectives}, optim/{schedule,adam8bit,
    # compress}, nn and its 3 modules, models and lm, configs and its 5 LM configs) and
    # the training path (15: data/loader, models/{recsys,gnn}, the 6 other configs and
    # the registry, train and its trainer, launch/train, the 2 training examples)
    assert int(r.stdout.strip()) >= 106


@pytest.mark.parametrize("package", ["repro_torch.launch", "repro_torch.examples"])
def test_launchers_and_examples_do_no_work_at_import(package):
    """Importing every launcher and example runs none of it: no kernel
    build, no process group, no device touched."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import torch.distributed as tdist
        pkg = importlib.import_module("{package}")
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "{package}.")]
        for n in names:
            importlib.import_module(n)
        from repro_torch.kernels import build
        assert not build._loaded, build._loaded
        assert not tdist.is_initialized()
        import torch
        assert not torch.cuda.is_initialized()
        assert "triton" not in sys.modules
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    # launch: serve, serve_lifecycle, mesh, train, and the dry-run tooling
    # (cells, dryrun, hlo_analysis, roofline)
    assert int(r.stdout.strip()) == {"repro_torch.launch": 8,
                                     "repro_torch.examples": 7}[package]


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun", "repro_torch.launch.cells",
                                    "repro_torch.launch.roofline",
                                    "repro_torch.launch.hlo_analysis"])
def test_dry_run_tooling_does_no_work_at_import(module):
    """Importing the dry run, the cells, the roofline or the cost analysis
    opens no process group, touches no device, builds no kernel and pulls
    in no JAX."""
    code = textwrap.dedent(f"""
        import importlib, sys
        import torch, torch.distributed as tdist
        importlib.import_module("{module}")
        assert not tdist.is_initialized()
        assert not torch.cuda.is_initialized()
        from repro_torch.kernels import build
        assert not build._loaded
        bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
               or k == "repro" or k.startswith("repro.")]
        assert not bad and "triton" not in sys.modules, bad
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("package,n", [("repro_torch.common", 5), ("repro_torch.optim", 4),
                                       ("repro_torch.nn", 3), ("repro_torch.models", 3),
                                       ("repro_torch.configs", 12), ("repro_torch.data", 2),
                                       ("repro_torch.checkpoint", 1),
                                       ("repro_torch.train", 1)])
def test_model_layer_does_no_work_at_import(package, n):
    """Importing the model layer and the training path (pytree and PRNG
    leaves, optim, nn, the models and their configs, the loader, the
    checkpoint manager, the trainer) builds no kernel, opens no process
    group, touches no device, starts no thread and pulls in no JAX."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import torch.distributed as tdist
        pkg = importlib.import_module("{package}")
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "{package}.")]
        import threading
        for name in names:
            importlib.import_module(name)
        from repro_torch.kernels import build
        assert not build._loaded, build._loaded
        assert threading.active_count() == 1
        assert not tdist.is_initialized()
        import torch
        assert not torch.cuda.is_initialized()
        bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
               or k == "repro" or k.startswith("repro.")]
        assert not bad and "triton" not in sys.modules, bad
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) == n


def test_model_layer_entry_points_default_to_the_card(monkeypatch):
    """init_lm, init_cache, the layers' inits and PRNGSeq run on the card
    unless the caller asks for the CPU, and raise without one."""
    from repro_torch.common.prng import PRNGSeq
    from repro_torch.configs.gemma_7b import SMOKE
    from repro_torch.models import lm
    from repro_torch.nn import layers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lm.init_lm(0, SMOKE), lambda: lm.init_cache(SMOKE, 1, 8),
                 lambda: PRNGSeq(0), lambda: layers.init_rmsnorm(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert lm.init_cache(SMOKE, 1, 8, device="cpu")[0]["pos_0"][0].device.type == "cpu"


@pytest.mark.parametrize("module", ["repro_torch.dist", "repro_torch.dist.serve",
                                    "repro_torch.retriever.sharded",
                                    "repro_torch.dist.sharding",
                                    "repro_torch.core.distributed"])
def test_sharded_serving_pulls_in_no_jax(module):
    """The multi-device modules stand alone too: torch.distributed, never
    jax, never the JAX package, and no kernel build at import."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module("{module}")
        bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
               or k == "repro" or k.startswith("repro.")]
        assert not bad, bad
        assert "torch.distributed" in sys.modules and "triton" not in sys.modules
        from repro_torch.kernels import build
        assert not build._loaded
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_repro_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {n}"


@pytest.mark.parametrize("name", ["fused_psi_pool", "ivf_probe_scan", "mips_sq8",
                                  "query_fused", "rerank_paged", "token_maxsim",
                                  "ivf_probe_res_scan", "rerank_paged_res",
                                  "rerank_gather"])
def test_kernel_source_names_what_it_replaces_and_its_bound(name):
    """Each CUDA source names the TPU kernel it replaces and what bounds it
    on the card, and the build finds it."""
    from repro_torch.kernels import build

    text = (PKG / "csrc" / f"{name}.cu").read_text()
    assert "// Replaces: src/repro/kernels/" in text and "Bound on the H100" in text
    assert name in build.sources()


def test_every_kernel_counts_its_launches():
    """ops.KERNELS lists every kernel, the search routes' and the residual
    tier's and the sharded path's included, and reset_launch_counts sets every
    counter to 0."""
    from repro_torch.kernels import ops

    assert set(ops.launch_counts()) == {
        "fused_psi_pool", "ivf_probe_scan", "rerank_paged_scores", "token_maxsim",
        "fused_psi", "query_fused", "mips_topk", "mips_sq8", "ivf_probe_res_scan",
        "rerank_paged_res_scores", "query_fused_res", "rerank_gather_scores"}
    saved = ops.launch_counts()
    try:
        for fn in ops.KERNELS.values():
            fn.launches = 7
        ops.reset_launch_counts()
        assert set(ops.launch_counts().values()) == {0}
    finally:
        for name, n in saved.items():
            ops.KERNELS[name].launches = n


def test_cuda_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.common.device import resolve_device
    from repro_torch.convert import index_from_numpy
    from repro_torch.retriever import LemurRetriever

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LemurRetriever.load(tmp_path)                      # default: the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_numpy({}, {"backend": "ivf"})
    assert resolve_device("cpu").type == "cpu"


def test_constructors_default_to_the_card(monkeypatch):
    """Psi.from_arrays, Psi.init and pages.allocate run on the card unless
    the caller asks for the CPU, and raise without one."""
    from repro_torch.core import pages
    from repro_torch.core.model import Psi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = [np.ones((2, 3), np.float32)] + [np.zeros(3, np.float32)] * 3
    calls = [lambda **kw: Psi.from_arrays(*w, **kw),
             lambda **kw: Psi.init(2, 3, torch.Generator().manual_seed(0), **kw),
             lambda **kw: pages.allocate(4, 2, 1, 2, 3, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        out = call(device="cpu")
        t = out.dense.kernel if isinstance(out, Psi) else out.W
        assert t.device.type == "cpu"


def test_checkpoint_reader(tmp_path):
    """Leaf names are unmangled, uncommitted steps are ignored, bfloat16
    leaves are refused."""
    import json

    from repro_torch.checkpoint import manager

    def write(step, leaves, committed=True, dtype=None):
        d = tmp_path / f"step_{step:08d}"
        d.mkdir()
        np.savez(d / "shard_00000.npz", **{k.replace("/", "__"): v for k, v in leaves.items()})
        spec = {k: {"shape": list(v.shape), "dtype": dtype or str(v.dtype)}
                for k, v in leaves.items()}
        (d / "manifest.json").write_text(json.dumps({"leaves": spec, "extra": {"x": 1}}))
        if committed:
            (d / "_COMMITTED").write_text("ok")

    write(3, {"psi/dense/kernel": np.ones((2, 3), np.float32)})
    write(7, {"a/b": np.zeros(2, np.int32)}, committed=False)
    assert manager.latest_step(tmp_path) == 3
    leaves, manifest = manager.restore(tmp_path)
    assert list(leaves) == ["psi/dense/kernel"] and manifest["extra"] == {"x": 1}
    write(9, {"w": np.ones(2, np.float32)}, dtype="bfloat16")
    with pytest.raises(ValueError, match="bfloat16"):
        manager.restore(tmp_path)
    assert manager.latest_step(tmp_path / "missing") is None
