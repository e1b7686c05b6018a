"""The port's launchers and examples on the CPU, the launcher held against
the JAX package's.

* ``launch.serve.serve_backend`` over a JAX-saved small index loaded in the
  port, with the same numpy query batches and exact top-10 as JAX's
  ``serve_backend``: equal recall, the same row keys and trace counts (the
  index's own IVF state, and ``bruteforce`` rebuilt through
  ``with_backend``: neither draws a random number).
* ``launch.serve.main`` at a small size with every backend, ``--save-dir``,
  ``--mesh 1``, ``--online`` and ``--fleet 2`` on the CPU: every line it
  prints has the form of the JAX launcher's line (its f-strings), one
  backend row a registered backend, and no process group is left.
* ``--mesh 2`` under two spawned gloo ranks (``tests/_torch_launch_ranks.py``):
  with k' above the corpus every first stage returns the whole corpus, so
  both sharded rows' recall equals the single-device row's.
* In a subprocess with no card: the launcher leaves no process group
  behind, every entry point (both launchers, the five examples) raises
  without ``--device cpu``, and ``--mesh 2`` in one process names the
  ``torchrun`` command.
* ``launch.serve_lifecycle.main`` with ``--refresh --drift-burst``: 0 lost
  on every replay and a well-formed event chain (every refresh start ends in
  a swap or a failure).
* Each example's ``main`` at its CI size on the CPU, its own assertions
  holding.
"""
import argparse
import contextlib
import io
import pathlib
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.anns.params import IVFBackendConfig as JaxIVFConfig
from repro.core import maxsim as jax_maxsim
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.launch import serve as jax_serve
from repro.retriever import LemurRetriever as JaxRetriever

from repro_torch.anns import registry
from repro_torch.launch import serve, serve_lifecycle
from repro_torch.retriever import LemurRetriever

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
RANKS = pathlib.Path(__file__).with_name("_torch_launch_ranks.py")
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
SMALL = ["--m", "300", "--d", "16", "--d-prime", "32", "--batch", "8", "--n-batches", "2"]

# the JAX launcher's printed lines (repro/launch/serve.py), as patterns
NUM, F2 = r"\d+", r"\d+\.\d\d"
LINES = {
    "built": rf"\[serve\] index built in \d+\.\ds \({NUM} docs/s\)",
    "reloaded": r"\[serve\] persisted \+ reloaded retriever from \S+",
    "backend": rf"\[serve\] backend=(?P<name>[a-z_]+ *) QPS={NUM}  recall@10=\d\.\d{{3}}  "
               rf"jit_traces={NUM}",
    "sharded": rf"\[serve\] mesh= *\S+ sharded QPS={NUM}  recall@10=(?P<recall>\d\.\d{{3}})  "
               rf"jit_traces={NUM}  sq8=(True|False)  one_launch=(True|False)",
    "online": rf"\[serve\] online rate=[\d.e+]+qps p50={F2}ms p95={F2}ms p99={F2}ms "
              rf"achieved={NUM}qps occupancy={F2} jit_traces={NUM}/{NUM}",
    "fleet": rf"\[serve\] fleet replicas={NUM} rate=[\d.e+]+qps p50={F2}ms p99={F2}ms "
             rf"achieved={NUM}qps rejected={NUM} expired={NUM} lost=0 healthy={NUM} "
             rf"jit_traces={NUM}/{NUM} \(warmed {NUM}\)",
    "slo": rf"\[serve\]   slo (up|down): rung {NUM} -> {NUM} \(p99 \d+\.\dms, "
           rf"target \d+\.\dms\)",
    "slo_final": rf"\[serve\]   slo final rung={NUM}/{NUM}",
    "build_stage": r"\[build\] \S+ \d+\.\d\d s",
}


def classify(out: str) -> dict[str, list[re.Match]]:
    """Each printed line against the patterns; a line of no form fails."""
    found: dict[str, list] = {}
    for line in out.splitlines():
        hits = [(k, re.fullmatch(p, line)) for k, p in LINES.items()]
        hits = [(k, mt) for k, mt in hits if mt]
        assert hits, f"a line the JAX launcher does not print: {line!r}"
        found.setdefault(hits[0][0], []).append(hits[0][1])
    return found


# --------------------------------------------------------------------------
# serve_backend against JAX's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_saved(tiny_corpus, tmp_path_factory):
    cfg = JaxConfig(d=16, d_prime=64, m_pretrain=64, n_train=512, n_ols=256, epochs=2, k=10,
                    k_prime=64, anns="ivf", ivf=JaxIVFConfig(nprobe=8, sq8=True))
    jr = JaxRetriever.build(tiny_corpus, cfg, key=jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("launch_ckpt")
    jr.save(path)
    jr = JaxRetriever.load(path)
    toks, mask = jr.index.doc_tokens, jr.index.doc_mask
    jb, pb = [], []
    for b in range(3):
        q = synthetic.queries_from_corpus_query(tiny_corpus, 16, 8, seed=100 + b)
        qm = np.ones(q.shape[:2], bool)
        _, truth = jax_maxsim.true_topk(jnp.asarray(q), jnp.asarray(qm), toks, mask, 10)
        jb.append((jnp.asarray(q), jnp.asarray(qm), truth))
        pb.append((torch.as_tensor(q), torch.as_tensor(qm), torch.tensor(np.asarray(truth))))
    return jr, LemurRetriever.load(path, device="cpu"), jb, pb


@pytest.mark.parametrize("backend", ["ivf", "bruteforce"])
def test_serve_backend_matches_jax(jax_saved, backend, capsys):
    jr, pr, jb, pb = jax_saved
    args = argparse.Namespace(batch=16, k=10)
    want = jax_serve.serve_backend(jr, backend, jb, args, key=jax.random.PRNGKey(1))
    got = serve.serve_backend(pr, backend, pb, args)
    assert set(got) == set(want)
    # the same hits: a hit is 1/160 of a batch's recall, the means differ
    # only in their fp32 rounding
    assert got["recall@10"] == pytest.approx(want["recall@10"], abs=1e-6)
    assert got["jit_traces"] == want["jit_traces"] == 1
    assert got["backend"] == want["backend"] == backend
    jline, pline = capsys.readouterr().out.strip().splitlines()
    assert re.sub(r"QPS=\d+", "", jline) == re.sub(r"QPS=\d+", "", pline)


# --------------------------------------------------------------------------
# main, in process and under two ranks
# --------------------------------------------------------------------------

def test_main_prints_the_jax_lines(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve.main(SMALL + ["--backend", "all", "--save-dir", str(tmp_path), "--mesh", "1",
                                  "--online", "--online-duration", "1", "--fleet", "2",
                                  "--fleet-slo-ms", "50", "--device", "cpu"])
    assert not tdist.is_initialized(), "the launcher left its process group"
    found = classify(buf.getvalue())
    assert len(found["built"]) == len(found["reloaded"]) == 1
    assert [mt["name"].strip() for mt in found["backend"]] == registry.list_backends()
    assert all(len(mt["name"]) == 13 for mt in found["backend"])     # {backend:13s}
    assert len(found["sharded"]) == 2
    assert len(found["online"]) == len(found["fleet"]) == len(found["slo_final"]) == 1
    rows = res["rows"]
    assert [r["backend"] for r in rows["backends"]] == registry.list_backends()
    assert rows["fleet"]["n_lost"] == 0 and rows["sharded"]["one_launch"]
    assert res["retriever"].device.type == "cpu" and len(res["batches"]) == 2


def test_two_ranks_shard_the_corpus(tmp_path):
    """k' (256) above the corpus (200 docs): the single-device bruteforce
    row and both sharded rows rerank the whole corpus, so their recall is
    equal; only rank 0 prints."""
    argv = ["--m", "200", "--d", "16", "--d-prime", "32", "--batch", "8", "--n-batches", "2",
            "--backend", "bruteforce", "--mesh", "2", "--device", "cpu"]
    r = subprocess.run([sys.executable, str(RANKS), str(tmp_path), *argv], capture_output=True,
                       text=True, timeout=300, env=ENV)
    assert r.returncode == 0, r.stderr[-4000:]
    out = (tmp_path / "rank_0.txt").read_text()
    assert (tmp_path / "rank_1.txt").read_text() == ""
    found = classify(out)
    single = re.search(r"recall@10=(\d\.\d{3})", found["backend"][0].group(0)).group(1)
    assert [mt["recall"] for mt in found["sharded"]] == [single, single]
    assert all("mesh=      2" in mt.group(0) for mt in found["sharded"])


def test_entry_points_need_a_card_or_the_cpu():
    """No card here: every entry point raises through resolve_device unless
    told ``--device cpu``; ``--mesh 2`` in one process names torchrun; a
    launch with ``--mesh 1`` leaves no group."""
    code = textwrap.dedent("""
        import contextlib, io
        import torch.distributed as tdist
        from repro_torch.launch import serve, serve_lifecycle
        from repro_torch.examples import (lifecycle_refresh, quickstart, serve_batched,
                                          serve_fleet, serve_online)
        for mod in (serve, serve_lifecycle, quickstart, serve_batched, serve_online,
                    serve_fleet, lifecycle_refresh):
            try:
                mod.main([])
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError(f"{mod.__name__} ran without a card")
        try:
            serve.main(["--m", "50", "--mesh", "2", "--device", "cpu"])
        except RuntimeError as e:
            assert "torchrun --nproc-per-node 2 -m repro_torch.launch.serve" in str(e), e
        else:
            raise AssertionError("--mesh 2 ran in one process")
        assert not tdist.is_initialized()
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(["--m", "60", "--d", "8", "--d-prime", "16", "--batch", "4",
                        "--n-batches", "1", "--backend", "bruteforce", "--mesh", "1",
                        "--device", "cpu"])
        assert not tdist.is_initialized(), "a process group was left behind"
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env={**ENV, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr[-4000:]


# --------------------------------------------------------------------------
# the lifecycle launcher and the examples
# --------------------------------------------------------------------------

def test_serve_lifecycle_refreshes_without_loss():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve_lifecycle.main(["--m", "2000", "--duration", "2", "--refresh",
                                    "--drift-burst", "256", "--device", "cpu"])
    out = buf.getvalue()
    assert all(rep["n_lost"] == 0 for rep in res["reports"]) and len(res["reports"]) >= 2
    kinds = [ev.kind for ev in res["events"]]
    open_refresh = False
    for k in kinds:
        if k == "RefreshStarted":
            assert not open_refresh, kinds
            open_refresh = True
        elif k in ("SwapCompleted", "RefreshFailed", "SwapAborted"):
            assert open_refresh, kinds
            open_refresh = False
    assert not open_refresh, kinds
    assert res["n_swaps"] == kinds.count("SwapCompleted")
    for head in ("lifecycle: polling", "steady:   p50=", "drift:    +256/-128 docs", "done"):
        assert head in out
    if res["n_swaps"]:
        assert "swap:     n_swaps=" in out and res["version"] >= 3


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--m", "800", "--epochs", "8"]),
    ("serve_batched", []),
    ("serve_online", ["--m", "1000", "--duration", "2"]),
    ("serve_fleet", ["--duration", "2"]),
    ("lifecycle_refresh", []),
])
def test_example_runs_on_the_cpu(name, argv):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv + ["--device", "cpu"])
    out = buf.getvalue()
    if name == "quickstart":
        assert "save/load round-trip OK" in out and res["recall"] > 0.5
    elif name == "serve_batched":
        rows = res["rows"]
        assert set(rows) == {"fused", "legacy", "1launch"}
        assert rows["1launch"]["plan"] == {"one_launch": 1, "rerank": 1}
        assert rows["fused"]["recall"] == rows["legacy"]["recall"]
    elif name == "serve_online":
        assert res["new_doc_found"] and res["steady"]["n_lost"] == 0
    elif name == "serve_fleet":
        assert "[1] parity ok over 32 requests" in out
        assert res["added_found"] and res["quarantined"] == [0]
        assert res["overload"]["n_lost"] == 0
    else:
        kinds = [ev.kind for ev in res["events"]]
        assert "RefreshFailed" in kinds and kinds[-1] == "SwapCompleted"
    assert not tdist.is_initialized()
