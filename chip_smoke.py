#!/usr/bin/env python3
"""Build and serve LEMUR's main paths on one NVIDIA GPU through the
PyTorch/CUDA port.

    python3 chip_smoke.py [--build-m 200000] [--m 800000] [--batches 4] [--seed 0]

Run from the repository root on a machine with a CUDA card and nvcc.  The
script

1. prints the card's name and power limit and the software versions, and
   builds every CUDA kernel in ``src/repro_torch/csrc`` (one nvcc each, in
   parallel);
2. holds the serving kernels, ``query_fused`` / ``mips_topk`` /
   ``mips_sq8`` and the residual kernels against their plain versions on
   small ragged cases (4, 5 and 7 below say what each holds);
2b. **launch**: while the process holds nothing large, runs the port's
   launchers and examples, counters from 0 around each part:
   ``repro_torch.launch.serve.main`` at full width (m 50,000, d 128, d'
   2,048, batches of 64, every registered backend, ``--save-dir``,
   ``--mesh 1``: a one-rank NCCL group it makes and destroys, ``--online``
   at 500 QPS for 3 s, ``--fleet 2`` with a 50 ms SLO), its printed rows
   parsed (one a backend, both sharded rows, the online row within its
   trace bound, the fleet row with nothing lost) and no process group
   left; the saved index loaded on the CPU and one batch served on both
   (the card's candidates against the CPU's, the card's top-10 against the
   CPU rerank of its candidates and, on rows whose candidates agree,
   against the CPU's own, ids up to counted near-ties); the v0 ``query``
   and ``candidates`` against the facade bit for bit; the four
   ``kernels.ops`` entries against the wrappers they call, bit for bit
   (a 4-bit codec trained on 4,096 latent rows for the residual scan);
   the five examples in process (their own assertions) while
   ``repro_torch.launch.serve_lifecycle`` runs twice beside them, each in
   a process of its own (m 20,000, d 128, ``--refresh --drift-burst 512``,
   single and ``--replicas 2``): nothing lost, every refresh start ending
   in a swap (to a later version) or a failure;
   then holds the token MaxSim kernel against its plain version on a small
   ragged case (d=20, T=7, a doc with no valid token, a mask that is not a
   prefix, n and m off every tile);
2c. **lm**: the model layer (``repro_torch.models.lm`` and the LM configs;
   no port kernel runs here: the JAX twin's attention and MoE are plain
   ``jnp``), while the process holds nothing large: gemma-7b at full width
   and depth drawn on the card by ``init_lm`` from a seeded CUDA generator
   (its parameters counted against ``param_count``), a prefill of 4 x
   2,048 tokens (twice: the first warms cuBLAS), 32 greedy decode steps
   (CUDA events a step; the last traced by torch.profiler: the card's busy
   share, the host's activity in its idle gaps), the first step's logits
   against ``forward_train``
   at the same position within ``lm.BF16_LOGIT_RTOL`` x max |logit|, each
   time beside its bound (``lm_bound``); the port's attention on gemma's
   prefill shapes against ``F.scaled_dot_product_attention`` (timed only);
   gemma's layer 0 in fp32 on the card against the CPU (1 x 256, within
   1e-4 x max |y|); deepseek-v3 at full width cut to 2 layers (prefill 2 x
   512, 16 decode steps, the same checks); two ``make_train_step`` steps at
   gemma's width and depth 2 (1 x 2,048: loss and grad norm finite, every
   weight moved by the first) and two ``adam8_update`` steps on the same gradients
   against two of ``adam_update`` (the first bit for bit, the second within
   1.5 lr + 2^-7 max |p| a leaf);
   the mesh forms (``moe_apply`` in both layouts and bodies,
   ``flash_attention_cp``, ``ef_int8_allreduce``) on a one-rank NCCL
   (1, 1, 1) ("pod", "data", "model") mesh against their single-device
   forms; and, while each model is held, the LM's mesh forms on a one-rank
   NCCL (1, 1) ("data", "model") mesh (``lm_mesh_serve``): a prefill of the
   same tokens (context-parallel) and 8 decode steps fed the same tokens,
   each step's logits within ``lm.BF16_LOGIT_RTOL`` x max |logit| of the
   ``mesh=None`` logits (deepseek-v3's ``ep`` MoE at capacity factor 8, so
   that it drops no pair where ``moe_apply_dense`` drops none); then frees
   all of it;
2d. **train**: the training path (no port kernel owed: nothing under the
   JAX package's models, data, checkpoint or train reaches a Pallas
   kernel), launch counters from 0 around each part: deepfm at full width
   (``configs/deepfm.CONFIG``, 16,262,144 table rows, batch 65,536) through
   ``TrainLoop`` with async checkpoints (step ms by CUDA events, loss, peak
   memory, the save's host copy and write apart), a second loop from
   another init that restores and resumes at the saved step with bit-equal
   state, the gradients and one step on the card against the same on the
   CPU at 1,024 rows (``step_card_vs_cpu``'s tolerance); xdeepfm at full
   width, its CIN a chunk of rows at a time (3 steps); meshgraphnet at full width on
   ``full_graph_sm`` (15 layers of 128, 2,708 nodes, 10,556 edges, d_in
   1,433, 7 classes) and ``molecule``, the steps and the card against the
   CPU; each step beside its bound; the mesh forms on a one-rank NCCL (1,
   1) mesh (``train_mesh_forms``: two deepfm ``make_train_step(cfg, mesh)``
   steps at batch 65,536 against two ``mesh=None`` steps, meshgraphnet's
   forward and one step on ``full_graph_sm`` alike, within
   ``step_card_vs_cpu``'s tolerance); ``multi_arch_smoke`` over the ten
   model archs; ``repro_torch.launch.train --arch lemur`` (recall, and the
   five LEMUR kernels each launched), the launcher on deepfm with a restart
   that resumes at its saved step; ``train_retrieval_e2e`` (20 steps, the
   same kernels); then frees all of it;
2e. **dist**: launch counters from 0 around each part: two-tower at full
   width ``make_retrieval_step`` on a one-rank NCCL (1, 1) mesh over
   ``retrieval_cand``'s 1,000,000 candidates (the 10 best copied into the
   second half: exact ties), k 100, its ids and scores equal to the ``mesh=None``
   scores' stable top 100 (score descending, index ascending); then, in a
   process of its own (``--dist-cells``: a process has one default group),
   rank 0 of a ``fake`` group of 256 ranks and the single-pod mesh over
   it: whether the ``fake`` backend takes CUDA tensors, and for
   ``lemur × serve_msmarco`` (34,539 docs a rank: the ψ-pool and dense
   rerank kernels), ``deepfm × train_batch`` and ``gemma-7b ×
   decode_32k`` the dry run (``launch.dryrun.run_cell``) and rank 0's step
   run on the card at its local shapes (stand-in values; the collectives
   move nothing): the dry run's ``argument_bytes`` required equal to the
   real local arguments' bytes, its peak beside
   ``torch.cuda.max_memory_allocated``, its FLOPs and bytes with the
   roofline's per-device bound at the H100's peaks beside the measured
   step ms (CUDA events, median of 3 after a warm-up);
3. **build path**: makes a corpus of ``--build-m`` docs on the card with the
   serving corpus's distribution (d=128, Poisson(67.5) lengths clipped to
   [4, 80], unit-norm tokens at topic weight 1.2 over 4,096 centres, dense
   (m, 80, 128) fp32) and runs ``LemurRetriever.build`` under
   ``configs/lemur_paper.CONFIG`` (paper App. A: d'=2048, m'=8192, n=100k,
   n'=16,384, 100 epochs of Adam, IVF-SQ8; the script reads the LEMUR
   cells' fixed values from that module), launch counters set to 0 just before and read
   just after; checks the launches, the loss, the first OLS block's W
   against the plain target path, and the Gram features; serves 256 queries
   of 32 tokens, scores recall against exact MaxSim and holds the learned
   first stage (top-k' of q.W) to 20 k'/m; holds the kernel to its plain
   version on rows of the pre-training launch, at the OLS block (timed) and
   on a ground-truth block; builds at m=2,000 and round-trips
   ``save``/``load`` on the card, then again with the residual tier
   (``ResidualConfig(enabled=True)``, ``ivf.residual_bits=4``).  The
   kernel's row holds it to an fp64 token MaxSim too (512 OLS tokens,
   within ``ref.TF32_SPLIT_RTOL``: its dots are the tensor cores' TF32
   split) and gives its bound at the split's rate beside the CUDA cores'.
   Then, over the trained index (before it frees the build's tensors):
3a. **fleet**: two ``clone_replicas`` behind a ``Router`` with the two
   rungs of ``build_rungs`` warmed (``warm_replicas``) on both; a step-up
   finds the rate the two sustain, then an open-loop replay of ragged
   queries (4-64 tokens, the corpus-query strategy) at half of it with an
   ``SLOController`` whose p99 target starts below any latency (one
   downshift) and is raised past any at five eighths of the replay (one
   recovery), an add barrier at a quarter (one ``snapshot_version`` on both
   replicas; the memory before and after it, since each clone copies what
   its first write touches) and ``kill_replica(1)`` at half; every accepted
   request resolved exactly once, the results after the add held against
   direct searches of replica 0 at their rung;
3c. **lifecycle**: a ``RetrieverServer`` over the trained index with a
   ``DriftMonitor``: 512 docs of the corpus's distribution, then topic
   bursts (6 other centres at weight 4) of 512 docs until the monitor
   triggers; a ``LifecycleManager`` refreshes in the background while
   replays of 2 s at 400 QPS go on and warm-swaps through ``apply``
   (coverage, fidelity and skew before the burst, after it and after the
   swap; ``build_refresh`` seconds by phase; the install; the searches
   served during the refresh; none dropped); then two refreshes of one
   snapshot with one seed, held bit for bit.  Then it frees the build's
   tensors;
3b. **widths**: holds the three reranks and token MaxSim at d=1,024 (the
   paged reranks at Tq=512 too, the dense rerank at d=130 and 20 and
   Tq=100 and 512), all three reranks at B=65,539 queries and
   ``mips_sq8``'s batched entry past 128 x 65,535 rows against their plain
   versions (widths and batches the card refused before); a few seconds;
4. **serving path**: holds the three serving kernels against their plain
   versions on a small ragged case (B=1, -1 pads, tiny lists, k > valid, a
   doc with no tokens); builds an index of ``--m`` docs at full width
   whose psi and W come from the seed (not trained); serves a warm-up batch
   and ``--batches`` batches of 256 queries x 32 tokens through
   ``LemurRetriever.search(SearchParams())`` (k=100, k'=1024, nprobe=32)
   with a few slots tombstoned, the counters set to 0 just before and read
   just after; checks every batch against a composition of the plain
   versions and the returned scores against exact MaxSim recomputed
   plainly, and that the paged rerank ran on the tensor cores
   (``rerank_paged_scores.last_path``);
5. **routes**: holds ``query_fused``, ``mips_topk`` and ``mips_sq8`` against
   their plain versions on a small ragged case (B=1, an empty probed list,
   k' above the valid slots and rows, exact ties from duplicated rows and
   slots, cap and m off every tile, a valid mask with holes); serves the
   same batches through the other routes, counters set to 0 just before
   each and read just after: one-launch IVF
   (``IVFSearchParams(use_one_launch=True)``) and the exact latent scan over
   W's full slot capacity, in one launch and blocked
   (``use_ann=False``), at the batch size, and the legacy gathered scan and
   rerank (``use_fused_gather=False``) at 64 queries, and above the card's
   old k' caps the one-launch IVF at k'=4,096 and the one-launch exact scan
   at k'=8,192 (a warm-up and two timed batches each); holds each batch
   against the plain composition and exact MaxSim, and 32 queries' top-10
   against exact MaxSim over the whole corpus (recall), and ``mips_topk`` to
   no rescan; each route's line gives its wrappers' launches a search and
   the psi kernel's CUDA launches in one traced search (at most 1: every
   route pools each query once); then times the three kernels against
   their plain versions
   and the nearest PyTorch call at the served shapes (``query_fused``'s
   rows with how their bound was counted),
   after checking the tensor-core product of ``mips_topk`` against an fp64
   product (65,536 rows, within ``ref.TF32_SPLIT_RTOL``) and its sampled
   pass against its full pass bit for bit;
6. times each serving kernel and its plain version at the served shapes:
   first a line with the probes' spread over the lists (rows read probe
   by probe, distinct live rows, readers a list, the largest work item of
   the scan's grid by list); the psi-pool also against an fp64 pool
   (within ``ref.PSI_SPLIT_RTOL``: its product runs on the tensor cores'
   TF32 split; its bound at the split's rate beside the CUDA cores'), two
   calls' bits, and its unpooled form on 16,384 query tokens (the build's
   OLS rows) timed against its plain version; the paged rerank also
   against fp64 MaxSim on
   8 queries (within ``ref.TF32_SPLIT_RTOL``: its dots run on the tensor
   cores), its bound at the split's rate beside the CUDA cores';
7. **residual**: holds ``ivf_probe_res_scan``, ``query_fused_res`` and
   ``rerank_paged_res_scores`` against their plain versions on a small
   ragged case at 2 and 4 bits (with the other ragged cases, before the
   index is built); then, beside the served index, trains the token codec
   (``ResidualConfig()``: 4 bits, 256 centroids, a 65,536-token sample of
   the pages), encodes the page pool a chunk of docs at a time (held to
   ``from_dense(codec=)`` on the first 500 docs) and builds 4-bit residual
   IVF lists over the same W with the served index's centroids; serves the
   same batches through the residual default route and the one-launch IVF
   (and that at k'=4,096, three batches), counters set to 0 just before
   each and read just after, holds every
   batch against the plain composition, the scores against exact MaxSim
   over the decoded tokens and 32 queries' top-10 against the fp32 exact
   top-10 (recall, beside the SQ8 route's); times the three kernels against
   their plain versions (the rerank also against fp64 MaxSim over the
   decoded tokens on 8 queries, within ``ref.TF32_SPLIT_RTOL``: its dots
   run on the tensor cores; its bound at the split's rate beside the CUDA
   cores', the scans' beside the floor of a lookup a code; the scan by
   list after a line with its probes' spread, as in 6), traces a batch
   (with the host's activity in the device's idle gaps) and reports token
   bytes per doc of both tiers; then one churn round on the compressed
   store and its 4-bit lists (as in 9; the residual retriever was made over
   the fp32 index's W and tombstones, so it copies what it writes: the line
   says what), its two routes held as before;
8. **sharded**: on a one-rank NCCL process group and its ("model",)
   DeviceMesh, holds ``rerank_gather_scores`` (fp32 and SQ8) against its
   plain version on a ragged case (B=1, Td=77, -1 candidates, a doc with no
   valid token, duplicated candidates, a partial query mask, k > k'),
   ``mips_topk`` at k'=4096 (valid rows above and below k') and the sharded
   one-launch route on small blocks; then, the residual tier freed, shards
   the served index with ``LemurRetriever.shard`` (its SQ8 block of 2^20
   rows, filled 25,000 slots at a time; k'_loc = 4096) and serves the same
   batches through the fused route (``SearchParams(use_ann=False)``), the
   one-launch route (and that at k'=2,048, k'_loc = 8,192, three batches)
   and the legacy route (16 queries), counters from 0 around each: every row against the plain composition (near-ties
   counted), its scores against exact MaxSim over the stored SQ8 tokens,
   no free or tombstoned row; times the latent product, its sort and the
   two kernels (``rerank_gather_scores`` also against fp64 MaxSim on 8
   queries, and its bound at the TF32 split's rate beside the CUDA
   cores'); then an fp32 block over a base cut to the first 100,000
   slots, its default route checked the same way, and the same base
   sharded at k'_loc = 1024 against its own exact scan; between the SQ8
   block's routes and the fp32 block, one add / delete round on the SQ8
   block through the sharded facade (the new docs placed in free rows), the
   fused route held to the plain composition after it;
9. **mutation**: CHURN_ROUNDS rounds on the served index through the facade
   (its OLS solver drawn by the seeded fallback, since the index came from
   arrays): delete 1,024 random live docs, add 1,024 new docs of the
   corpus's length distribution, update 256; each mutation timed on a
   synchronized host clock (the add split into fit, ``extend_ivf`` and
   ``add_docs``), its ``last_mutation_bytes``, the token MaxSim launches it
   made, the new W rows' targets held to the plain token MaxSim within
   ``ref.TF32_SPLIT_RTOL`` and the rows to the plain fit within that
   tolerance carried through the solve; after each round 256 queries
   through the default, one-launch and exact one-launch routes held to the
   plain composition, no deleted or tombstoned id in any top-100; free
   pages and slots before and after, whether the pool or a list's capacity
   grew, the change in allocated memory and the phase's peak;
9c. **online**: the churned index behind a ``RetrieverServer``
   (``BucketLadder((32, 64, 128, 256), 64)``, every bucket warmed by
   ``warm_buckets`` before any timed window); a step-up of short replays
   finds the highest rate it sustains; open-loop ``poisson_trace`` replays
   of 512 ragged queries (4-64 tokens, the corpus-query strategy) at
   1,000 QPS and at about 50 % and 90 % of that rate, counters from 0
   around each (the psi-pool, the scan and the rerank once a micro-batch);
   p50/p95/p99 from the scheduled arrival and from the submit, QPS,
   occupancy, the bucket histogram, rejects and expiries, ``trace_count``
   against ``ladder.compile_bound()``; every result held against a direct
   ``r.search`` of its query alone (ids up to counted near-ties, scores to
   fp32 tolerance) and 64 queries padded to their rung against themselves
   bit for bit; then a 1,000 QPS replay with an add, a delete and an update
   barrier, each version's results checked under the facade's lock before
   its barrier applies and no later result from an older version or
   holding a deleted doc;
9b. **backends**: checks that the IVF backend reached through the registry
   and composed by hand gives the default route's ids and scores bit for
   bit; then hands the served retriever over (its IVF lists freed) and
   builds ``bruteforce``, ``muvera``, ``dessert`` and ``token_pruning`` on
   it with ``LemurRetriever.with_backend``, one at a time, each from the
   last one's store: build seconds by stage, the state's bytes, the change
   in allocated memory and the peak; a warm-up and 8 timed batches of 256 x
   32 (k' 1,024, k 100), counters from 0 around them (the psi-pool and the
   paged rerank once a search), p50 and QPS, the first stage and the rerank
   timed apart, a traced batch, recall@10 of 32 queries against exact
   MaxSim; the first stage of a few queries against its JAX form
   (bruteforce: the full latent product; MUVERA: the full FDE product in
   fp64, and the first 2,048 docs' FDEs against fp64; DESSERT: the
   (B, m, L, Tq) lookup; token pruning: the probed lists gathered whole)
   and the top-100 against the plain rerank of the same candidates, ids up
   to counted near-ties, no tombstoned id served; then one round of 1,024
   deletes and 1,024 adds through the backend (its retriever owns the
   store, so the pool is written in place; token MaxSim fits the rows) and
   the same checks; last, DESSERT over a compressed tier of the churned
   corpus (its decoded tokens, reranked by ``rerank_paged_res_scores``);
10. gives every kernel row the kernels and memsets that one call of its
   wrapper put on the card (``cuda_launches_per_call``, and by name in
   ``cuda_launched``), counted by torch.profiler in this run: a lower
   bound, since a trace can drop device events (None: it saw none);
11. runs ``kernels/psi_ablation.py`` (the psi kernel built four ways:
   as built, without its product, with W' resident, without its
   statistics; under a minute);
12. prints the ``launch`` line (each part's seconds, rows, checks and
   launches by kernel, the phase's peak memory, the card) after phase 2b,
   the ``lm`` line (each part's times, bounds, checks and peak memory, the
   card) after phase 2c, the ``train`` line (each part's step ms, bounds,
   checks, save and restore seconds, peak memory and launches by kernel,
   the card) after phase 2d, the ``dist`` line (each part's checks, times,
   bounds, memory and launches, the card) after phase 2e,
   a ``build`` line, the ``fleet`` and ``lifecycle`` lines, a
   ``widths`` line, a ``serving`` line, a ``routes`` line, a ``residual``
   line, a ``sharded`` line, the ``mutation`` line (with the residual and
   sharded rounds), the ``online`` line, the ``backends`` line, the
   ``psi_ablation`` line, the ``kernels`` line (token MaxSim's row with its
   launches on the mutation path and the backends' rounds; every row with
   its launches on each backend's batches and in the online, fleet and
   lifecycle phases and in each part of the launch, train and dist
   phases) and last
   ``{"ok": true, ...}``.

Any failed check exits non-zero before the result lines are printed.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12             # tensor cores, dense
PEAK_BF16_S = 989e12             # tensor cores, dense
KP_BATCHES = 3                   # a route above the old k' caps: a warm-up and 2 timed
DOC_CHUNK = 25_000               # docs generated on the card at a time
SQ8_RTOL = 2 ** -16 * 4          # the JAX suite's SQ8 tolerance
NEAR_TIE = 1e-5                  # relative score gap allowed for an id swap
MAXSIM_RTOL = 1e-5               # token MaxSim: x max(1, max|plain|)
SERVE_KERNELS = ("fused_psi_pool", "ivf_probe_scan", "rerank_paged_scores")
QF_BOUND_COUNTED = ("bytes: the pooled latent, the probed lists' ids, the distinct live rows "
                    "(and scales) once, the probes, the (B, k') outputs; operations: 2 x d' "
                    "a row scanned probe by probe (the latent is the probe selection's, "
                    "pooled before the call)")
OLS_BLOCK = 2048                 # fit_output_layer_ols' doc block
QUERY_SEED = 7                   # recall queries; the training tokens use seed 0
# Both corpora's topic model, data/synthetic.make_corpus's weight: a token is
# normalize(noise + 1.2 * one of its doc's 2 topic centres), 4,096 centres.
TOPIC_STRENGTH = 1.2
TOPIC_CENTERS = 4096


class CheckFailed(RuntimeError):
    pass


def paper():
    """``repro_torch.configs.lemur_paper``: the LEMUR cells' fixed values
    (its ``CONFIG``: d, d', m', n, k, k', nprobe; its ``SHAPES``: the MS
    MARCO corpus size and tokens a doc)."""
    from repro_torch.configs import lemur_paper

    return lemur_paper


def msmarco_docs() -> int:
    return paper().SHAPES["serve_msmarco"]["m"]


def require(ok, msg):
    if not ok:
        raise CheckFailed(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def time_ms(torch, fn, n=20, warmup=3):
    """Median device time of ``fn`` over ``n`` runs, CUDA events per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def cuda_launches(torch, fn, tries=2, pad_s=0.5):
    """What one call of ``fn`` puts on the card, counted by torch.profiler:
    its kernels and memsets (copies not counted), as
    {cuda_launches_per_call: n, cuda_launched: {short name: count}}; n None
    where the profiler saw nothing on the device.  A trace can drop device
    events on this card, never add one: so the call runs ``pad_s`` inside
    its trace's edges, ``tries`` times, each name keeps its largest count,
    and n is a lower bound (dropped events seen in no trace stay uncounted)."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        seen = {}
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.name.startswith(("Memcpy", "ProfilerStep"))):
                continue
            short = re.split(r"[<(]", e.name.removeprefix("void ").replace(
                "(anonymous namespace)::", ""), maxsplit=1)[0].strip()
            seen[short] = seen.get(short, 0) + 1
        for k, v in seen.items():
            names[k] = max(names.get(k, 0), v)
    return {"cuda_launches_per_call": sum(names.values()) or None, "cuda_launched": names}


def search_launches(torch, counts, n_searches, search):
    """A route's launches a search: the wrappers' counts over its run
    divided by its searches, and the psi kernel's CUDA launches in one
    traced search (``psi_kernel``, a lower bound: see cuda_launches)."""
    seen = cuda_launches(torch, search)["cuda_launched"]
    return dict(launches_a_search={k: v / n_searches for k, v in counts.items() if v},
                psi_kernel_launches_traced=seen.get("psi_kernel", 0))


def bound(nbytes, flops, peak=PEAK_FP32_S):
    """The least time for the work: bytes over the memory rate against
    operations over ``peak`` (fp32 CUDA cores, or the TF32 tensor cores)."""
    t_mem, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / peak * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# the corpus, made on the card from the seed
# --------------------------------------------------------------------------

def build_corpus(torch, args):
    """The page store, filled a chunk of docs at a time, and a psi drawn
    from the JAX package's init distribution.  A doc's latent row is psi of
    its normalised mean token: not LEMUR's trained OLS W, but a row of one
    norm in the pooled query's space, so the probes spread over the lists
    and the candidates relate to the query as a trained first stage's do."""
    from repro_torch.core import pages
    from repro_torch.core.model import Psi
    from repro_torch.kernels import ref

    cfg = paper().CONFIG
    d, dp, T = cfg.d, cfg.d_prime, paper().SHAPES["serve_msmarco"]["doc_tokens"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    counts = np.clip(rng.poisson(67.5, args.m), 4, T)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    psi = Psi.init(d, dp, torch.Generator().manual_seed(args.seed), device=dev)
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    centers = torch.nn.functional.normalize(
        torch.randn(TOPIC_CENTERS, d, generator=gen, device=dev), dim=1)
    ppd = pages.pages_needed(torch.as_tensor(counts))
    store = pages.allocate(args.m, int(ppd.sum()), int(ppd.max()), d, dp, device=dev)
    slot = page = 0
    for s in range(0, args.m, DOC_CHUNK):
        n = min(DOC_CHUNK, args.m - s)
        cnt = torch.as_tensor(counts[s:s + n], device=dev)
        topics = torch.randint(0, TOPIC_CENTERS, (n, 2), generator=gen, device=dev)
        which = torch.randint(0, 2, (n, T), generator=gen, device=dev)
        tok = torch.randn(n, T, d, generator=gen, device=dev)
        tok = torch.nn.functional.normalize(
            tok + TOPIC_STRENGTH * centers[topics.gather(1, which)], dim=-1)
        mask = torch.arange(T, device=dev)[None, :] < cnt[:, None]
        tok = tok * mask[..., None]
        W = ref.fused_psi_ref(torch.nn.functional.normalize(tok.sum(1), dim=-1), *w)
        page += pages.write_docs(store, slot, page, W, tok, mask)
        slot += n
        if s == 0:
            # hold the chunked fill to from_dense on the first docs
            k = min(500, n)
            ref_store, _ = pages.from_dense(W[:k], tok[:k], mask[:k])
            np_ = int(pages.pages_needed(cnt[:k]).sum())
            require(torch.equal(ref_store.tok_pages[:np_], store.tok_pages[:np_])
                    and torch.equal(ref_store.page_table[:k], store.page_table[:k])
                    and torch.equal(ref_store.n_tokens[:k], store.n_tokens[:k]),
                    "chunked page fill differs from pages.from_dense")
            del ref_store
    return store, psi, rng


def make_queries(torch, store, rng, n, Tq=32, noise=0.25):
    """The corpus-query strategy of data/synthetic: tokens of a sampled doc,
    plus query-encoder noise, unit-normalised; ~1 in 8 queries is shorter
    (masked tail).  Returns (tokens, mask, source doc ids)."""
    dev = store.tok_pages.device
    m = int(store.n_docs[0])
    src = torch.as_tensor(rng.integers(0, m, n), device=dev)
    nt = store.n_tokens[src].long()
    pos = (torch.as_tensor(rng.random((n, Tq)), device=dev) * nt[:, None]).long()
    pg = store.page_table[src[:, None], pos // 16].long()
    tok = store.tok_pages[pg, pos % 16]
    tok = tok + noise * torch.as_tensor(rng.standard_normal(tok.shape),
                                        dtype=torch.float32, device=dev)
    tok = torch.nn.functional.normalize(tok, dim=-1).contiguous()
    short = torch.as_tensor(rng.random(n) < 0.125, device=dev)
    qlen = torch.where(short, torch.as_tensor(rng.integers(8, Tq, n), device=dev), Tq)
    mask = torch.arange(Tq, device=dev)[None, :] < qlen[:, None]
    return tok, mask.contiguous(), src


# --------------------------------------------------------------------------
# the plain composition (reference for the served ids)
# --------------------------------------------------------------------------

def plain_search(torch, index, q, qm, p):
    from repro_torch.anns.base import pad_topk, stable_topk
    from repro_torch.core.pages import mask_dead
    from repro_torch.kernels import ref

    psi, ann, st = index.psi, index.ann, index.store
    psi_q = ref.psi_pool_ref(q, qm, psi.dense.kernel, psi.dense.bias,
                             psi.ln.scale, psi.ln.bias)
    cs = psi_q @ ann.centroids.T
    probe = stable_topk(cs, p.backend.nprobe)[1].int()
    if ann.residual:
        s = ref.ivf_scan_res_ref(psi_q, probe, ann.ids, ann.vecs, ann.centroids,
                                 ann.rq_values, chunk=4)
    else:
        s = ref.ivf_scan_ref(psi_q, probe, ann.ids, ann.vecs, ann.scales, chunk=4)
    B = q.shape[0]
    flat_s = s.reshape(B, -1)
    flat_i = ann.ids[probe.long()].reshape(B, -1)
    top, pos = stable_topk(flat_s, min(p.k_prime, flat_s.shape[1]))
    cand = mask_dead(st, pad_topk(top, torch.gather(flat_i, 1, pos), p.k_prime)[1])
    top, ids = plain_rerank(torch, st, q, qm, cand, p.k)
    return dict(psi_q=psi_q, cs=cs, probe=probe, flat_s=flat_s, flat_i=flat_i,
                pos=pos, cand=cand, scores=top, ids=ids)


def plain_pair_scores(torch, st, q, qm, cand, chunk=16):
    """Exact MaxSim of each query against its (B, k) docs, recomputed plainly
    from the store's pages (decoded on the compressed tier)."""
    from repro_torch.kernels import ref

    if st.residual:
        return ref.rerank_scores_paged_res_ref(q, qm, cand, st.cent_pages, st.code_pages,
                                               st.page_table, st.n_tokens,
                                               st.codec.centroids, st.codec.values,
                                               chunk=chunk)
    return ref.rerank_scores_paged_ref(q, qm, cand, st.tok_pages, st.page_table,
                                       st.n_tokens, chunk=chunk)


def plain_rerank(torch, st, q, qm, cand, k):
    """The plain paged rerank of (B, k') candidates and its top-k, padded
    with (NEG, -1) when k > k'."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.kernels import ref

    B = q.shape[0]
    r = plain_pair_scores(torch, st, q, qm, cand)
    r = torch.where(cand >= 0, r, ref.NEG)
    top, idx = stable_topk(r, min(k, r.shape[1]))
    ids = torch.gather(cand, 1, idx)
    if top.shape[1] < k:
        pad = k - top.shape[1]
        top = torch.cat([top, top.new_full((B, pad), ref.NEG)], 1)
        ids = torch.cat([ids, ids.new_full((B, pad), -1)], 1)
    return top, ids


def exact_plain(torch, index, q, qm, p):
    """The plain composition of the exact latent scan route: the plain pool,
    the full (B, C) latent product over W's slot capacity with the alive
    mask, its stable top-k', the tombstone mask, the plain rerank."""
    from repro_torch.anns.base import pad_topk
    from repro_torch.core.pages import mask_dead
    from repro_torch.kernels import ref

    psi, st = index.psi, index.store
    psi_q = ref.psi_pool_ref(q, qm, psi.dense.kernel, psi.dense.bias,
                             psi.ln.scale, psi.ln.bias)
    kk = min(p.k_prime, st.W.shape[0])
    lat_s, lat_i = ref.mips_topk_ref(psi_q, st.W, None, st.alive, kp=kk, chunk=32)
    cand = mask_dead(st, pad_topk(lat_s, lat_i, p.k_prime)[1])
    top, ids = plain_rerank(torch, st, q, qm, cand, p.k)
    return dict(psi_q=psi_q, cand=cand, scores=top, ids=ids, **latent_edge(lat_s))


def port_stages(torch, index, q, qm, p):
    """The port's own intermediates for one batch (the kernels' real inputs)."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.core.model import pool_queries
    from repro_torch.core.pages import mask_dead
    from repro_torch.kernels.gather_scan import ivf_probe_scan

    ann = index.ann
    B = q.shape[0]
    psi_q = pool_queries(index.psi, q, qm)
    probe = stable_topk(psi_q @ ann.centroids.T, p.backend.nprobe)[1].int()
    flat_s = ivf_probe_scan(psi_q, probe, ann.ids, ann.vecs, ann.scales)
    flat_s = flat_s.reshape(B, -1)
    pos = stable_topk(flat_s, p.k_prime)[1]
    flat_i = ann.ids[probe.long()].reshape(B, -1)
    cand = mask_dead(index.store, torch.gather(flat_i, 1, pos))
    return dict(psi_q=psi_q, probe=probe, flat_s=flat_s, pos=pos, cand=cand)


def near(a, b, scale):
    return (a - b).abs() <= NEAR_TIE * scale


def classify_rows(torch, port_ids, port_scores, plain, stages, k_prime):
    """Every row whose ids differ from the plain composition must differ by a
    near-tie at one stage: the probe boundary, the k' boundary, or the final
    ranking.  Returns counts by kind; raises otherwise."""
    kinds = {"probe": 0, "candidates": 0, "final": 0}
    bad = (port_ids != plain["ids"]).any(1).nonzero().flatten().tolist()
    for b in bad:
        pa, pb = set(stages["probe"][b].tolist()), set(plain["probe"][b].tolist())
        cs = plain["cs"][b]
        scale = max(1.0, float(cs.abs().max()))
        if pa != pb:
            edge = plain["cs"][b, plain["probe"][b, -1].long()]
            for c in pa ^ pb:
                require(bool(near(cs[c], edge, scale)),
                        f"row {b}: probe {c} differs without a near-tie")
            kinds["probe"] += 1
            continue
        qa = set(stages["cand"][b].tolist()) - {-1}
        qb = set(plain["cand"][b].tolist()) - {-1}
        if qa != qb:
            fs, fi = plain["flat_s"][b], plain["flat_i"][b]
            score = dict(zip(fi.tolist(), fs.tolist()))
            edge = float(fs[plain["pos"][b, k_prime - 1]])
            scale = max(1.0, float(fs[torch.isfinite(fs)].abs().max()))
            for c in qa ^ qb:
                require(abs(score[c] - edge) <= NEAR_TIE * scale,
                        f"row {b}: candidate {c} differs without a near-tie")
            kinds["candidates"] += 1
            continue
        sa, sb = port_scores[b], plain["scores"][b]
        scale = max(1.0, float(sb.abs().max()))
        require(bool(near(sa, sb, scale).all()),
                f"row {b}: final ranking differs without a near-tie")
        kinds["final"] += 1
    return kinds


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def ragged_case(torch, seed):
    """All three kernels against their plain versions on a tiny ragged index
    served end to end: B=1, lists of a few slots, -1 pads, k > #valid
    candidates, a doc with no tokens and a masked query tail."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.core import pages
    from repro_torch.core.config import LemurConfig
    from repro_torch.core.model import Psi
    from repro_torch.kernels import fused_psi, gather_scan, ref
    from repro_torch.retriever import LemurRetriever, SearchParams

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    m, T, d, dp = 40, 37, 128, 256
    tok = torch.nn.functional.normalize(torch.randn(m, T, d, generator=g, device=dev), dim=-1)
    mask = torch.rand(m, T, generator=g, device=dev) > 0.5
    mask[3] = False
    W = torch.randn(m, dp, generator=g, device=dev)
    store, _ = pages.from_dense(W, tok, mask)
    store.alive[7] = False
    psi = Psi.init(d, dp, torch.Generator().manual_seed(seed), device=dev)
    cfg = LemurConfig(d=d, d_prime=dp, k=50, k_prime=24)
    r = LemurRetriever.from_arrays(cfg, psi, store,
                                   generator=torch.Generator().manual_seed(seed))
    q = torch.nn.functional.normalize(torch.randn(1, 6, d, generator=g, device=dev), dim=-1)
    qm = torch.tensor([[True, True, True, True, False, False]], device=dev)
    s, i = r.search(q, qm, SearchParams())
    p = r.resolve(SearchParams())
    plain = plain_search(torch, r.index, q, qm, p)
    require(torch.equal(i, plain["ids"]), "ragged case: ids differ from plain")
    require(i.shape == (1, 50) and bool((i[0, 24:] == -1).all()), "ragged pads")
    torch.testing.assert_close(s, plain["scores"], rtol=1e-5, atol=1e-4)
    errs = {}
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    errs["fused_psi_pool"] = float((fused_psi.fused_psi_pool(q, qm, *w)
                                    - ref.psi_pool_ref(q, qm, *w)).abs().max())
    ann = r.index.ann
    probe = stable_topk(plain["psi_q"] @ ann.centroids.T, 5)[1].int()
    a = gather_scan.ivf_probe_scan(plain["psi_q"], probe, ann.ids, ann.vecs, ann.scales)
    b = ref.ivf_scan_ref(plain["psi_q"], probe, ann.ids, ann.vecs, ann.scales)
    require(torch.equal(torch.isfinite(a), torch.isfinite(b)), "ragged scan pads")
    fin = torch.isfinite(b)
    errs["ivf_probe_scan"] = float((a[fin] - b[fin]).abs().max())
    cand = torch.tensor([[-1, 3, 0, 7, -1, 12, 39]], dtype=torch.int32, device=dev)
    args = (q, qm, cand, store.tok_pages, store.page_table, store.n_tokens)
    a = gather_scan.rerank_paged_scores(*args)
    b = ref.rerank_scores_paged_ref(*args)
    real = b > ref.NEG / 2            # pads and the empty doc score 4 * NEG
    require(bool(((a[~real] - b[~real]).abs() <= 1e-6 * b[~real].abs()).all()),
            "ragged rerank: NEG-scale scores differ")
    errs["rerank_paged_scores"] = float((a[real] - b[real]).abs().max())
    require(errs["fused_psi_pool"] < 1e-3 and errs["ivf_probe_scan"] < 1e-3
            and errs["rerank_paged_scores"] < 1e-4, f"ragged kernel errors {errs}")
    return errs


def profile_batch(torch, r, q, qm):
    """One more batch under torch.profiler (``profile_call``)."""
    return profile_call(torch, lambda: r.search(q, qm))


def profile_call(torch, fn):
    """One call of ``fn`` under torch.profiler: device time by kernel, the
    device's busy share of the traced wall time (tracing adds host cost, so
    these are not the latency numbers above), and what the host was doing
    while the device was idle: the gaps between the device's kernels (from
    the first host op to the last kernel's end), each top-level host op's
    and each CUDA runtime call's overlap with them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key[:60], us / 1e3, e.count))
    rows.sort(key=lambda x: -x[1])
    busy = sum(x[1] for x in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms) if wall_ms else None,
            "top": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:12]],
            "idle_gaps": idle_gaps(torch, prof.events())}


def idle_gaps(torch, events):
    """The device's idle gaps in a traced window and the host activity in
    them: ms of each top-level host op and of each CUDA runtime call that
    overlaps a gap (nested calls overlap their op), largest first."""
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    if not dev or not cpu:
        return None
    gaps, t = [], min(e.time_range.start for e in cpu)
    for a, b in dev:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)

    ends = [b for _, b in gaps]      # sorted and disjoint, as are the starts

    def overlap(e):
        t0, t1 = e.time_range.start, e.time_range.end
        o, i = 0.0, bisect.bisect_right(ends, t0)
        while i < len(gaps) and gaps[i][0] < t1:
            a, b = gaps[i]
            o += max(0.0, min(b, t1) - max(a, t0))
            i += 1
        return o

    ops, runtime = {}, {}
    for e in cpu:
        o = overlap(e)
        if o <= 0:
            continue
        if e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0.0) + o / 1e3
        elif e.cpu_parent is None:
            ops[e.name[:60]] = ops.get(e.name[:60], 0.0) + o / 1e3
    top = lambda d: [{"name": k, "ms": v} for k, v in sorted(d.items(), key=lambda x: -x[1])[:8]]
    return {"gaps": len(gaps), "idle_ms": sum(b - a for a, b in gaps) / 1e3,
            "largest_ms": max((b - a for a, b in gaps), default=0.0) / 1e3,
            "host_ops": top(ops), "runtime_calls": top(runtime)}


# --------------------------------------------------------------------------
# the build path
# --------------------------------------------------------------------------

def maxsim_err(torch, got, want, exact=None):
    """Max abs error of token MaxSim on the entries the plain version finds
    a valid token for; raises unless the NEG entries match exactly and the
    rest lie within MAXSIM_RTOL x max(1, max|plain|) (``exact``: an fp64
    reference instead, within ref.TF32_SPLIT_RTOL x max(1, max|exact|))."""
    from repro_torch.kernels import ref

    real = want != ref.NEG
    require(torch.equal(got != ref.NEG, real), "token_maxsim: NEG entries differ")
    if not bool(real.any()):
        return 0.0
    ref_t, rtol = (want, MAXSIM_RTOL) if exact is None else (exact, ref.TF32_SPLIT_RTOL)
    err = float((got[real].to(ref_t.dtype) - ref_t[real]).abs().max())
    scale = max(1.0, float(ref_t[real].abs().max()))
    require(err <= rtol * scale, f"token_maxsim: max abs err {err} > {rtol} x {scale}"
                                 f"{'' if exact is None else ' (against fp64)'}")
    return err


def maxsim_fp64(torch, x, docs, mask, chunk=256):
    """Token MaxSim in fp64, ``chunk`` docs at a time -> (n, m) fp64."""
    from repro_torch.kernels import ref

    out = []
    for s0 in range(0, docs.shape[0], chunk):
        sc = torch.einsum("nd,mtd->nmt", x.double(), docs[s0:s0 + chunk].double())
        out.append(torch.where(mask[None, s0:s0 + chunk], sc, ref.NEG).amax(-1))
    return torch.cat(out, 1)


def maxsim_ragged_case(torch, seed):
    """d=20, T=7, n and m off every tile, a doc with no valid token, a mask
    that is not a prefix."""
    from repro_torch.kernels import maxsim as kmaxsim
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    n, m, T, d = 131, 37, 7, 20
    x = torch.randn(n, d, generator=g, device=dev)
    docs = torch.randn(m, T, d, generator=g, device=dev)
    mask = torch.rand(m, T, generator=g, device=dev) > 0.4
    mask[5] = False
    mask[6] = torch.tensor([False, True, False, True, True, False, True], device=dev)
    got = kmaxsim.token_maxsim(x, docs, mask)
    want = ref.token_maxsim_ref(x, docs, mask)
    require(bool((got[:, 5] == ref.NEG).all()), "a doc with no valid token is not NEG")
    return maxsim_err(torch, got, want)


def widths_phase(torch, seed):
    """The widths and batches the card took only in part before: the three
    reranks and token MaxSim at d = 1,024 against their plain versions,
    the paged reranks at Tq = 512 too, the dense rerank at d = 130 and 20
    (off whole float4s and 16-byte rows) and Tq = 100 and 512, the paged
    fp32 rerank at d = 130, all three reranks at B = 65,539 queries of k' =
    2, and mips_sq8's batched entry past 128 x 65,535 rows.  A few seconds.
    Returns max abs errors."""
    from repro_torch.anns.quantization import sq8_quant
    from repro_torch.kernels import gather_scan, mips_sq8, ref
    from repro_torch.kernels import maxsim as kmaxsim

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    norm = lambda t: torch.nn.functional.normalize(t, dim=-1)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    ints = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, device=dev,
                                               dtype=torch.int32)
    errs = {}

    def rerank_err(what, got, want):
        real = want > ref.NEG / 2        # pads and docs with no valid token: Tq_valid x NEG
        require(bool(((got[~real] - want[~real]).abs() <= 1e-6 * want[~real].abs()).all()),
                f"{what}: NEG-scale scores differ")
        torch.testing.assert_close(got[real], want[real], rtol=1e-5, atol=1e-4)
        errs[what] = float((got[real] - want[real]).abs().max())

    # token MaxSim at d = 1,024: the OLS tile's image streams through the ring
    x = norm(randn(2048 + 5, 1024))
    docs = norm(randn(300, 77, 1024))
    mask = rand(300, 77) > 0.2
    mask[4] = False
    errs["token_maxsim_d1024"] = maxsim_err(torch, kmaxsim.token_maxsim(x, docs, mask),
                                            ref.token_maxsim_ref(x, docs, mask, chunk=16))
    # the dense rerank
    for d, Tq in ((1024, 32), (128, 512), (130, 100), (20, 32)):
        docs = norm(randn(500, 80, d))
        dm = rand(500, 80) > 0.15
        dm[7] = False
        q, qm = norm(randn(8, Tq, d)), rand(8, Tq) > 0.1
        cand = ints(-1, 500, (8, 300))
        cand[0, 5] = cand[0, 9]
        for sq8 in (False, True):
            toks, sc = sq8_quant(docs) if sq8 else (docs, None)
            args = (q, qm, cand, toks, dm, sc)
            got = gather_scan.rerank_gather_scores(*args)
            what = f"rerank_gather_{'sq8' if sq8 else 'fp32'}_d{d}_tq{Tq}"
            require(bool(got[0, 5] == got[0, 9]), f"{what}: duplicated candidates score apart")
            rerank_err(what, got, ref.rerank_scores_ref(*args, chunk=32))
    # the paged reranks (fp32 and 4-bit residual pages)
    C, pmax, ncent = 400, 5, 64
    for d, Tq in ((1024, 512), (1024, 32), (128, 512), (130, 32)):
        n_tokens = ints(0, pmax * 16 + 1, (C,))
        table = torch.randperm(C * pmax, generator=g, device=dev).int().reshape(C, pmax)
        q, qm = norm(randn(8, Tq, d)), rand(8, Tq) > 0.1
        cand = ints(-1, C, (8, 64))
        args = (q, qm, cand, norm(randn(C * pmax, 16, d)), table, n_tokens)
        rerank_err(f"rerank_paged_d{d}_tq{Tq}", gather_scan.rerank_paged_scores(*args),
                   ref.rerank_scores_paged_ref(*args, chunk=1))
        if d % 2:
            continue
        res = (q, qm, cand, ints(0, ncent, (C * pmax, 16)),
               ints(0, 256, (C * pmax, 16, d // 2)).to(torch.uint8), table, n_tokens,
               norm(randn(ncent, d)), 0.05 * randn(d, 16).sort(1).values)
        rerank_err(f"rerank_paged_res_d{d}_tq{Tq}", gather_scan.rerank_paged_res_scores(*res),
                   ref.rerank_scores_paged_res_ref(*res, chunk=1))
    # B = 65,539 queries of k' = 2, every rerank
    B, Tq, d = 65539, 4, 16
    q, qm, cand = norm(randn(B, Tq, d)), rand(B, Tq) > 0.2, ints(-1, 30, (B, 2))
    docs, dm = norm(randn(30, 20, d)), rand(30, 20) > 0.2
    for sq8 in (False, True):
        args = (q, qm, cand, *(sq8_quant(docs) if sq8 else (docs, None)))
        args = args[:4] + (dm,) + args[4:]
        rerank_err(f"rerank_gather_{'sq8' if sq8 else 'fp32'}_b{B}",
                   gather_scan.rerank_gather_scores(*args), ref.rerank_scores_ref(*args))
    n_tokens, table = ints(0, 33, (30,)), torch.arange(60, device=dev).int().reshape(30, 2)
    args = (q, qm, cand, norm(randn(60, 16, d)), table, n_tokens)
    rerank_err(f"rerank_paged_b{B}", gather_scan.rerank_paged_scores(*args),
               ref.rerank_scores_paged_ref(*args, chunk=8192))
    res = (q, qm, cand, ints(0, 8, (60, 16)), ints(0, 256, (60, 16, d // 2)).to(torch.uint8),
           table, n_tokens, norm(randn(8, d)), 0.05 * randn(d, 16).sort(1).values)
    rerank_err(f"rerank_paged_res_b{B}", gather_scan.rerank_paged_res_scores(*res),
               ref.rerank_scores_paged_res_ref(*res, chunk=8192))
    # mips_sq8's batched entry past 128 x 65,535 rows a query
    n = 128 * 65535 + 3
    q = randn(2, 16)
    codes = torch.randint(-127, 128, (2, n, 16), generator=g, device=dev).to(torch.int8)
    scales = rand(2, n) + 0.1
    got = mips_sq8.mips_sq8_batched(q, codes, scales)
    want = ref.mips_sq8_batched_ref(q, codes, scales, chunk=1)
    err = float((got - want).abs().max())
    require(err <= SQ8_RTOL * max(1.0, float(want.abs().max())),
            f"mips_sq8 batched past 128 x 65,535 rows: max abs err {err}")
    errs[f"mips_sq8_batched_n{n}"] = err
    return errs


def make_build_corpus(torch, m, seed):
    """A dense corpus on the card: Poisson(67.5) lengths clipped to [4, 80],
    tokens normalize(noise + TOPIC_STRENGTH * one of the doc's 2 topic
    centres) as in data/synthetic.make_corpus, zero past the length.
    (m, 80, 128) fp32."""
    from repro_torch.data.synthetic import MultiVectorCorpus

    d, T = paper().CONFIG.d, paper().SHAPES["index_msmarco"]["doc_tokens"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    counts = torch.as_tensor(np.clip(rng.poisson(67.5, m), 4, T), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    centers = torch.nn.functional.normalize(
        torch.randn(TOPIC_CENTERS, d, generator=gen, device=dev), dim=1)
    topics = torch.randint(0, TOPIC_CENTERS, (m, 2), generator=gen, device=dev)
    tokens = torch.empty((m, T, d), dtype=torch.float32, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < counts[:, None]
    for s in range(0, m, DOC_CHUNK):
        e = min(s + DOC_CHUNK, m)
        which = torch.randint(0, 2, (e - s, T), generator=gen, device=dev)
        tok = torch.randn(e - s, T, d, generator=gen, device=dev)
        tok = torch.nn.functional.normalize(
            tok + TOPIC_STRENGTH * centers[topics[s:e].gather(1, which)], dim=-1)
        tokens[s:e] = tok * mask[s:e, :, None]
    return MultiVectorCorpus(tokens, mask, topics, centers)


def build_phase(torch, args, card):
    """The build path on the card and its checks, then the fleet and the
    lifecycle over the trained index -> (build line, token MaxSim kernel
    row, fused_psi launches of the build, {"fleet": line, "lifecycle":
    line})."""
    import gc
    import tempfile

    from repro_torch.anns.base import stable_topk
    from repro_torch.convert import index_to_numpy
    from repro_torch.core import indexer, maxsim
    from repro_torch.core.model import pool_queries
    from repro_torch.data.synthetic import MultiVectorCorpus, queries_from_corpus_query
    from repro_torch.kernels import maxsim as kmaxsim
    from repro_torch.kernels import ops, ref
    from repro_torch.retriever import LemurRetriever, SearchParams
    from repro_torch.retriever.facade import first_stage

    dev = torch.device("cuda")
    ragged_err = maxsim_ragged_case(torch, args.seed)
    print(f"token_maxsim ragged case ok: max abs err {ragged_err}", flush=True)

    t0 = time.time()
    corpus = make_build_corpus(torch, args.build_m, args.seed)
    torch.cuda.synchronize()
    corpus_s = time.time() - t0
    m = corpus.m
    cfg = paper().CONFIG
    torch.cuda.reset_peak_memory_stats()

    # -- the main path, counters from 0 ------------------------------------
    ops.reset_launch_counts()
    t0 = time.time()
    r = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(args.seed),
                             device="cuda", verbose=True)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"token_maxsim": 1 + -(-m // OLS_BLOCK), "fused_psi": 1}
    require(launches == {**{k: 0 for k in launches}, **want},
            f"build launches {launches}, expected {want}")
    log = r.build_log
    losses = log["losses"]
    require(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")

    # -- checks of the build ----------------------------------------------
    solver, stats, index = r.solver_state, r.index.stats, r.index
    x_ols = solver["x_ols"]
    blk = (corpus.doc_tokens[:OLS_BLOCK], corpus.doc_mask[:OLS_BLOCK])
    g_plain = ref.token_maxsim_ref(x_ols, *blk, chunk=128)
    w_plain = torch.cholesky_solve(solver["feats"].T @ ((g_plain - stats.mean) / stats.std),
                                   solver["chol"]).T
    W = index.store.W[:OLS_BLOCK]
    w_err = float((W - w_plain).abs().max())
    w_tol = 1e-3 * float(W.abs().max())
    sv = torch.linalg.svdvals(solver["chol"])
    cond = float((sv.max() / sv.min()) ** 2)
    require(w_err <= w_tol, f"first OLS block W: max abs err {w_err} > {w_tol} "
                            f"(Gram condition number {cond:.3g})")
    feats_plain = ref.fused_psi_ref(x_ols, *index.psi.params().values())
    feats_err = float((solver["feats"] - feats_plain).abs().max())
    feats_tol = 1e-4 * max(1.0, float(feats_plain.abs().max()))
    require(feats_err <= feats_tol, f"Gram features: max abs err {feats_err} > {feats_tol}")
    del g_plain, w_plain, feats_plain

    # -- serve the built index, recall against exact MaxSim -----------------
    q = torch.as_tensor(queries_from_corpus_query(corpus, 256, q_tokens=32, seed=QUERY_SEED),
                        device=dev).contiguous()
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
    p = r.resolve(SearchParams())
    s, ids = r.search(q, qm, SearchParams())
    with torch.inference_mode():
        cand = first_stage(index, q, qm, p)
        latent = stable_topk(pool_queries(index.psi, q, qm) @ index.store.W[:m].T,
                             p.k_prime)[1]
    t0 = time.time()
    _, truth = maxsim.true_topk(q, qm, corpus.doc_tokens, corpus.doc_mask, p.k, block=16384)
    torch.cuda.synchronize()
    truth_s = time.time() - t0
    top10 = truth[:, :10]
    recall = {"recall@10": float(maxsim.recall_at(ids[:, :10], top10).mean()),
              "recall@100": float(maxsim.recall_at(ids, top10).mean()),
              "first_stage_recall": float(maxsim.recall_at(cand, top10).mean()),
              "latent_recall": float(maxsim.recall_at(latent, top10).mean())}
    floor = 20 * p.k_prime / m
    # The learned first stage (top-k' of q.W over every doc) must find 20x
    # what chance finds.  The IVF over W is reported, not held to the floor:
    # on this corpus k-means leaves most lists with a few rows, in the JAX
    # package as in the port (tests/test_torch_ivf_skew.py), and the probed
    # lists hold few of the exact neighbours.
    require(recall["latent_recall"] >= floor,
            f"latent first-stage recall {recall['latent_recall']} < 20 k'/m = {floor}")
    n_cand = (cand >= 0).sum(1)
    valid = ids >= 0
    require(torch.equal(valid.sum(1), n_cand.clamp(max=p.k))
            and bool((valid[:, :-1] >= valid[:, 1:]).all()),
            "the top-k holds -1 before a real id, or more -1 than the first stage owes")
    st = index.store
    exact = ref.rerank_scores_paged_ref(q, qm, ids, st.tok_pages, st.page_table,
                                        st.n_tokens, chunk=32)
    torch.testing.assert_close(s, torch.where(valid, exact, ref.NEG), rtol=1e-5, atol=1e-4)
    counts = index.ann.counts.float()
    lists = {"max": int(counts.max()), "median": float(counts.median()),
             "mean": float(counts.mean()), "lists_le_3": float((counts <= 3).float().mean()),
             "empty": int((counts == 0).sum())}
    print(f"build served: {recall}, floor {floor} (latent), lists {lists}, "
          f"valid candidates a query {float(n_cand.float().mean())}", flush=True)

    # -- the kernel at the OLS block shape ---------------------------------
    kargs = (x_ols, *blk)
    k_err = maxsim_err(torch, kmaxsim.token_maxsim(*kargs), ref.token_maxsim_ref(*kargs, chunk=128))
    ms = time_ms(torch, lambda: kmaxsim.token_maxsim(*kargs))
    plain_ms = time_ms(torch, lambda: ref.token_maxsim_ref(*kargs, chunk=128))
    nvalid = int(blk[1].sum())
    n_ols, d = x_ols.shape
    nbytes = n_ols * d * 4 + nvalid * d * 4 + blk[1].numel() + n_ols * OLS_BLOCK * 4
    flops = 2 * n_ols * nvalid * d
    b_ms, b_by = bound(nbytes, 3 * flops, PEAK_TF32_S)           # 3xTF32
    b_all_ms = bound(nbytes, 3 * 2 * n_ols * blk[1].numel() * d, PEAK_TF32_S)[0]
    # the tensor cores' split against fp64 token MaxSim, 512 OLS tokens
    exact = maxsim_fp64(torch, x_ols[:512], *blk)
    tc_err = maxsim_err(torch, kmaxsim.token_maxsim(x_ols[:512], *blk), exact.float(),
                        exact=exact)

    # -- ... at the pre-training shape (the build's first draw, its tokens)
    # and at a ground-truth block: rows of the launch against the plain one
    x_train = torch.as_tensor(indexer.make_training_tokens(corpus, cfg, seed=0),
                              dtype=torch.float32, device=dev).contiguous()
    pre = torch.randperm(m, generator=torch.Generator().manual_seed(args.seed))
    pre = pre[:min(cfg.m_pretrain, m)].to(dev)
    pre_docs = (corpus.doc_tokens[pre], corpus.doc_mask[pre])
    g_pre = kmaxsim.token_maxsim(x_train, *pre_docs)
    n_tr = x_train.shape[0]
    rows = torch.cat([torch.arange(0, 2048), torch.arange(n_tr - 1001, n_tr)]).to(dev)
    pre_err = maxsim_err(torch, g_pre[rows],
                         ref.token_maxsim_ref(x_train[rows], *pre_docs, chunk=512))
    del g_pre
    pre_ms = time_ms(torch, lambda: kmaxsim.token_maxsim(x_train, *pre_docs), n=3, warmup=1)
    nvalid_pre = int(pre_docs[1].sum())
    pre_b_ms, pre_b_by = bound(n_tr * d * 4 + nvalid_pre * d * 4 + pre_docs[1].numel()
                               + n_tr * len(pre) * 4, 3 * 2 * n_tr * nvalid_pre * d, PEAK_TF32_S)
    qt = q.reshape(-1, d)
    gt_docs = (corpus.doc_tokens[:16384], corpus.doc_mask[:16384])
    gt_err = maxsim_err(torch, kmaxsim.token_maxsim(qt, *gt_docs),
                        ref.token_maxsim_ref(qt, *gt_docs, chunk=512))
    print(f"token_maxsim ok at the OLS block ({k_err}; {ms:.3f} ms, bound {b_ms:.3f} ms, "
          f"against fp64 {tc_err}), pre-training rows ({pre_err}) and a ground-truth block "
          f"({gt_err})", flush=True)
    row = dict(name="token_maxsim", route="cuda", source="src/repro_torch/csrc/token_maxsim.cu",
               replaces="src/repro/kernels/maxsim.py:47", launches=launches["token_maxsim"],
               launches_per_build=launches["token_maxsim"], max_abs_err=k_err,
               ragged_max_abs_err=ragged_err, pretrain_rows_max_abs_err=pre_err,
               truth_block_max_abs_err=gt_err,
               tolerance=f"{MAXSIM_RTOL} x max(1, max|plain|); NEG entries equal",
               shape=f"x ({n_ols}, {d}) x docs ({OLS_BLOCK}, {blk[0].shape[1]}, {d})",
               ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               peak=PEAK_TF32_S, bound_split="3xTF32",
               bound_ms_fp32_cuda_cores=bound(nbytes, flops)[0],
               bound_ms_all_positions=b_all_ms, tc_max_abs_err_fp64=tc_err,
               tc_fp64_sample="512 OLS tokens x the block",
               bytes=int(nbytes), flops=int(flops), library_ms=None,
               **cuda_launches(torch, lambda: kmaxsim.token_maxsim(*kargs)),
               pretrain_shape=f"x ({n_tr}, {d}) x docs ({len(pre)}, {blk[0].shape[1]}, {d})",
               pretrain_ms=pre_ms, pretrain_bound_ms=pre_b_ms, pretrain_bound_by=pre_b_by)
    del x_train, pre, pre_docs, qt, gt_docs

    # -- save and load on the card, at full widths over 2,000 docs -----------
    small = MultiVectorCorpus(corpus.doc_tokens[:2000], corpus.doc_mask[:2000],
                              corpus.topics[:2000], corpus.centers)
    r2 = LemurRetriever.build(small, cfg.replace(epochs=1), device="cuda",
                              generator=torch.Generator().manual_seed(args.seed + 1))
    with tempfile.TemporaryDirectory() as tmp:
        r2.save(tmp)
        back = LemurRetriever.load(tmp, device="cuda")
    a, b = index_to_numpy(r2.index, r2.x_ols)[0], index_to_numpy(back.index, back.x_ols)[0]
    require(sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a),
        "save/load: leaves differ")
    s2, i2 = r2.search(q[:64], qm[:64])
    s3, i3 = back.search(q[:64], qm[:64])
    require(torch.equal(i2, i3) and torch.equal(s2, s3), "save/load: search differs")
    print("save/load round trip ok", flush=True)
    # ... and with the residual tier: 4-bit token codec and 4-bit IVF lists
    rcfg = cfg.replace(epochs=1, residual=cfg.residual.replace(enabled=True),
                       ivf=cfg.ivf.replace(residual_bits=4))
    r3 = LemurRetriever.build(small, rcfg, device="cuda",
                              generator=torch.Generator().manual_seed(args.seed + 1))
    require(r3.index.store.residual and r3.index.ann.residual, "residual build: no tier")
    with tempfile.TemporaryDirectory() as tmp:
        r3.save(tmp)
        back3 = LemurRetriever.load(tmp, device="cuda")
    a3, b3 = index_to_numpy(r3.index, r3.x_ols)[0], index_to_numpy(back3.index, back3.x_ols)[0]
    require(sorted(a3) == sorted(b3) and "pages/code_pages" in a3 and all(
        a3[k].dtype == b3[k].dtype and np.array_equal(a3[k], b3[k]) for k in a3),
        "residual save/load: leaves differ")
    s2, i2 = r3.search(q[:64], qm[:64])
    s3, i3 = back3.search(q[:64], qm[:64])
    require(torch.equal(i2, i3) and torch.equal(s2, s3), "residual save/load: search differs")
    print("save/load round trip of the residual tier ok", flush=True)
    del r2, back, r3, back3, small
    nlist, cap = index.ann.nlist, index.ann.capacity
    # the built index's tensors: r's own until a fleet or lifecycle write
    # copies them, then held by nothing
    del index, solver, stats

    # -- the fleet and the lifecycle over the trained index -----------------
    gc.collect()
    torch.cuda.empty_cache()
    # the replicas' copies must be freed when the fleet phase drops them,
    # with Python's cyclic collector off: no cycle through the router holds them
    torch.cuda.synchronize()
    mem_fleet = torch.cuda.memory_allocated()
    gc.disable()
    try:
        fleet = fleet_phase(torch, args, r, corpus, card)
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - mem_fleet
    finally:
        gc.enable()
    add = fleet["add_barrier"]
    grown = (add["memory_after_gib"] - add["memory_before_gib"]) * 2**30
    fleet["memory_left_after_fleet_gib"] = left / 2**30
    require(left <= 0.01 * grown, f"fleet: {left / 2**30:.3f} GiB left after the phase of "
                                  f"{grown / 2**30:.3f} GiB its first add copied")
    online = {"fleet": fleet}
    print(f"fleet ok: {json.dumps(online['fleet'])}", flush=True)
    torch.cuda.empty_cache()
    online["lifecycle"] = lifecycle_phase(torch, args, r, corpus, card)
    print(f"lifecycle ok: {json.dumps(online['lifecycle'])}", flush=True)

    steps = log["steps"]
    line = dict(
        m=m, d=corpus.d, T=corpus.doc_tokens.shape[1], topic_strength=TOPIC_STRENGTH,
        centers=TOPIC_CENTERS, cfg={k: getattr(cfg, k) for k in (
            "d_prime", "m_pretrain", "n_train", "n_ols", "epochs", "batch_size", "lr",
            "grad_clip", "ridge", "query_strategy", "k", "k_prime")},
        seconds=log["seconds"], build_s=build_s, corpus_s=corpus_s, truth_s=truth_s,
        train_steps=steps, steps_per_s=steps / log["seconds"]["train_phi"],
        loss_first=losses[0], loss_last=losses[-1], gram_cond=cond,
        nlist=nlist, cap=cap, nprobe=p.backend.nprobe,
        launches={"token_maxsim": launches["token_maxsim"], "fused_psi": launches["fused_psi"]},
        peak_mem_gib=peak_gib, **recall, latent_recall_floor=floor,
        served_recall_at_floor=recall["recall@10"] >= floor, ivf_lists=lists,
        valid_candidates_per_query=float(n_cand.float().mean()), queries=int(q.shape[0]),
        q_tokens=int(q.shape[1]), W_first_block_err=w_err, W_tol=w_tol,
        feats_err=feats_err, save_load={"m": 2000, "epochs": 1, "leaves": len(a),
                                        "residual_leaves": len(a3)},
        reduced={"m": m, "from": msmarco_docs(),
                 "why": "build holds the dense (m, 80, d) corpus on the card, as the JAX "
                        "build does: 800k docs would be 32.8 GB beside a 2^22-page pool "
                        "(34.4 GB), W and the lists on an 80 GB card"},
        card=card)
    fused_psi_launches = launches["fused_psi"]
    del r, corpus, x_ols, blk, kargs, q, qm
    del cand, truth
    del latent, exact
    gc.collect()
    torch.cuda.empty_cache()
    return line, row, fused_psi_launches, online


# --------------------------------------------------------------------------
# the other search routes: one-launch IVF, exact latent scan, legacy gather
# --------------------------------------------------------------------------

LEGACY_BATCH = 64     # the legacy route gathers (B, 32, 1024, 2048) int8 codes
RECALL_QUERIES = 32   # queries held to exact MaxSim over the whole corpus


def same_topk(torch, got_s, got_i, want_s, want_i, tol, what, exact_ties=True):
    """Scores within tol x max(1, max|plain|) (pads equal), ids equal up to
    near-ties, and with ``exact_ties`` equal exactly wherever the plain
    result has an exact tie (the tie rule: the lower position first; for
    constructed ties of duplicated rows, which score the same bits in both
    versions, not for chance ties of distinct rows, which another sum order
    splits).  Returns (max abs err, near-tie ids, exact ties seen)."""
    fin = torch.isfinite(want_s)
    require(torch.equal(torch.isfinite(got_s), fin) and torch.equal(got_i[~fin], want_i[~fin]),
            f"{what}: pads differ")
    err = float((got_s[fin] - want_s[fin]).abs().max()) if bool(fin.any()) else 0.0
    scale = max(1.0, float(want_s[fin].abs().max())) if bool(fin.any()) else 1.0
    require(err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}")
    diff = got_i != want_i
    gap = torch.where(fin, got_s - want_s, 0.0).abs() / want_s.abs().clamp_min(1.0)
    require(bool((gap[diff] < NEAR_TIE).all()), f"{what}: an id differs without a near-tie")
    tied = torch.zeros_like(diff)
    eq = (want_s[:, 1:] == want_s[:, :-1]) & fin[:, 1:]
    tied[:, 1:] |= eq
    tied[:, :-1] |= eq
    require(not (exact_ties and bool(diff[tied].any())),
            f"{what}: an exact tie broke another way")
    return err, int(diff.sum()), int(tied.sum())


def routes_ragged_case(torch, seed):
    """query_fused, mips_topk and mips_sq8 against their plain versions on
    small ragged inputs: B=1, an empty probed list, k' above the valid slots
    and above the rows, exact ties from duplicated rows and slots, cap and m
    off every tile, a valid mask with holes.  Returns max abs errors."""
    from repro_torch.anns.base import pad_topk, stable_topk
    from repro_torch.anns.quantization import sq8_quant
    from repro_torch.core.model import Psi
    from repro_torch.kernels import fused_psi, gather_scan, mips_sq8, query_fused, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    errs = {}
    # query_fused: B=1, 6 lists of 300 slots (a chunk and a bit), list 2 empty
    d, dp, nlist, cap, Tq = 128, 256, 6, 300, 6
    psi = Psi.init(d, dp, torch.Generator().manual_seed(seed), device=dev)
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    ids = torch.randperm(10 ** 6, generator=g, device=dev)[:nlist * cap]
    ids = ids.reshape(nlist, cap).int()
    ids[:, 200:] = -1
    ids[2] = -1
    vecs = torch.randn(nlist, cap, dp, generator=g, device=dev) * (ids >= 0)[..., None]
    vecs[3, 5] = vecs[0, 0]                       # exact ties across lists
    vecs[0, 199] = vecs[0, 0]
    q = torch.nn.functional.normalize(torch.randn(1, Tq, d, generator=g, device=dev), dim=-1)
    qm = torch.tensor([[True, True, True, False, True, False]], device=dev)
    probe = torch.tensor([[3, 2, 0, 5]], dtype=torch.int32, device=dev)
    for sq8 in (False, True):
        lists = list(sq8_quant(vecs)) if sq8 else [vecs]
        args = (q, qm, *w, probe, ids, *lists)
        kp = 1000                                 # > the 600 valid slots probed
        got = query_fused.query_fused(*args, kp=kp)
        want = ref.query_fused_ref(*args, kp=kp)
        err, _, ties = same_topk(torch, *got, *want, SQ8_RTOL if sq8 else 1e-4,
                                 "query_fused ragged")
        require(ties >= 2, "query_fused ragged: no exact tie")
        # the default route's kernels on the same query: the same bits
        psi_q = fused_psi.fused_psi_pool(q, qm, *w)
        sc = gather_scan.ivf_probe_scan(psi_q, probe, ids, *lists).reshape(1, -1)
        top, pos = stable_topk(sc, sc.shape[1])
        top, kid = pad_topk(top, torch.gather(ids[probe.long()].reshape(1, -1), 1, pos), kp)
        require(torch.equal(got[0], top) and torch.equal(got[1], kid),
                "query_fused ragged: differs from psi-pool + scan + stable top-k")
        errs[f"query_fused_{'sq8' if sq8 else 'fp32'}"] = err
    # mips_topk: m = 1500 off the 512-row tile, integer rows (exact sums),
    # duplicated rows, a quarter of the rows invalid, k' above both
    for B, kp in ((1, 1200), (9, 1600)):
        qi = torch.randint(-3, 4, (B, 64), generator=g, device=dev).float()
        W = torch.randint(-3, 4, (1500, 64), generator=g, device=dev).float()
        W[750], W[1499] = W[500], W[0]
        valid = torch.rand(1500, generator=g, device=dev) > 0.25
        got = query_fused.mips_topk(qi, W, None, valid, kp=kp)
        want = ref.mips_topk_ref(qi, W, None, valid, kp=kp)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"mips_topk ragged (B={B}, kp={kp}): differs from plain")
        codes, scales = sq8_quant(W)
        got = query_fused.mips_topk(qi, codes, scales, valid, kp=kp)
        want = ref.mips_topk_ref(qi, codes, scales, valid, kp=kp)
        err, _, _ = same_topk(torch, *got, *want, SQ8_RTOL, "mips_topk sq8 ragged")
        errs["mips_topk"] = max(errs.get("mips_topk", 0.0), err)
    # mips_sq8: batched B=1 x 300 rows (off the 128-row tile); all pairs
    # 9 x 1100 (off the 8 x 512 tile), a duplicated row
    qs = torch.randn(9, 2048, generator=g, device=dev)
    codes = torch.randint(-127, 128, (9, 1100, 2048), generator=g, device=dev).to(torch.int8)
    scales = torch.rand(9, 1100, generator=g, device=dev) + 0.1
    codes[:, 7], scales[:, 7] = codes[:, 3], scales[:, 3]
    a = mips_sq8.mips_sq8_batched(qs[:1], codes[:1, :300], scales[:1, :300])
    b = ref.mips_sq8_batched_ref(qs[:1], codes[:1, :300], scales[:1, :300])
    e1 = float((a - b).abs().max())
    flat_c, flat_s = codes[0], scales[0]
    a = mips_sq8.mips_sq8(qs, flat_c, flat_s)
    b = ref.mips_sq8_ref(qs, flat_c, flat_s)
    require(torch.equal(a[:, 7], a[:, 3]), "mips_sq8 ragged: equal rows score apart")
    e2 = float((a - b).abs().max())
    scale = max(1.0, float(b.abs().max()))
    require(max(e1, e2) <= SQ8_RTOL * scale, f"mips_sq8 ragged errors {e1} {e2}")
    errs["mips_sq8"] = max(e1, e2)
    return errs


def latent_edge(lat_s):
    """Per row of a plain latent top-k' (B, k'): the k'-th score and the
    scale of the near-tie test, max(1, the largest |score| that is not
    NEG)."""
    from repro_torch.kernels import ref

    real = lat_s.masked_fill(lat_s <= ref.NEG / 2, 0.0)
    return dict(edge=lat_s[:, -1].clone(), lat_scale=real.abs().amax(1).clamp_min(1.0))


def classify_exact(torch, W, W_scales, port_ids, port_scores, port_cand, plain):
    """Rows of an exact-scan route whose ids differ from the plain
    composition must differ by a near-tie at the k' boundary of the plain
    latent scores (each candidate only one side has scores within NEAR_TIE
    of the k'-th; SQ8 rows through their scales), or in the final ranking.
    ``port_cand`` (rows of W, -1 ignored) may be None when no row differs.
    Returns counts by kind; raises otherwise."""
    kinds = {"candidates": 0, "final": 0}
    bad = (port_ids != plain["ids"]).any(1).nonzero().flatten().tolist()
    if bad and port_cand is None:
        raise CheckFailed("rows differ but no candidates were given")
    for b in bad:
        qa = set(port_cand[b].tolist()) - {-1}
        qb = set(plain["cand"][b].tolist()) - {-1}
        if qa != qb:
            edge, scale = float(plain["edge"][b]), float(plain["lat_scale"][b])
            for c in qa ^ qb:
                sc = float(plain["psi_q"][b] @ W[c].float()) * (
                    1.0 if W_scales is None else float(W_scales[c]))
                require(abs(sc - edge) <= NEAR_TIE * scale,
                        f"row {b}: candidate {c} differs without a near-tie")
            kinds["candidates"] += 1
            continue
        sa, sb = port_scores[b], plain["scores"][b]
        require(bool(near(sa, sb, max(1.0, float(sb.abs().max()))).all()),
                f"row {b}: final ranking differs without a near-tie")
        kinds["final"] += 1
    return kinds


def truth_top10(torch, store, q, qm):
    """Exact MaxSim top-10 over every live doc (the token kernel over docs
    gathered from the pages, 16,384 at a time)."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.core import pages
    from repro_torch.kernels import ops

    m = int(store.n_docs[0])
    dev = q.device
    scores = torch.empty((q.shape[0], m), dtype=torch.float32, device=dev)
    for s in range(0, m, 16384):
        ids = torch.arange(s, min(m, s + 16384), dtype=torch.int32, device=dev)
        toks, tmask = pages.gather_docs(store, ids)
        scores[:, s:s + len(ids)] = ops.maxsim_scores(q, qm, toks, tmask)
    scores[:, ~store.alive[:m]] = float("-inf")
    return stable_topk(scores, 10)[1].int()


def routes_phase(torch, args, r, batches, plains, default_ids):
    """Each other route on the served index, counters from 0 just before it
    and read just after; each batch held against the plain composition and
    its scores against exact MaxSim.  Returns the routes line and the exact
    top-10 of the recall queries."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.core import maxsim
    from repro_torch.core.model import pool_queries
    from repro_torch.kernels import ops, query_fused, ref
    from repro_torch.retriever import IVFSearchParams, SearchParams
    from repro_torch.retriever.facade import first_stage

    index, st = r.index, r.index.store
    legacy = SearchParams(use_fused_gather=False,
                          backend=IVFSearchParams(use_fused_gather=False))
    routes = {   # name: (params, batch, kernels launched once a search)
        "one_launch_ivf": (SearchParams(backend=IVFSearchParams(use_one_launch=True)),
                           args.batch, ("fused_psi_pool", "query_fused", "rerank_paged_scores")),
        "exact_one_launch": (SearchParams(use_ann=False, use_one_launch=True), args.batch,
                             ("fused_psi_pool", "mips_topk", "rerank_paged_scores")),
        "exact_blocked": (SearchParams(use_ann=False), args.batch,
                          ("fused_psi_pool", "rerank_paged_scores")),
        "legacy_gathered": (legacy, LEGACY_BATCH, ("fused_psi_pool", "mips_sq8")),
        # above the old card caps (one-launch IVF 2,048, the exact scan 4,096)
        "one_launch_ivf_kp4096": (SearchParams(k_prime=4096, backend=IVFSearchParams(
            use_one_launch=True)), args.batch,
            ("fused_psi_pool", "query_fused", "rerank_paged_scores")),
        "exact_one_launch_kp8192": (SearchParams(use_ann=False, use_one_launch=True,
                                                 k_prime=8192), args.batch,
                                    ("fused_psi_pool", "mips_topk", "rerank_paged_scores")),
    }
    nq = RECALL_QUERIES
    q1, qm1, _ = batches[1]
    t0 = time.time()
    truth = truth_top10(torch, st, q1[:nq], qm1[:nq])
    torch.cuda.synchronize()
    line = {"recall_queries": nq, "truth_s": time.time() - t0,
            "default_ivf": {"recall_at_10": float(maxsim.recall_at(default_ids[1][:nq, :10],
                                                                truth).mean())}}
    p0 = r.resolve(SearchParams())
    for name, (params, B, kernels) in routes.items():
        p = r.resolve(params)
        bs = batches if p.k_prime == p0.k_prime else batches[:KP_BATCHES]
        ops.reset_launch_counts()
        rescans = query_fused.mips_topk.rescans
        lat, outs = [], []
        for i, (q, qm, _) in enumerate(bs):
            q, qm = q[:B], qm[:B]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, ids = r.search(q, qm, params)
            torch.cuda.synchronize()
            if i:
                lat.append(time.perf_counter() - t0)
            outs.append((s, ids))
        launches = ops.launch_counts()
        want = {k: (len(bs) if k in kernels else 0) for k in launches}
        require(launches == want, f"route {name}: launches {launches}, expected {want}")
        rescans = query_fused.mips_topk.rescans - rescans
        require(rescans == 0, f"route {name}: mips_topk rescanned {rescans} times")
        ties = {}
        differ = 0
        for i, ((q, qm, _), (s, ids)) in enumerate(zip(bs, outs)):
            q, qm = q[:B], qm[:B]
            require(s.shape == (B, p.k) and bool(torch.isfinite(s).all())
                    and bool((ids >= 0).all()), f"route {name}: scores or ids malformed")
            require(bool(st.alive[ids.long()].all()), f"route {name}: a tombstoned doc")
            cand = first_stage(index, q, qm, p)
            if p.use_ann and p.k_prime != p0.k_prime:
                plain = plain_search(torch, index, q, qm, p)
                probe = stable_topk(pool_queries(index.psi, q, qm) @ index.ann.centroids.T,
                                    p.backend.nprobe)[1].int()
                kinds = classify_rows(torch, ids, s, plain, {"probe": probe, "cand": cand},
                                      p.k_prime)
                del plain
            elif p.use_ann:
                plain = {k: v[:B] for k, v in plains[i].items()}
                probe = stable_topk(pool_queries(index.psi, q, qm) @ index.ann.centroids.T,
                                    p.backend.nprobe)[1].int()
                kinds = classify_rows(torch, ids, s, plain, {"probe": probe, "cand": cand},
                                      p.k_prime)
                differ += int((ids != default_ids[i][:B]).any(1).sum())
            else:
                plain = exact_plain(torch, index, q, qm, p)
                kinds = classify_exact(torch, st.W, None, ids, s, cand, plain)
            for kk, v in kinds.items():
                ties[kk] = ties.get(kk, 0) + v
            exact = ref.rerank_scores_paged_ref(q, qm, ids, st.tok_pages, st.page_table,
                                                st.n_tokens, chunk=32)
            torch.testing.assert_close(s, exact, rtol=1e-5, atol=1e-4)
            require(bool((s[:, :-1] >= s[:, 1:]).all()), f"route {name}: scores not sorted")
        lat_ms = [1e3 * x for x in lat]
        q, qm, _ = bs[1]
        per_search = search_launches(torch, launches, len(bs),
                                     lambda: r.search(q[:B], qm[:B], params))
        require(per_search["psi_kernel_launches_traced"] <= 1,
                f"route {name}: the psi kernel ran more than once in a search")
        line[name] = dict(
            params=repr(params), batch=B, batches=len(lat), p50_ms=float(np.median(lat_ms)),
            max_ms=float(np.max(lat_ms)), qps=B * len(lat) / sum(lat), k_prime=p.k_prime,
            launches={k: v for k, v in launches.items() if v}, **per_search,
            near_tie_rows=ties, rows_checked=B * len(bs), mips_topk_rescans=rescans,
            recall_at_10=float(maxsim.recall_at(outs[1][1][:nq, :10], truth).mean()))
        if p.use_ann and p.k_prime == p0.k_prime:
            line[name]["rows_differing_from_default"] = differ
        print(f"route {name} ok: p50 {line[name]['p50_ms']:.3f} ms, "
              f"near-tie rows {ties}", flush=True)
        del outs
    return line, truth


def route_kernel_rows(torch, r, batches, launches_by_kernel, ragged):
    """The three new kernels at the served shapes against their plain
    versions, timed beside them and beside the nearest PyTorch call."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.anns.quantization import sq8_dequant, sq8_quant
    from repro_torch.core.model import pool_queries
    from repro_torch.kernels import mips_sq8, query_fused, ref

    index, st, ann = r.index, r.index.store, r.index.ann
    psi = index.psi
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    q, qm, _ = batches[1]
    B, Tq, d = q.shape
    dp, cap, kp, P = st.d_prime, ann.capacity, 1024, 32
    psi_q = pool_queries(psi, q, qm)
    rows = []

    def row(name, variant, source, replaces, err, tol, fn, plain_fn, lib_fn, nbytes, flops,
            shape, n=20, ragged_key=None, peak=PEAK_FP32_S, **extra):
        ms = time_ms(torch, fn, n=n)
        plain_ms = time_ms(torch, plain_fn, n=max(3, n // 4), warmup=1)
        lib_ms = time_ms(torch, lib_fn, n=n) if lib_fn else None
        b_ms, b_by = bound(nbytes, flops, peak)
        rows.append(dict(
            name=name, variant=variant, route="cuda", source=source, replaces=replaces,
            launches=launches_by_kernel[name], max_abs_err=err,
            ragged_max_abs_err=ragged[ragged_key or name], tolerance=tol, shape=shape,
            ms=ms, kernel_ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=int(nbytes),
            flops=int(flops), library_ms=lib_ms, **cuda_launches(torch, fn), **extra))
        print(f"{name} ({variant}): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}), library {lib_ms}", flush=True)

    # query_fused, SQ8 lists at the served shape
    probe = stable_topk(psi_q @ ann.centroids.T, P)[1].int()
    # the kernel as the route calls it: on the probe selection's latent,
    # held against the plain composition from the tokens
    qargs = (q, qm, *w, probe, ann.ids, ann.vecs, ann.scales)
    err, near_ties, _ = same_topk(torch, *query_fused.query_fused(*qargs, kp=kp, latent=psi_q),
                                  *ref.query_fused_ref(*qargs, kp=kp, chunk=4),
                                  SQ8_RTOL, "query_fused sq8", exact_ties=False)
    uniq = probe.long().unique()
    rows_u, rows_p = int(ann.counts[uniq].sum()), int(ann.counts[probe.long()].sum())
    row("query_fused", "sq8", "src/repro_torch/csrc/query_fused.cu",
        "src/repro/kernels/query_fused.py:193", err, f"{SQ8_RTOL} x max(1, max|plain|)",
        lambda: query_fused.query_fused(*qargs, kp=kp, latent=psi_q),
        lambda: ref.query_fused_ref(*qargs, kp=kp, chunk=4, latent=psi_q), None,
        psi_q.numel() * 4 + len(uniq) * cap * 4 + rows_u * (dp + 4) + probe.numel() * 4
        + 2 * B * kp * 4, 2 * rows_p * dp,
        f"B {B} x Tq {Tq}, nprobe {P} of {ann.nlist} lists of cap {cap} int8, "
        f"{rows_p / B:.0f} rows scanned a query, k' {kp}", near_tie_ids=near_ties,
        ragged_key="query_fused_sq8",
        launches_per_search=launches_by_kernel["query_fused"] // len(batches),
        bound_counted=QF_BOUND_COUNTED, **scan_spread(torch, probe, ann.ids))
    # ... and fp32 lists: the first 256 lists dequantized (2.1 GB)
    L = 256
    vec32 = sq8_dequant(ann.vecs[:L], ann.scales[:L]).contiguous()
    ids32 = ann.ids[:L].contiguous()
    probe32 = stable_topk(psi_q @ ann.centroids[:L].T, P)[1].int()
    fargs = (q, qm, *w, probe32, ids32, vec32)
    err, near_ties, _ = same_topk(torch, *query_fused.query_fused(*fargs, kp=kp, latent=psi_q),
                                  *ref.query_fused_ref(*fargs, kp=kp, chunk=8), 1e-4,
                                  "query_fused fp32", exact_ties=False)
    uniq = probe32.long().unique()
    rows_u, rows_p = int(ann.counts[uniq].sum()), int(ann.counts[probe32.long()].sum())
    row("query_fused", "fp32", "src/repro_torch/csrc/query_fused.cu",
        "src/repro/kernels/query_fused.py:193", err, "1e-4 x max(1, max|plain|)",
        lambda: query_fused.query_fused(*fargs, kp=kp, latent=psi_q),
        lambda: ref.query_fused_ref(*fargs, kp=kp, chunk=8, latent=psi_q), None,
        psi_q.numel() * 4 + len(uniq) * cap * 4 + rows_u * dp * 4 + probe32.numel() * 4
        + 2 * B * kp * 4, 2 * rows_p * dp,
        f"B {B} x Tq {Tq}, nprobe {P} of a reduced set of {L} fp32 lists of cap {cap} "
        f"({vec32.numel() * 4 / 1e9:.2f} GB: the index's first {L} lists dequantized), "
        f"{rows_p / B:.0f} rows scanned a query, k' {kp}", near_tie_ids=near_ties,
        ragged_key="query_fused_fp32",
        launches_per_search=launches_by_kernel["query_fused"] // len(batches),
        bound_counted=QF_BOUND_COUNTED, **scan_spread(torch, probe32, ids32))
    del vec32, ids32, fargs

    # mips_topk over W's full slot capacity, fp32 and SQ8: the tensor-core
    # product's error against an fp64 product (the first 65,536 rows), the
    # sample's scores against the full pass's bit for bit, no rescan
    C = st.W.shape[0]
    live = int(st.alive.sum())
    valid = st.alive
    codes = torch.empty(st.W.shape, dtype=torch.int8, device=st.W.device)
    wsc = torch.empty((C,), dtype=torch.float32, device=st.W.device)
    for s0 in range(0, C, 65536):
        codes[s0:s0 + 65536], wsc[s0:s0 + 65536] = sq8_quant(st.W[s0:s0 + 65536])
    checks = {}
    for variant, Wv, sv in (("fp32", st.W, None), ("sq8", codes, wsc)):
        full = query_fused.tc_scores(psi_q, Wv, sv, valid)
        sample = query_fused.tc_scores(psi_q, Wv, sv, valid, stride=query_fused.SAMPLE_STRIDE)
        require(torch.equal(sample, full[:, ::query_fused.SAMPLE_STRIDE]),
                f"mips_topk {variant}: the sampled rows score apart from the full pass")
        n64 = 65536
        ex = psi_q.double() @ Wv[:n64].double().T
        if sv is not None:
            ex = ex * sv[:n64].double()[None, :]
        ok = valid[:n64]
        split_err = float((full[:, :n64][:, ok].double() - ex[:, ok]).abs().max())
        scale = max(1.0, float(ex[:, ok].abs().max()))
        require(split_err <= ref.TF32_SPLIT_RTOL * scale,
                f"mips_topk {variant}: split product error {split_err} > "
                f"{ref.TF32_SPLIT_RTOL} x {scale}")
        checks[variant] = dict(sample_bits_equal=True, split_max_abs_err_vs_fp64=split_err,
                               split_tolerance=ref.TF32_SPLIT_RTOL * scale)
        del full, sample, ex
    rescans = query_fused.mips_topk.rescans
    margs = (psi_q, st.W, None, valid)
    err, near_ties, _ = same_topk(torch, *query_fused.mips_topk(*margs, kp=kp),
                                  *ref.mips_topk_ref(*margs, kp=kp, chunk=32), 1e-4,
                                  "mips_topk fp32", exact_ties=False)
    shape = (f"B {B} x {C} slots ({live} live) x d' {dp}, k' {kp}; bound counts the "
             f"live rows")
    cuda_bound = bound(psi_q.numel() * 4 + live * dp * 4 + C + 2 * B * kp * 4,
                       2 * B * live * dp)[0]
    row("mips_topk", "fp32", "src/repro_torch/csrc/query_fused.cu",
        "src/repro/kernels/query_fused.py:354", err, "1e-4 x max(1, max|plain|)",
        lambda: query_fused.mips_topk(*margs, kp=kp),
        lambda: ref.mips_topk_ref(*margs, kp=kp, chunk=32),
        lambda: torch.topk(psi_q @ st.W.T, kp),
        psi_q.numel() * 4 + live * dp * 4 + C + 2 * B * kp * 4, 3 * 2 * B * live * dp, shape,
        n=10, near_tie_ids=near_ties, peak=PEAK_TF32_S, bound_split="3xTF32",
        bound_ms_fp32_cuda_cores=cuda_bound, product_checks=checks["fp32"],
        launches_per_search=launches_by_kernel["mips_topk"] // len(batches))
    sargs = (psi_q, codes, wsc, valid)
    err, near_ties, _ = same_topk(torch, *query_fused.mips_topk(*sargs, kp=kp),
                                  *ref.mips_topk_ref(*sargs, kp=kp, chunk=32), SQ8_RTOL,
                                  "mips_topk sq8", exact_ties=False)
    row("mips_topk", "sq8", "src/repro_torch/csrc/query_fused.cu",
        "src/repro/kernels/query_fused.py:354", err, f"{SQ8_RTOL} x max(1, max|plain|)",
        lambda: query_fused.mips_topk(*sargs, kp=kp),
        lambda: ref.mips_topk_ref(*sargs, kp=kp, chunk=32),
        lambda: torch.topk((psi_q @ codes.float().T) * wsc, kp),
        psi_q.numel() * 4 + live * (dp + 4) + C + 2 * B * kp * 4, 2 * 2 * B * live * dp,
        shape + ", W quantized by sq8_quant (the sharded path's layout)",
        n=10, near_tie_ids=near_ties, peak=PEAK_TF32_S, bound_split="2xTF32 (q split)",
        bound_ms_fp32_cuda_cores=bound(psi_q.numel() * 4 + live * (dp + 4) + C
                                       + 2 * B * kp * 4, 2 * B * live * dp)[0],
        product_checks=checks["sq8"],
        launches_per_search=launches_by_kernel["mips_topk"] // len(batches))
    rescans = query_fused.mips_topk.rescans - rescans
    require(rescans == 0, f"mips_topk rescanned {rescans} times at the served shape")
    # the library call at the sharded route's k'_loc on the same (2^20 x d')
    # int8 rows, for its row in the sharded phase (no room for the widened
    # copy beside the SQ8 block there)
    rows[-1]["library_ms_kp4096"] = time_ms(
        torch, lambda: torch.topk((psi_q @ codes.float().T) * wsc, 4096), n=5)
    rows[-1]["library_kp4096_shape"] = f"B {B} x {C} rows x d' {dp} int8, k' 4096"
    del codes, wsc, sargs

    # mips_sq8: the legacy route's batched strips, and all pairs
    Bl = LEGACY_BATCH
    probe_l = probe[:Bl].long()
    gcodes = ann.vecs[probe_l].reshape(Bl, -1, dp)
    gsc = ann.scales[probe_l].reshape(Bl, -1)
    ql = psi_q[:Bl].contiguous()
    got, want = mips_sq8.mips_sq8_batched(ql, gcodes, gsc), ref.mips_sq8_batched_ref(
        ql, gcodes, gsc, chunk=2)
    err = float((got - want).abs().max())
    require(err <= SQ8_RTOL * max(1.0, float(want.abs().max())), f"mips_sq8 batched err {err}")
    n = gcodes.shape[1]
    row("mips_sq8", "batched strips", "src/repro_torch/csrc/mips_sq8.cu",
        "src/repro/kernels/mips_sq8.py:38", err, f"{SQ8_RTOL} x max(1, max|plain|)",
        lambda: mips_sq8.mips_sq8_batched(ql, gcodes, gsc),
        lambda: ref.mips_sq8_batched_ref(ql, gcodes, gsc, chunk=2),
        lambda: (gcodes.float() @ ql[:, :, None]).squeeze(-1) * gsc,
        Bl * n * (dp + 4) + ql.numel() * 4 + Bl * n * 4, 2 * Bl * n * dp,
        f"B {Bl} x {n} gathered rows (nprobe {P} x cap {cap}) x {dp} int8",
        library_call="(codes.float() @ q[:, :, None]).squeeze(-1) * scales",
        launches_per_search=launches_by_kernel["mips_sq8"] // len(batches))
    del gcodes, gsc
    pc = ann.vecs[:32].reshape(-1, dp)
    ps = ann.scales[:32].reshape(-1)
    got, want = mips_sq8.mips_sq8(psi_q, pc, ps), ref.mips_sq8_ref(psi_q, pc, ps)
    err = float((got - want).abs().max())
    require(err <= SQ8_RTOL * max(1.0, float(want.abs().max())), f"mips_sq8 pairs err {err}")
    row("mips_sq8", "all pairs", "src/repro_torch/csrc/mips_sq8.cu",
        "src/repro/kernels/mips_sq8.py:38", err, f"{SQ8_RTOL} x max(1, max|plain|)",
        lambda: mips_sq8.mips_sq8(psi_q, pc, ps), lambda: ref.mips_sq8_ref(psi_q, pc, ps),
        lambda: (psi_q @ pc.float().T) * ps,
        pc.numel() + ps.numel() * 4 + psi_q.numel() * 4 + B * pc.shape[0] * 4,
        2 * 2 * B * pc.shape[0] * dp,
        f"B {B} x {pc.shape[0]} rows (the first 32 lists) x {dp} int8; this entry runs "
        f"on no route (launches: the kernel's, from the legacy route's batched entry)",
        peak=PEAK_TF32_S, bound_split="2xTF32 (q split)",
        bound_ms_fp32_cuda_cores=bound(pc.numel() + ps.numel() * 4 + psi_q.numel() * 4
                                       + B * pc.shape[0] * 4, 2 * B * pc.shape[0] * dp)[0])
    return rows


# --------------------------------------------------------------------------
# the residual tier: codec, compressed pages, residual lists
# --------------------------------------------------------------------------

RES_SCAN_RTOL = 1e-5   # residual scans: x max(1, max|plain|) (another sum order)
RES_ROUTES = {   # name: (IVF params, k' or None, kernels launched once a search)
    "residual_default": ({}, None, ("fused_psi_pool", "ivf_probe_res_scan",
                                    "rerank_paged_res_scores")),
    "residual_one_launch": ({"use_one_launch": True}, None,
                            ("fused_psi_pool", "query_fused_res", "rerank_paged_res_scores")),
    # above the old card cap of the one-launch kernels (2,048)
    "residual_one_launch_kp4096": ({"use_one_launch": True}, 4096,
                                   ("fused_psi_pool", "query_fused_res",
                                    "rerank_paged_res_scores")),
}


def residual_ragged_case(torch, seed):
    """ivf_probe_res_scan, query_fused_res and rerank_paged_res_scores
    against their plain versions on small ragged inputs at 2 and 4 bits:
    B=1, an empty probed list, k' above the valid slots, a doc with no
    tokens, duplicated rows and candidates (exact ties), cap and d' off
    every tile (300 slots, d' = 1008).  Returns max abs errors by kernel."""
    from repro_torch.anns.base import pad_topk, stable_topk
    from repro_torch.anns.quantization import train_residual_codec
    from repro_torch.core import pages
    from repro_torch.core.model import Psi
    from repro_torch.kernels import fused_psi, gather_scan, query_fused, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    errs = {"ivf_probe_res_scan": 0.0, "query_fused_res": 0.0, "rerank_paged_res_scores": 0.0}
    d, dp, nlist, cap, Tq = 128, 1008, 6, 300, 6
    psi = Psi.init(d, dp, torch.Generator().manual_seed(seed), device=dev)
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    ids = torch.randperm(10 ** 6, generator=g, device=dev)[:nlist * cap]
    ids = ids.reshape(nlist, cap).int()
    ids[:, 200:] = -1
    ids[2] = -1
    q = torch.nn.functional.normalize(torch.randn(1, Tq, d, generator=g, device=dev), dim=-1)
    qm = torch.tensor([[True, True, True, False, True, False]], device=dev)
    probe = torch.tensor([[3, 2, 0, 5]], dtype=torch.int32, device=dev)
    cent = torch.randn(nlist, dp, generator=g, device=dev)
    psi_q = fused_psi.fused_psi_pool(q, qm, *w)
    m, T = 40, 37
    tok = torch.nn.functional.normalize(torch.randn(m, T, d, generator=g, device=dev), dim=-1)
    mask = torch.rand(m, T, generator=g, device=dev) > 0.5
    mask[3] = False
    cand = torch.tensor([[-1, 3, 0, 7, -1, 12, 39, 12]], dtype=torch.int32, device=dev)
    for bits in (2, 4):
        values = torch.randn(dp, 1 << bits, generator=g, device=dev).sort(dim=1).values
        codes = torch.randint(0, 256, (nlist, cap, dp * bits // 8), generator=g,
                              device=dev).to(torch.uint8)
        codes[3, 5] = codes[3, 0]                 # exact ties within a list
        codes[0, 199] = codes[0, 0]
        codes *= (ids >= 0)[..., None].to(torch.uint8)
        lists = (ids, codes, cent, values)
        a = gather_scan.ivf_probe_res_scan(psi_q, probe, *lists)
        b = ref.ivf_scan_res_ref(psi_q, probe, *lists)
        fin = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), fin), f"ragged residual scan ({bits} bits): pads")
        err = float((a[fin] - b[fin]).abs().max())
        require(err <= RES_SCAN_RTOL * max(1.0, float(b[fin].abs().max())),
                f"ragged residual scan ({bits} bits): max abs err {err}")
        errs["ivf_probe_res_scan"] = max(errs["ivf_probe_res_scan"], err)
        kp = 1000                                 # > the 600 valid slots probed
        got = query_fused.query_fused_res(q, qm, *w, probe, *lists, kp=kp)
        want = ref.query_fused_res_ref(q, qm, *w, probe, *lists, kp=kp)
        err, _, ties = same_topk(torch, *got, *want, 1e-4, f"query_fused_res ragged ({bits} bits)")
        require(ties >= 2, "query_fused_res ragged: no exact tie")
        errs["query_fused_res"] = max(errs["query_fused_res"], err)
        top, pos = stable_topk(a.reshape(1, -1), a.numel())
        top, kid = pad_topk(top, torch.gather(ids[probe.long()].reshape(1, -1), 1, pos), kp)
        require(torch.equal(got[0], top) and torch.equal(got[1], kid),
                "query_fused_res ragged: differs from psi-pool + residual scan + stable top-k")
        codec = train_residual_codec(torch.Generator().manual_seed(seed), tok[mask], bits=bits,
                                     ncent=16, iters=3)
        store, _ = pages.from_dense(torch.randn(m, 8, generator=g, device=dev), tok, mask,
                                    codec=codec)
        args = (q, qm, cand, store.cent_pages, store.code_pages, store.page_table,
                store.n_tokens, codec.centroids, codec.values)
        a = gather_scan.rerank_paged_res_scores(*args)
        b = ref.rerank_scores_paged_res_ref(*args)
        real = b > ref.NEG / 2            # pads and the empty doc score 4 * NEG
        require(bool(((a[~real] - b[~real]).abs() <= 1e-6 * b[~real].abs()).all()),
                "ragged residual rerank: NEG-scale scores differ")
        require(bool(a[0, 5] == a[0, 7]), "ragged residual rerank: a repeated doc scores apart")
        err = float((a[real] - b[real]).abs().max())
        require(err <= 1e-4 + 1e-5 * float(b[real].abs().max()),
                f"ragged residual rerank ({bits} bits): max abs err {err}")
        errs["rerank_paged_res_scores"] = max(errs["rerank_paged_res_scores"], err)
    return errs


def residual_store(torch, args, store, codec):
    """The compressed tier of the served corpus: each chunk of docs read back
    from the fp32 pages and encoded into a store of its own (held to
    ``from_dense(codec=)`` on the first 500 docs), its pages in slot order;
    W and the tombstones are the fp32 store's, since the tiers differ only
    in their pages."""
    from repro_torch.core import pages

    m = int(store.n_docs[0])
    rstore = pages.allocate(m, store.n_pages, store.pages_per_doc, store.d, 0,
                            device=store.W.device, codec=codec)
    page = 0
    for s in range(0, m, DOC_CHUNK):
        e = min(s + DOC_CHUNK, m)
        toks, tmask = pages.gather_docs(store, torch.arange(s, e, device=store.W.device))
        page += pages.write_docs(rstore, s, page, store.W[s:e, :0], toks, tmask)
        if s == 0:
            k = min(500, e)
            ref_store, _ = pages.from_dense(store.W[:k, :0], toks[:k], tmask[:k], codec=codec)
            np_ = int(pages.pages_needed(store.n_tokens[:k]).sum())
            require(torch.equal(ref_store.cent_pages[:np_], rstore.cent_pages[:np_])
                    and torch.equal(ref_store.code_pages[:np_], rstore.code_pages[:np_])
                    and torch.equal(ref_store.page_table[:k], rstore.page_table[:k]),
                    "chunked compressed fill differs from pages.from_dense(codec=)")
            del ref_store
        del toks, tmask
    require(torch.equal(rstore.n_tokens, store.n_tokens),
            "the compressed tier holds other token counts than the fp32 tier")
    return rstore._replace(W=store.W, alive=store.alive)


def train_codec(torch, args, store, rcfg):
    """The token codec of ``rcfg`` over ``train_sample`` valid tokens drawn
    from the pages -> (codec, sample)."""
    from repro_torch.anns.quantization import train_residual_codec

    m, dev = int(store.n_docs[0]), store.W.device
    gen = torch.Generator().manual_seed(args.seed + 5)
    nt = store.n_tokens[:m].long()
    flat = torch.randperm(int(nt.sum()), generator=gen)[:rcfg.train_sample].to(dev)
    ends = torch.cumsum(nt, 0)
    doc = torch.searchsorted(ends, flat, right=True)
    pos = flat - (ends - nt)[doc]
    sample = store.tok_pages[store.page_table[doc, pos // 16].long(), pos % 16]
    codec = train_residual_codec(gen, sample, bits=rcfg.bits, ncent=rcfg.ncent,
                                 iters=rcfg.kmeans_iters, sample=rcfg.train_sample)
    return codec, sample


def residual_phase(torch, args, r, batches, truth, sq8_recall, ragged):
    """Build the residual tier beside the served fp32/SQ8 index at full
    width, serve the same batches through the residual default and
    one-launch routes (counters from 0 around each), check every batch,
    then time the three kernels.  Returns (residual line, kernel rows)."""
    import dataclasses

    from repro_torch.anns.base import stable_topk
    from repro_torch.anns.ivf import build_ivf
    from repro_torch.anns.params import ResidualConfig
    from repro_torch.core import maxsim, pages
    from repro_torch.core.model import pool_queries
    from repro_torch.kernels import gather_scan, ops, query_fused, ref
    from repro_torch.retriever import IVFSearchParams, LemurRetriever, SearchParams
    from repro_torch.retriever.facade import first_stage

    index, store, ann = r.index, r.index.store, r.index.ann
    m = int(store.n_docs[0])
    rcfg = ResidualConfig()
    torch.cuda.synchronize()
    t0 = time.time()
    codec, sample = train_codec(torch, args, store, rcfg)
    torch.cuda.synchronize()
    t_codec = time.time() - t0
    t0 = time.time()
    rstore = residual_store(torch, args, store, codec)
    require(torch.equal(rstore.page_table, store.page_table),
            "the compressed tier's pages are not laid out as the fp32 tier's")
    torch.cuda.synchronize()
    t_pages = time.time() - t0
    t0 = time.time()
    rann = build_ivf(store.W[:m], ann.nlist, residual_bits=4, centroids=ann.centroids)
    torch.cuda.synchronize()
    t_lists = time.time() - t0
    require(torch.equal(rann.ids, ann.ids), "the residual lists hold other rows than the SQ8 lists")
    cfg = r.cfg.replace(residual=dataclasses.replace(rcfg, enabled=True),
                        ivf=r.cfg.ivf.replace(residual_bits=4))
    rr = LemurRetriever(index._replace(cfg=cfg, store=rstore, ann=rann))
    print(f"residual tier: codec {t_codec:.1f} s, pages {t_pages:.1f} s, lists {t_lists:.1f} s",
          flush=True)

    nq = RECALL_QUERIES
    line = dict(codec=dict(bits=codec.bits, ncent=codec.ncent, sample=int(sample.shape[0]),
                           kmeans_iters=rcfg.kmeans_iters),
                list_bits=4, codec_s=t_codec, pages_s=t_pages, lists_s=t_lists,
                sq8_default_recall_at_10=sq8_recall,
                token_bytes_per_doc={"fp32": pages.token_bytes(store) / m,
                                     "residual": pages.token_bytes(rstore) / m},
                list_bytes={"sq8": sum(t.numel() * t.element_size() for t in
                                       (ann.ids, ann.vecs, ann.scales)),
                            "residual": sum(t.numel() * t.element_size() for t in
                                            (rann.ids, rann.vecs, rann.rq_cuts,
                                             rann.rq_values))})
    del sample
    plains = {}
    outs_by_route = {}
    for name, (bp, kprime, kernels) in RES_ROUTES.items():
        params = SearchParams(k_prime=kprime, backend=IVFSearchParams(**bp) if bp else None)
        p = rr.resolve(params)
        require(p.use_residual and p.use_fused_gather, f"{name}: resolved {p}")
        bs = batches if kprime is None else batches[:KP_BATCHES]
        ops.reset_launch_counts()
        lat, outs = [], []
        for i, (q, qm, _) in enumerate(bs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, ids = rr.search(q, qm, params)
            torch.cuda.synchronize()
            if i:
                lat.append(time.perf_counter() - t0)
            outs.append((s, ids))
        launches = ops.launch_counts()
        want = {k: (len(bs) if k in kernels else 0) for k in launches}
        require(launches == want, f"route {name}: launches {launches}, expected {want}")
        ties = {"probe": 0, "candidates": 0, "final": 0}
        for i, ((q, qm, _), (s, ids)) in enumerate(zip(bs, outs)):
            require(s.shape == (q.shape[0], p.k) and bool(torch.isfinite(s).all())
                    and bool((ids >= 0).all()), f"route {name}: scores or ids malformed")
            require(bool(rstore.alive[ids.long()].all()), f"route {name}: a tombstoned doc")
            if kprime is not None:
                plain = plain_search(torch, rr.index, q, qm, p)
            else:
                if i not in plains:
                    plains[i] = plain_search(torch, rr.index, q, qm, p)
                plain = plains[i]
            probe = stable_topk(pool_queries(index.psi, q, qm) @ ann.centroids.T,
                                p.backend.nprobe)[1].int()
            cand = first_stage(rr.index, q, qm, p)
            for kk, v in classify_rows(torch, ids, s, plain, {"probe": probe, "cand": cand},
                                       p.k_prime).items():
                ties[kk] += v
            exact = plain_pair_scores(torch, rstore, q, qm, ids, chunk=32)
            torch.testing.assert_close(s, exact, rtol=1e-5, atol=1e-4)
            require(bool((s[:, :-1] >= s[:, 1:]).all()), f"route {name}: scores not sorted")
        lat_ms = [1e3 * x for x in lat]
        q, qm, _ = bs[1]
        per_search = search_launches(torch, launches, len(bs),
                                     lambda: rr.search(q, qm, params))
        require(per_search["psi_kernel_launches_traced"] <= 1,
                f"route {name}: the psi kernel ran more than once in a search")
        line[name] = dict(
            params=repr(params), batch=args.batch, batches=len(lat),
            p50_ms=float(np.median(lat_ms)), max_ms=float(np.max(lat_ms)),
            qps=args.batch * len(lat) / sum(lat), k_prime=p.k_prime,
            launches={k: v for k, v in launches.items() if v}, **per_search,
            near_tie_rows=ties,
            rows_checked=args.batch * len(bs),
            recall_at_10=float(maxsim.recall_at(outs[1][1][:nq, :10], truth).mean()))
        outs_by_route[name] = outs
        print(f"route {name} ok: p50 {line[name]['p50_ms']:.3f} ms, near-tie rows {ties}",
              flush=True)
    line["one_launch_rows_differing_from_default"] = int(sum(
        int((a[1] != b[1]).any(1).sum()) for a, b in
        zip(outs_by_route["residual_default"], outs_by_route["residual_one_launch"])))
    del plains, outs_by_route

    # the three kernels at the served shapes, against their plain versions
    psi = index.psi
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    q, qm, _ = batches[1]
    B, Tq, d = q.shape
    p0 = rr.resolve(SearchParams())
    dp, cap, P = store.d_prime, rann.capacity, p0.backend.nprobe
    kp = min(p0.k_prime, P * cap)
    L = 1 << codec.bits
    db = rann.vecs.shape[2]
    psi_q = pool_queries(psi, q, qm)
    probe = stable_topk(psi_q @ rann.centroids.T, P)[1].int()
    uniq = probe.long().unique()
    rows_u, rows_p = int(rann.counts[uniq].sum()), int(rann.counts[probe.long()].sum())
    launches = {k: line[route]["launches"].get(k, 0) for route, k in (
        ("residual_default", "ivf_probe_res_scan"),
        ("residual_default", "rerank_paged_res_scores"),
        ("residual_one_launch", "query_fused_res"))}
    rows = []

    def row(name, source, replaces, err, tol, fn, plain_fn, nbytes, flops, shape, *,
            peak=PEAK_FP32_S, split=1, **extra):
        # flops: the function's operations; split: the products a split
        # (3xTF32) makes of each, counted in the bound at ``peak``
        ms = time_ms(torch, fn)
        plain_ms = time_ms(torch, plain_fn, n=5, warmup=1)
        b_ms, b_by = bound(nbytes, split * flops, peak)
        rows.append(dict(
            name=name, variant="residual 4-bit", route="cuda", source=source,
            replaces=replaces, launches=launches[name],
            launches_per_search=launches[name] // len(batches), max_abs_err=err,
            ragged_max_abs_err=ragged[name], tolerance=tol, shape=shape, ms=ms,
            kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=int(nbytes),
            flops=int(flops), library_ms=None, **cuda_launches(torch, fn), **extra))
        print(f"{name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})",
              flush=True)

    # a design built on lookups (the residual scans: a shared-memory lookup
    # a code) issues at most 32 a clock an SM: its floor on this card
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])

    def lookup_floor_ms(codes):
        return codes / (32 * props.multi_processor_count * sm_mhz * 1e6) * 1e3

    lists = (rann.ids, rann.vecs, rann.centroids, rann.rq_values)
    got = gather_scan.ivf_probe_res_scan(psi_q, probe, *lists)
    want = ref.ivf_scan_res_ref(psi_q, probe, *lists, chunk=4)
    fin = torch.isfinite(want)
    require(torch.equal(torch.isfinite(got), fin), "ivf_probe_res_scan: pads differ")
    err = float((got[fin] - want[fin]).abs().max())
    require(err <= RES_SCAN_RTOL * max(1.0, float(want[fin].abs().max())),
            f"ivf_probe_res_scan: max abs err {err}")
    del got, want, fin
    table_bytes = len(uniq) * dp * 4 + dp * L * 4
    spread = scan_spread(torch, probe, rann.ids, "ivf_probe_res_scan")
    print(f"ivf_probe_res_scan spread: {json.dumps(spread)}", flush=True)
    row("ivf_probe_res_scan", "src/repro_torch/csrc/ivf_probe_res_scan.cu",
        "src/repro/kernels/gather_scan.py:386", err,
        f"{RES_SCAN_RTOL} x max(1, max|plain|)",
        lambda: gather_scan.ivf_probe_res_scan(psi_q, probe, *lists),
        lambda: ref.ivf_scan_res_ref(psi_q, probe, *lists, chunk=4),
        len(uniq) * cap * 4 + rows_u * db + table_bytes + psi_q.numel() * 4
        + probe.numel() * 4 + B * P * cap * 4, 2 * rows_p * dp,
        f"B {B} x nprobe {P} of {rann.nlist} lists of cap {cap}, {db} B a row (4 bits), "
        f"{rows_p / B:.0f} rows scanned a query", lookup_floor_ms=lookup_floor_ms(rows_p * dp),
        sm_clock_max_mhz=sm_mhz,
        bound_counted="bytes: the probed lists' ids, the distinct live rows' codes once, the "
                      "probed centroids and the values table, q, the probes, the (B, P, cap) "
                      "strip; operations: 2 x d' a row scanned probe by probe", **spread)

    # as the route calls it: on the probe selection's latent
    qargs = (q, qm, *w, probe, *lists)
    err, near_ties, _ = same_topk(torch, *query_fused.query_fused_res(*qargs, kp=kp,
                                                                      latent=psi_q),
                                  *ref.query_fused_res_ref(*qargs, kp=kp, chunk=4), 1e-4,
                                  "query_fused_res", exact_ties=False)
    row("query_fused_res", "src/repro_torch/csrc/query_fused.cu",
        "src/repro/kernels/query_fused.py:248", err, "1e-4 x max(1, max|plain|)",
        lambda: query_fused.query_fused_res(*qargs, kp=kp, latent=psi_q),
        lambda: ref.query_fused_res_ref(*qargs, kp=kp, chunk=4, latent=psi_q),
        psi_q.numel() * 4 + len(uniq) * cap * 4 + rows_u * db + table_bytes
        + probe.numel() * 4 + 2 * B * kp * 4, 2 * rows_p * dp,
        f"B {B} x Tq {Tq}, nprobe {P} of {rann.nlist} residual lists of cap {cap}, "
        f"{rows_p / B:.0f} rows scanned a query, k' {kp}", near_tie_ids=near_ties,
        lookup_floor_ms=lookup_floor_ms(rows_p * dp), sm_clock_max_mhz=sm_mhz)

    cand = first_stage(rr.index, q, qm, rr.resolve(SearchParams()))
    pargs = (q, qm, cand, rstore.cent_pages, rstore.code_pages, rstore.page_table,
             rstore.n_tokens, codec.centroids, codec.values)
    valid = cand >= 0
    got = torch.where(valid, gather_scan.rerank_paged_res_scores(*pargs), 0.0)
    rr_path = gather_scan.rerank_paged_res_scores.last_path
    require(rr_path == "tensor cores",
            f"rerank_paged_res_scores: the served shape ran on the {rr_path}")
    want = torch.where(valid, ref.rerank_scores_paged_res_ref(*pargs, chunk=16), 0.0)
    err = float((got - want).abs().max())
    require(err <= 1e-4 + 1e-5 * float(want.abs().max()),
            f"rerank_paged_res_scores: max abs err {err}")
    # the tensor cores' split against fp64 MaxSim over the decoded tokens, 8 queries
    n8 = 8
    toks, tmask = pages.gather_docs(rstore, cand[:n8].clamp_min(0))
    sc = torch.einsum("bqd,bktd->bkqt", q[:n8].double(), toks.double())
    best = torch.where(tmask[:, :, None, :], sc, ref.NEG).amax(-1)
    exact = torch.where(qm[:n8, None, :], best, 0.0).sum(-1)
    ok8 = valid[:n8]
    err64 = float((got[:n8][ok8].double() - exact[ok8]).abs().max())
    require(err64 <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact[ok8].abs().max())),
            f"rerank_paged_res_scores: max abs err against fp64 {err64}")
    del toks, tmask, sc, best, exact
    ntok = torch.where(valid, rstore.n_tokens[cand.clamp_min(0).long()], 0).long()
    uc = cand[valid].long().unique()
    pages_u = int(((rstore.n_tokens[uc].long() + 15) // 16).sum())
    rr_flops = 2 * int((ntok * qm.sum(1, keepdim=True)).sum()) * d
    rr_bytes = (pages_u * 16 * (4 + codec.packed_width) + len(uc) * (rstore.pages_per_doc * 4 + 4)
                + codec.ncent * d * 4 + d * L * 4 + q.numel() * 4 + qm.numel()
                + 2 * cand.numel() * 4)
    row("rerank_paged_res_scores", "src/repro_torch/csrc/rerank_paged_res.cu",
        "src/repro/kernels/gather_scan.py:456", err, "1e-4 + 1e-5 x max|plain|",
        lambda: gather_scan.rerank_paged_res_scores(*pargs),
        lambda: ref.rerank_scores_paged_res_ref(*pargs, chunk=16), rr_bytes, rr_flops,
        f"B {B} x k' {cand.shape[1]} candidates of the residual default route, Tq {Tq}, "
        f"16-token pages of {codec.packed_width} B codes + int32 centroid ids, "
        f"codec {codec.ncent} x {d}", peak=PEAK_TF32_S, split=3,
        path=rr_path, bound_split="3xTF32", max_abs_err_fp64=err64,
        tolerance_fp64="ref.TF32_SPLIT_RTOL x max(1, max|exact|)",
        bound_ms_fp32_cuda_cores=bound(rr_bytes, rr_flops)[0])
    # the tier shares W and the tombstones with the fp32 tier and fits beside
    # it, so nothing of the earlier phases is freed first
    line.update(card=card_line(), freed=[], traced_batch=profile_batch(torch, rr, q, qm),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del cand, pargs, qargs, lists

    # one churn round on the compressed store and its 4-bit lists; rr was
    # made over tensors the fp32 index shares, so what it writes it copies
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ptrs = (rstore.code_pages.data_ptr(), rstore.W.data_ptr(), rann.vecs.data_ptr())
    alive0 = store.alive.clone()
    gone = set(torch.nonzero(~rstore.alive[:m]).flatten().tolist())
    rd = churn_round(torch, rr, np.random.default_rng(args.seed + 12), args.seed,
                     CHURN_DELETE, CHURN_ADD, CHURN_UPDATE, gone)
    rd["before"] = dict(free_pages=len(pages.free_list(rstore)), list_cap=rann.capacity)
    rd["after"] = store_census(torch, rr)
    rd["routes"] = check_churned_routes(torch, rr, batches[1:2], gone, {
        "residual_default": ({}, None), "residual_one_launch": ({}, {"use_one_launch": True})})
    st = rr.index.store
    rd["copied_on_write"] = [n for n, a, b in zip(
        ("code_pages", "W", "list_vecs"), ptrs,
        (st.code_pages.data_ptr(), st.W.data_ptr(), rr.index.ann.vecs.data_ptr())) if a != b]
    require(torch.equal(store.alive, alive0) and int(store.n_docs[0]) == m,
            "the residual churn wrote the fp32 index's tombstones")
    rd.update(memory_allocated_change_gib=(torch.cuda.memory_allocated() - mem0) / 2**30,
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    line["churn_round"] = rd
    print(f"residual churn round ok: delete {rd['delete_ms']:.1f} ms, add {rd['add_ms']:.1f} "
          f"ms, update {rd['update_ms']:.1f} ms, copied {rd['copied_on_write']}", flush=True)
    del rr, rstore, rann, codec, st
    return line, rows


# --------------------------------------------------------------------------
# sharded serving: LemurRetriever.shard on a one-rank NCCL process group
# --------------------------------------------------------------------------

SHARD_WIDEN = 65536        # SQ8 rows widened at a time by the plain latent product
FP32_CUT = 100_000         # slots of the fp32 block's base (its 43 GB at 2^20 rows)
SHARD_ROUTES = {   # name: (SearchParams keywords, batch or None, kernels a search)
    "sharded_fused": (dict(use_ann=False), None,
                      ("fused_psi_pool", "rerank_gather_scores")),
    "sharded_one_launch": (dict(use_ann=False, use_one_launch=True), None,
                           ("fused_psi_pool", "mips_topk", "rerank_gather_scores")),
    # k' 2,048 on one rank: k'_loc = 8,192, above the old cap of mips_topk (4,096)
    "sharded_one_launch_kp2048": (dict(use_ann=False, use_one_launch=True, k_prime=2048),
                                  None, ("fused_psi_pool", "mips_topk",
                                         "rerank_gather_scores")),
    # the gathered slab at 256 queries x 4,096 candidates would be 43 GB
    "sharded_legacy": (dict(use_ann=False, use_fused_gather=False), 16, ("fused_psi_pool",)),
}


@contextlib.contextmanager
def nccl_mesh(torch, shape=(1,), names=("model",)):
    """A one-rank NCCL process group on the card (a tcp store on a free
    local port) and its DeviceMesh of ``shape`` (ones) and axis ``names``;
    destroyed on exit."""
    import socket

    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                             rank=0)
    try:
        yield init_device_mesh("cuda", shape, mesh_dim_names=names)
    finally:
        tdist.destroy_process_group()


def sharded_plain(torch, state, q, qm, kp, k):
    """The plain composition of a one-shard route: the plain pool, the full
    latent product over the block (SQ8 rows through ``mips_sq8_ref``,
    SHARD_WIDEN rows at a time), free and tombstoned rows at NEG, the stable
    top-k', the plain dense rerank, the stable top-k, the row ids."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.kernels import ref

    psi = state.psi
    psi_q = ref.psi_pool_ref(q, qm, psi.dense.kernel, psi.dense.bias, psi.ln.scale,
                             psi.ln.bias)
    n = state.W.shape[0]
    kp = min(kp, n)
    lat = torch.empty((q.shape[0], n), dtype=torch.float32, device=q.device)
    for s in range(0, n, SHARD_WIDEN):
        e = min(n, s + SHARD_WIDEN)
        lat[:, s:e] = (psi_q @ state.W[s:e].T if state.W_scales is None else
                       ref.mips_sq8_ref(psi_q, state.W[s:e], state.W_scales[s:e]))
    lat.masked_fill_(~state.row_valid[None, :], ref.NEG)
    lat_s, cand = stable_topk(lat, kp)
    del lat
    cand = cand.int()
    r = ref.rerank_scores_ref(q, qm, cand, state.doc_tokens, state.doc_mask, state.doc_scales,
                              chunk=128)
    top, idx = stable_topk(torch.where(cand >= 0, r, ref.NEG), min(k, kp))
    local = torch.gather(cand, 1, idx)
    ids = torch.where(local >= 0, state.row_ids[local.clamp_min(0).long()], -1)
    return dict(psi_q=psi_q, cand=cand, scores=torch.where(ids >= 0, top, ref.NEG), ids=ids,
                **latent_edge(lat_s))


def port_candidates(torch, state, q, qm, kp, one_launch):
    """The port's own latent top-k' of a one-shard route (block rows)."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.core.model import pool_queries
    from repro_torch.dist.serve import latent_scores
    from repro_torch.kernels import ops, ref

    psi_q = pool_queries(state.psi, q, qm)
    kp = min(kp, state.W.shape[0])
    if one_launch:
        return ops.mips_topk_fused(psi_q, state.W, state.W_scales, kp, state.row_valid)[1]
    s = latent_scores(psi_q, state.W, state.W_scales).masked_fill_(~state.row_valid[None, :],
                                                                    ref.NEG)
    return stable_topk(s, kp)[1].int()


def rerank_gather_cost(torch, q, qm, cand, doc_mask, token_bytes):
    """Bytes and operations of one rerank_gather_scores call on this data:
    q, its mask and the candidates read once, each distinct candidate's
    mask row and its valid tokens (``token_bytes`` each: the values and,
    for SQ8, the scale) read once, the scores written; 2 d operations for
    every (valid query token, valid doc token) pair."""
    safe = cand.clamp_min(0).long()
    ntok = doc_mask.sum(1)
    uc = safe.unique()
    Td = doc_mask.shape[1]
    nbytes = (q.numel() * 4 + qm.numel() + 2 * cand.numel() * 4 + len(uc) * Td
              + int(ntok[uc].sum()) * token_bytes)
    flops = 2 * q.shape[2] * int((ntok[safe] * qm.sum(1, keepdim=True)).sum())
    return nbytes, flops


def cut_base(torch, r, n):
    """A retriever over the first n slots of the served index: their pages,
    W rows and tombstones copied DOC_CHUNK slots at a time (the exact latent
    scan serves it; its IVF is not used)."""
    from repro_torch.core import pages
    from repro_torch.retriever import LemurRetriever

    st = r.index.store
    ppd = pages.pages_needed(st.n_tokens[:n])
    cst = pages.allocate(n, int(ppd.sum()), st.pages_per_doc, st.d, st.d_prime,
                         device=st.W.device)
    page = 0
    for s in range(0, n, DOC_CHUNK):
        ids = torch.arange(s, min(n, s + DOC_CHUNK), dtype=torch.int32, device=st.W.device)
        toks, tm = pages.gather_docs(st, ids)
        page += pages.write_docs(cst, s, page, st.W[ids.long()], toks, tm)
    cst.alive[:n] = st.alive[:n]
    return LemurRetriever(r.index._replace(store=cst))


def sharded_ragged_case(torch, seed, mesh):
    """rerank_gather_scores (fp32 and SQ8) against its plain version on B = 1,
    Td = 77 (off every 16-row tile), -1 candidates, a doc with no valid
    token, duplicated candidates, a partial query mask and k > k'; mips_topk
    at k' = 4096 with the valid rows above and below k'; the sharded
    one-launch route at k'_loc = 4096 over 4,096 rows (k' above the valid
    ones) and over 8,192; a cuda mesh refusing a retriever on the CPU.
    Returns max abs errors."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.anns.quantization import sq8_quant
    from repro_torch.core import pages
    from repro_torch.core.config import LemurConfig
    from repro_torch.core.model import Psi
    from repro_torch.kernels import gather_scan, ops, query_fused, ref
    from repro_torch.retriever import LemurRetriever, SearchParams

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    norm = torch.nn.functional.normalize
    errs = {}
    m, Td, d, Tq = 40, 77, 128, 6
    docs = norm(torch.randn(m, Td, d, generator=g, device=dev), dim=-1)
    dm = torch.rand(m, Td, generator=g, device=dev) > 0.4
    dm[3] = False
    q = norm(torch.randn(1, Tq, d, generator=g, device=dev), dim=-1)
    qm = torch.tensor([[True, True, False, True, True, False]], device=dev)
    cand = torch.tensor([[-1, 3, 0, 7, 7, -1, 12, 39, 3]], dtype=torch.int32, device=dev)
    for sq8 in (False, True):
        toks, scales = sq8_quant(docs) if sq8 else (docs, None)
        args = (q, qm, cand, toks, dm, scales)
        a, b = gather_scan.rerank_gather_scores(*args), ref.rerank_scores_ref(*args)
        real = b > ref.NEG / 2
        require(bool(((a[~real] - b[~real]).abs() <= 1e-6 * b[~real].abs()).all()),
                "rerank_gather ragged: NEG-scale scores differ")
        err = float((a[real] - b[real]).abs().max())
        require(err <= 1e-5 * max(1.0, float(b[real].abs().max())),
                f"rerank_gather ragged: max abs err {err}")
        require(bool(a[0, 3] == a[0, 4]) and bool(a[0, 1] == a[0, 8]),
                "rerank_gather ragged: duplicated candidates score apart")
        s, i = ops.fused_rerank(q, qm, cand, toks, dm, 12, doc_scales=scales)
        top, idx = stable_topk(torch.where(cand >= 0, b, ref.NEG), 9)
        require(torch.equal(i[:, :9], torch.gather(cand, 1, idx))
                and bool((i[:, 9:] == -1).all()) and bool((s[:, 9:] == ref.NEG).all()),
                "rerank_gather ragged: the top-k wrapper differs from plain")
        errs[f"rerank_gather_{'sq8' if sq8 else 'fp32'}"] = err
    for frac in (0.9, 0.3):               # 4,500 and 1,500 valid rows of 5,000
        qi = torch.randint(-3, 4, (3, 64), generator=g, device=dev).float()
        W = torch.randint(-3, 4, (5000, 64), generator=g, device=dev).float()
        W[2500] = W[7]
        valid = torch.rand(5000, generator=g, device=dev) < frac
        got = query_fused.mips_topk(qi, W, None, valid, kp=4096)
        want = ref.mips_topk_ref(qi, W, None, valid, kp=4096)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"mips_topk ragged at kp 4096 ({frac} valid) differs from plain")
        codes, sc = sq8_quant(W)
        err, _, _ = same_topk(torch, *query_fused.mips_topk(qi, codes, sc, valid, kp=4096),
                              *ref.mips_topk_ref(qi, codes, sc, valid, kp=4096), SQ8_RTOL,
                              "mips_topk sq8 ragged at kp 4096")
        errs["mips_topk_kp4096"] = max(errs.get("mips_topk_kp4096", 0.0), err)
    for n_docs in (3000, 6000):
        T, dp = 20, 256
        tok = norm(torch.randn(n_docs, T, d, generator=g, device=dev), dim=-1)
        mask = torch.rand(n_docs, T, generator=g, device=dev) > 0.3
        store, _ = pages.from_dense(torch.randn(n_docs, dp, generator=g, device=dev), tok, mask)
        store.alive[[5, 9]] = False
        psi = Psi.init(d, dp, torch.Generator().manual_seed(seed), device=dev)
        rr = LemurRetriever.from_arrays(LemurConfig(d=d, d_prime=dp, k=50, k_prime=1024), psi,
                                        store, generator=torch.Generator().manual_seed(seed))
        if n_docs == 3000:         # a cuda mesh refuses a retriever on the CPU
            try:
                LemurRetriever(rr.index._replace(store=store.to("cpu"))).shard(mesh)
            except ValueError:
                pass
            else:
                raise CheckFailed("a cuda mesh sharded a retriever whose tensors are on the CPU")
        sr = rr.shard(mesh)
        qq = norm(torch.randn(4, 8, d, generator=g, device=dev), dim=-1)
        qqm = torch.rand(4, 8, generator=g, device=dev) > 0.2
        qqm[:, 0] = True
        s, i = sr.search(qq, qqm, SearchParams(use_ann=False, use_one_launch=True))
        plain = sharded_plain(torch, sr.state, qq, qqm, 4096, 50)
        err, _, _ = same_topk(torch, s, i, plain["scores"], plain["ids"], 1e-5,
                              f"sharded one-launch ragged ({n_docs} docs)", exact_ties=False)
        dead = torch.tensor([5, 9], dtype=i.dtype, device=dev)
        require(bool((i >= 0).all()) and not bool(torch.isin(i, dead).any()),
                "sharded one-launch ragged: a free or tombstoned row")
        errs[f"sharded_one_launch_{sr.rows_per_shard}_rows"] = err
    return errs


def sharded_phase(torch, args, r, batches, library_ms_kp4096=None):
    """Corpus-sharded serving (``LemurRetriever.shard``) on one rank of an
    NCCL process group over the served index at full width: the SQ8 block
    of 2^20 rows through three routes, then an fp32 block of a base cut to
    FP32_CUT slots through the default route and against the base's exact
    scan.  Counters from 0 around each route.  Returns (sharded line,
    kernel rows)."""
    import gc

    from repro_torch import dist
    from repro_torch.anns.base import stable_topk
    from repro_torch.core import pages
    from repro_torch.core.model import pool_queries
    from repro_torch.dist.serve import latent_scores
    from repro_torch.kernels import gather_scan, ops, query_fused, ref
    from repro_torch.retriever import SearchParams
    from repro_torch.retriever.facade import first_stage

    store = r.index.store
    m = int(store.n_docs[0])
    line, rows = {}, []
    with nccl_mesh(torch) as mesh:
        ragged = sharded_ragged_case(torch, args.seed, mesh)
        print(f"ragged case of rerank_gather_scores, mips_topk at kp 4096 and the sharded "
              f"one-launch route ok: max abs err {ragged}", flush=True)
        torch.cuda.synchronize()
        t0 = time.time()
        sr = r.shard(mesh)                          # cfg.ivf.sq8: the SQ8 block
        torch.cuda.synchronize()
        t_fill = time.time() - t0
        st = sr.state
        p0 = sr.resolve(SearchParams(use_ann=False))
        kp = dist.default_k_prime_local(p0.k, p0.k_prime, 1)
        require(sr.sq8 and st.W.dtype == torch.int8 and sr.rows_per_shard == pages.next_pow2(m)
                and st.doc_tokens.shape[1:] == (80, 128) and kp == 4096,
                f"sharded state {sr!r}, rows {sr.rows_per_shard}, kp {kp}")
        print(f"sharded SQ8 block: {sr.rows_per_shard} rows filled in {t_fill:.1f} s",
              flush=True)
        plains = [sharded_plain(torch, st, q, qm, kp, p0.k) for q, qm, _ in batches]
        line.update(world_size=1, backend="nccl", mesh="(1,) ('model',)",
                    rows_per_shard=sr.rows_per_shard, m=m, k=p0.k, k_prime=p0.k_prime,
                    k_prime_local=kp, sq8_fill_s=t_fill,
                    sq8_block_bytes={n: t.numel() * t.element_size() for n, t in (
                        ("W", st.W), ("W_scales", st.W_scales), ("doc_tokens", st.doc_tokens),
                        ("doc_scales", st.doc_scales), ("doc_mask", st.doc_mask))},
                    reduced={"m": m, "from": msmarco_docs(), "legacy_batch": 16,
                             "fp32_block_slots": FP32_CUT,
                             "why": "one card: the served index (800k docs) and its SQ8 "
                                    "block fit beside each other; an fp32 block of 2^20 "
                                    "rows would be 43 GB of tokens; the legacy route's "
                                    "gathered slab at 256 queries would be 43 GB"})
        outs = {}
        for name, (kw, batch, kernels) in SHARD_ROUTES.items():
            params = SearchParams(**kw)
            B = min(batch or args.batch, args.batch)
            pk = sr.resolve(params)
            kp_r = dist.default_k_prime_local(pk.k, pk.k_prime, 1)
            bs = batches if kp_r == kp else batches[:KP_BATCHES]
            ops.reset_launch_counts()
            rescans = query_fused.mips_topk.rescans
            lat, res = [], []
            for i, (q, qm, _) in enumerate(bs):
                q, qm = q[:B], qm[:B]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, ids = sr.search(q, qm, params)
                torch.cuda.synchronize()
                if i:
                    lat.append(time.perf_counter() - t0)
                res.append((s, ids))
            launches = ops.launch_counts()
            want = {k: (len(bs) if k in kernels else 0) for k in launches}
            require(launches == want, f"route {name}: launches {launches}, expected {want}")
            rescans = query_fused.mips_topk.rescans - rescans
            require(rescans == 0, f"route {name}: mips_topk rescanned {rescans} times")
            ties = {"candidates": 0, "final": 0}
            for (q, qm, _), (s, ids), plain in zip(bs, res, plains):
                q, qm = q[:B], qm[:B]
                if kp_r != kp:
                    plain = sharded_plain(torch, st, q, qm, kp_r, p0.k)
                plain = {k: v[:B] for k, v in plain.items()}
                require(s.shape == (B, p0.k) and bool(torch.isfinite(s).all())
                        and bool((ids >= 0).all()) and bool((ids < m).all()),
                        f"route {name}: scores or ids malformed")
                require(bool(store.alive[ids.long()].all()),
                        f"route {name}: a free or tombstoned row in the top-k")
                cand = None
                if bool((ids != plain["ids"]).any()):
                    cand = port_candidates(torch, st, q, qm, kp_r, "one_launch" in name)
                kinds = classify_exact(torch, st.W, st.W_scales, ids, s, cand, plain)
                for kk, v in kinds.items():
                    ties[kk] += v
                # one shard: a doc's row is its slot id
                exact = ref.rerank_scores_ref(q, qm, ids, st.doc_tokens, st.doc_mask,
                                              st.doc_scales, chunk=25)
                torch.testing.assert_close(s, exact, rtol=1e-5, atol=1e-4)
                require(bool((s[:, :-1] >= s[:, 1:]).all()), f"route {name}: not sorted")
            lat_ms = [1e3 * x for x in lat]
            line[name] = dict(
                params=repr(params), batch=B, batches=len(lat), k_prime_local=kp_r,
                p50_ms=float(np.median(lat_ms)), max_ms=float(np.max(lat_ms)),
                qps=B * len(lat) / sum(lat), launches={k: v for k, v in launches.items() if v},
                near_tie_rows=ties, rows_checked=B * len(bs), mips_topk_rescans=rescans)
            outs[name] = res
            print(f"route {name} ok: p50 {line[name]['p50_ms']:.3f} ms, near-tie rows {ties}",
                  flush=True)
        line["one_launch_rows_differing_from_fused"] = int(sum(
            int((a[1] != b[1]).any(1).sum()) for a, b in
            zip(outs["sharded_fused"], outs["sharded_one_launch"])))
        launches_by_kernel = {
            "rerank_gather_scores": line["sharded_fused"]["launches"]["rerank_gather_scores"],
            "mips_topk": line["sharded_one_launch"]["launches"]["mips_topk"]}
        del outs, plains

        # the default route's stages alone, and the kernels at the served shape
        q, qm, _ = batches[1]
        B, Tq, d = q.shape
        psi_q = pool_queries(st.psi, q, qm)
        lat_ms = time_ms(torch, lambda: latent_scores(psi_q, st.W, st.W_scales), n=5)
        s_lat = latent_scores(psi_q, st.W, st.W_scales).masked_fill_(~st.row_valid[None, :],
                                                                      ref.NEG)
        sort_ms = time_ms(torch, lambda: stable_topk(s_lat, kp), n=5)
        cand = stable_topk(s_lat, kp)[1].int()
        del s_lat
        args_k = (q, qm, cand, st.doc_tokens, st.doc_mask, st.doc_scales)
        rows.append(rerank_gather_row(torch, "sq8", args_k, launches_by_kernel, ragged))
        line["stages_ms"] = {"latent_product": lat_ms, "latent_sort": sort_ms,
                             "rerank_kernel": rows[-1]["ms"]}
        print(f"sharded stages: latent product {lat_ms:.3f} ms, its stable top-{kp} "
              f"{sort_ms:.3f} ms", flush=True)
        margs = (psi_q, st.W, st.W_scales, st.row_valid)
        err, near_ties, _ = same_topk(torch, *query_fused.mips_topk(*margs, kp=kp),
                                      *ref.mips_topk_ref(*margs, kp=kp, chunk=64), SQ8_RTOL,
                                      "mips_topk sq8 kp 4096", exact_ties=False)
        live = int(st.row_valid.sum())
        n_rows = st.W.shape[0]
        ms = time_ms(torch, lambda: query_fused.mips_topk(*margs, kp=kp), n=10)
        plain_ms = time_ms(torch, lambda: ref.mips_topk_ref(*margs, kp=kp, chunk=64), n=3,
                           warmup=1)
        b_ms, b_by = bound(psi_q.numel() * 4 + live * (st.W.shape[1] + 4) + n_rows
                           + 2 * B * kp * 4, 2 * 2 * B * live * st.W.shape[1], PEAK_TF32_S)
        rows.append(dict(
            name="mips_topk", variant="sq8, k' 4096 (sharded one-launch route)", route="cuda",
            source="src/repro_torch/csrc/query_fused.cu",
            replaces="src/repro/kernels/query_fused.py:354",
            launches=launches_by_kernel["mips_topk"], max_abs_err=err,
            ragged_max_abs_err=ragged["mips_topk_kp4096"],
            tolerance=f"{SQ8_RTOL} x max(1, max|plain|)",
            shape=f"B {B} x {n_rows} block rows ({live} valid) x d' {st.W.shape[1]} int8, "
                  f"k' {kp}", ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, bound_split="2xTF32 (q split)",
            bound_ms_fp32_cuda_cores=bound(psi_q.numel() * 4 + live * (st.W.shape[1] + 4)
                                           + n_rows + 2 * B * kp * 4,
                                           2 * B * live * st.W.shape[1])[0],
            near_tie_ids=near_ties, library_ms=library_ms_kp4096,
            library_note="torch.topk((q @ codes.float().T) * s, 4096), timed in the routes "
                         "phase on the index's W quantized (the same 2^20 x d' int8 rows)",
            launches_per_search=launches_by_kernel["mips_topk"] // len(batches),
            **cuda_launches(torch, lambda: query_fused.mips_topk(*margs, kp=kp))))
        print(f"mips_topk (sq8, kp {kp}): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by})", flush=True)
        line["traced_batch"] = profile_batch(torch, sr, q, qm)
        line["sq8_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del args_k, margs, cand, psi_q
        line["churn_round"] = sharded_churn(torch, args, r, sr, batches[1], kp)
        del sr, st
        gc.collect()
        torch.cuda.empty_cache()

        # the fp32 block, over a base cut to FP32_CUT slots of the same corpus
        torch.cuda.synchronize()
        t0 = time.time()
        rc = cut_base(torch, r, FP32_CUT)
        src = rc.shard(mesh, sq8=False)
        torch.cuda.synchronize()
        t_cut = time.time() - t0
        st = src.state
        params = SearchParams(use_ann=False)
        ops.reset_launch_counts()
        lat, res = [], []
        for i, (q, qm, _) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res.append(src.search(q, qm, params))
            torch.cuda.synchronize()
            if i:
                lat.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        want = {k: (len(batches) if k in SHARD_ROUTES["sharded_fused"][2] else 0)
                for k in launches}
        require(launches == want, f"fp32 block: launches {launches}, expected {want}")
        ties = {"candidates": 0, "final": 0}
        for (q, qm, _), (s, ids) in zip(batches, res):
            plain = sharded_plain(torch, st, q, qm, kp, p0.k)
            require(bool((ids >= 0).all()) and bool(rc.index.store.alive[ids.long()].all()),
                    "fp32 block: a free or tombstoned row in the top-k")
            cand = None
            if bool((ids != plain["ids"]).any()):
                cand = port_candidates(torch, st, q, qm, kp, False)
            kinds = classify_exact(torch, st.W, st.W_scales, ids, s, cand, plain)
            for kk, v in kinds.items():
                ties[kk] += v
            exact = ref.rerank_scores_ref(q, qm, ids, st.doc_tokens, st.doc_mask, chunk=25)
            torch.testing.assert_close(s, exact, rtol=1e-5, atol=1e-4)
        lat_ms = [1e3 * x for x in lat]
        line["sharded_fp32_cut"] = dict(
            params=repr(params), batch=args.batch, batches=len(lat), slots=FP32_CUT,
            rows_per_shard=src.rows_per_shard, fill_s=t_cut,
            p50_ms=float(np.median(lat_ms)), max_ms=float(np.max(lat_ms)),
            qps=args.batch * len(lat) / sum(lat),
            launches={k: v for k, v in launches.items() if v}, near_tie_rows=ties,
            rows_checked=args.batch * len(batches))
        print(f"route sharded_fp32_cut ok: p50 {line['sharded_fp32_cut']['p50_ms']:.3f} ms, "
              f"near-tie rows {ties}", flush=True)
        q, qm, _ = batches[1]
        psi_q = pool_queries(st.psi, q, qm)
        cand = port_candidates(torch, st, q, qm, kp, False)
        rows.append(rerank_gather_row(
            torch, "fp32", (q, qm, cand, st.doc_tokens, st.doc_mask, None),
            {"rerank_gather_scores": launches["rerank_gather_scores"]}, ragged,
            note=f" over the fp32 block of the first {FP32_CUT} slots"))
        del res, src, st, cand, psi_q
        gc.collect()
        torch.cuda.empty_cache()

        # the same cut base: sharded (k'_loc = 1024) against its exact scan
        s1 = rc.shard(mesh, sq8=False, k_prime_local=p0.k_prime)
        pb = rc.resolve(params)
        cmp = {"rows_differing": 0, "sharded_near_ties": {"candidates": 0, "final": 0},
               "base_near_ties": {"candidates": 0, "final": 0}}
        for q, qm, _ in batches:
            ss, si = s1.search(q, qm, params)
            bs, bi = rc.search(q, qm, params)
            plain = sharded_plain(torch, s1.state, q, qm, p0.k_prime, p0.k)
            cand = None
            if bool((si != plain["ids"]).any()):
                cand = port_candidates(torch, s1.state, q, qm, p0.k_prime, False)
            for kk, v in classify_exact(torch, s1.state.W, s1.state.W_scales, si, ss, cand,
                                          plain).items():
                cmp["sharded_near_ties"][kk] += v
            cand = first_stage(rc.index, q, qm, pb) if bool((bi != plain["ids"]).any()) else None
            for kk, v in classify_exact(torch, s1.state.W, s1.state.W_scales, bi, bs, cand,
                                          plain).items():
                cmp["base_near_ties"][kk] += v
            # rows whose ids agree agree in score (a k' boundary near-tie
            # lets another candidate in, which may move the whole row)
            same = (si == bi).all(1)
            cmp["rows_differing"] += int((~same).sum())
            torch.testing.assert_close(ss[same], bs[same], rtol=1e-5, atol=1e-4)
        explained = sum(cmp["sharded_near_ties"].values()) + sum(cmp["base_near_ties"].values())
        require(cmp["rows_differing"] <= explained,
                f"sharded and base ids differ on rows that match the plain composition: {cmp}")
        line["fp32_cut_vs_base_exact_scan"] = dict(k_prime_local=p0.k_prime,
                                                   rows_checked=args.batch * len(batches), **cmp)
        print(f"sharded fp32 (k'_loc {p0.k_prime}) against the base's exact scan: {cmp}",
              flush=True)
        del s1, rc
    line.update(card=card_line(), ragged_max_abs_err=ragged,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return line, rows


def sharded_churn(torch, args, r, sr, batch, kp):
    """One add / delete round on the SQ8 block through the sharded facade (the
    base facade mutated in place, the new docs placed in free rows), then
    the fused route on a batch held to the plain composition over the block,
    its scores to exact MaxSim over the block's tokens, no deleted id."""
    from repro_torch.kernels import ops, ref
    from repro_torch.retriever import SearchParams

    rng = np.random.default_rng(args.seed + 13)
    store = r.index.store
    gone = set(torch.nonzero(~store.alive[:r.m]).flatten().tolist())
    ops.reset_launch_counts()
    ids = pick_live(torch, r, rng, CHURN_DELETE)
    _, del_ms = synced_ms(torch, lambda: sr.delete(ids))
    del_bytes = r.last_mutation_bytes
    gone.update(ids.tolist())
    tok, mask = churn_docs(torch, rng, args.seed, CHURN_ADD, r.device, store.d)
    _, add_ms = synced_ms(torch, lambda: sr.add(tok, mask))
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    added = sr.last_added_ids
    st = sr.state
    rows = torch.as_tensor([sr._row_of[int(i)] for i in added], device=st.W.device)
    require(torch.equal(st.row_ids[rows].cpu(), torch.as_tensor(added))
            and bool(st.row_valid[rows].all()), "sharded churn: new docs not placed")
    require(not bool(torch.isin(st.row_ids, torch.as_tensor(ids, device=st.W.device)).any()),
            "sharded churn: a deleted doc keeps its row")
    q, qm, _ = batch
    params = SearchParams(use_ann=False)
    p0 = sr.resolve(params)
    (s, out), search_ms = synced_ms(torch, lambda: sr.search(q, qm, params))
    plain = sharded_plain(torch, st, q, qm, kp, p0.k)
    gone_t = torch.as_tensor(sorted(gone), device=st.W.device)
    require(bool((out >= 0).all()) and not bool(torch.isin(out.long(), gone_t).any()),
            "sharded churn: a deleted doc served")
    cand = None
    if bool((out != plain["ids"]).any()):
        cand = port_candidates(torch, st, q, qm, kp, False)
    ties = classify_exact(torch, st.W, st.W_scales, out, s, cand, plain)
    row_of = torch.full((r.m,), -1, dtype=torch.int32, device=st.W.device)
    valid = st.row_valid
    row_of[st.row_ids[valid].long()] = torch.nonzero(valid).flatten().int()
    exact = ref.rerank_scores_ref(q, qm, row_of[out.long()], st.doc_tokens, st.doc_mask,
                                  st.doc_scales, chunk=25)
    torch.testing.assert_close(s, exact, rtol=1e-5, atol=1e-4)
    rd = dict(delete_ms=del_ms, delete_bytes=del_bytes, add_ms=add_ms,
              add_bytes=r.last_mutation_bytes, launches=launches,
              free_rows=sum(len(f) for f in sr._free_rows), rows_per_shard=sr.rows_per_shard,
              search_ms=search_ms, near_tie_rows=ties, rows_checked=q.shape[0],
              new_docs_in_rows_of_deleted=int((rows < r.m - CHURN_ADD).sum()))
    print(f"sharded churn round ok: delete {del_ms:.1f} ms, add {add_ms:.1f} ms, near-tie "
          f"rows {ties}", flush=True)
    return rd


def rerank_fp64(torch, q, qm, cand, toks, dm, scales, chunk=256):
    """Exact MaxSim of each query against its own candidates in fp64 (the
    stored tokens: SQ8 codes times their scales), ``chunk`` candidates at a
    time."""
    from repro_torch.kernels import ref

    out = []
    for s0 in range(0, cand.shape[1], chunk):
        c = cand[:, s0:s0 + chunk].clamp_min(0).long()
        sc = torch.einsum("bqd,bktd->bkqt", q.double(), toks[c].double())
        if scales is not None:
            sc = sc * scales[c].double()[:, :, None, :]
        best = torch.where(dm[c][:, :, None, :], sc, ref.NEG).amax(-1)
        out.append(torch.where(qm[:, None, :], best, 0.0).sum(-1))
    return torch.cat(out, 1)


def rerank_gather_row(torch, variant, args_k, launches_by_kernel, ragged, note=""):
    """rerank_gather_scores at the served shape against its plain version
    and, on 8 queries, against fp64 MaxSim (the tensor cores' split within
    ref.TF32_SPLIT_RTOL): max abs errors, kernel and plain times, the bound
    at the TF32 split's rate and on the CUDA cores."""
    from repro_torch.kernels import gather_scan, ref

    q, qm, cand, toks, dm, scales = args_k
    got = gather_scan.rerank_gather_scores(*args_k)
    want = ref.rerank_scores_ref(*args_k, chunk=128)
    err = float((got - want).abs().max())
    require(err <= 1e-4 + 1e-5 * float(want.abs().max()),
            f"rerank_gather_scores {variant}: max abs err {err}")
    exact = rerank_fp64(torch, q[:8], qm[:8], cand[:8], toks, dm, scales)
    tc_err = float((got[:8].double() - exact).abs().max())
    tc_tol = ref.TF32_SPLIT_RTOL * max(1.0, float(exact.abs().max()))
    require(tc_err <= tc_tol, f"rerank_gather_scores {variant}: max abs err against fp64 "
                              f"{tc_err} > {tc_tol}")
    del got, want, exact
    ms = time_ms(torch, lambda: gather_scan.rerank_gather_scores(*args_k))
    plain_ms = time_ms(torch, lambda: ref.rerank_scores_ref(*args_k, chunk=128), n=3, warmup=1)
    sq8 = scales is not None
    nbytes, flops = rerank_gather_cost(torch, q, qm, cand, dm, q.shape[2] * (1 if sq8 else 4)
                                       + (4 if sq8 else 0))
    split = 2 if sq8 else 3
    b_ms, b_by = bound(nbytes, split * flops, PEAK_TF32_S)
    B, Tq, d = q.shape
    print(f"rerank_gather_scores ({variant}): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}), max abs err against fp64 {tc_err}", flush=True)
    return dict(
        name="rerank_gather_scores", variant=variant, route="cuda",
        source="src/repro_torch/csrc/rerank_gather.cu",
        replaces="src/repro/kernels/gather_scan.py:183",
        launches=launches_by_kernel["rerank_gather_scores"], max_abs_err=err,
        ragged_max_abs_err=ragged[f"rerank_gather_{variant}"],
        tolerance="1e-4 + 1e-5 x max|plain|",
        tc_max_abs_err_fp64=tc_err, tc_tolerance_fp64=tc_tol,
        tc_fp64_sample="8 queries x all their candidates",
        shape=f"B {B} x k'_loc {cand.shape[1]} candidates, Tq {Tq}, Td {toks.shape[1]}, "
              f"d {d}, {variant} tokens{note}", ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, peak=PEAK_TF32_S,
        bound_split="2xTF32 (q split)" if sq8 else "3xTF32",
        bound_ms_fp32_cuda_cores=bound(nbytes, flops)[0], bytes=int(nbytes),
        flops=int(flops), library_ms=None, launches_per_search=1,
        **cuda_launches(torch, lambda: gather_scan.rerank_gather_scores(*args_k)))


# --------------------------------------------------------------------------
# mutation: churn on the served index, the residual tier and the block
# --------------------------------------------------------------------------

CHURN_ROUNDS = 2      # delete / add / update rounds on the served index
CHURN_DELETE = 1024   # random live docs deleted a round
CHURN_ADD = 1024      # new docs added a round
CHURN_UPDATE = 256    # live docs replaced a round
CHURN_ROUTES = {      # name: (SearchParams keywords, IVF keywords)
    "default": ({}, None),
    "one_launch": ({}, {"use_one_launch": True}),
    "exact_one_launch": ({"use_ann": False, "use_one_launch": True}, None),
}


def churn_docs(torch, rng, seed, n, dev, d=128, *, centers=TOPIC_CENTERS,
               strength=TOPIC_STRENGTH):
    """n new docs of the served corpus's distribution (Poisson(67.5) lengths
    in [4, 80], unit tokens about the same 4,096 topic centres: the first
    draw of a generator seeded with ``seed``, as the corpus draws them),
    dense on ``dev``; ``centers`` / ``strength`` make a topic burst instead
    (fewer centres, a heavier weight)."""
    T = 80
    cent = torch.nn.functional.normalize(torch.randn(
        centers, d, generator=torch.Generator(device=dev).manual_seed(seed), device=dev),
        dim=1)
    counts = torch.as_tensor(np.clip(rng.poisson(67.5, n), 4, T), device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    topics = torch.randint(0, centers, (n, 2), generator=g, device=dev)
    which = torch.randint(0, 2, (n, T), generator=g, device=dev)
    tok = torch.nn.functional.normalize(
        torch.randn(n, T, d, generator=g, device=dev)
        + strength * cent[topics.gather(1, which)], dim=-1)
    mask = torch.arange(T, device=dev)[None, :] < counts[:, None]
    return (tok * mask[..., None]).contiguous(), mask


@contextlib.contextmanager
def timed_parts(torch, sink):
    """Time the facade's mutation steps on a synchronized host clock: while
    open, ``indexer.fit_docs``, ``ivf.extend_ivf``, ``pages.add_docs`` and
    ``pages.delete_docs`` add their ms to ``sink`` (name -> list)."""
    from repro_torch.anns import ivf
    from repro_torch.core import indexer, pages

    saved = []

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, timed)

    wrap(indexer, "fit_docs", "fit_ms")
    wrap(ivf, "extend_ivf", "extend_ivf_ms")
    wrap(pages, "add_docs", "add_docs_ms")
    wrap(pages, "delete_docs", "delete_docs_ms")
    try:
        yield sink
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def synced_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def pick_live(torch, r, rng, n, avoid=()):
    """n distinct random live slot ids of ``r``, none in ``avoid``."""
    alive = r.index.store.alive[:r.m].clone()
    if len(avoid):
        alive[torch.as_tensor(list(avoid), device=alive.device)] = False
    live = torch.nonzero(alive).flatten().cpu().numpy()
    return np.sort(rng.choice(live, size=n, replace=False))


def check_w_rows(torch, r, ids, tok, mask):
    """The W rows of ``ids`` (just fit from ``tok``, ``mask``) against the
    plain fit: the token MaxSim targets (the kernel's output) within
    ref.TF32_SPLIT_RTOL x max(1, max|g|), and the rows within that tolerance
    carried through the solve (x the Gram matrix's condition number) x
    max|W|.  Returns the errors and tolerances."""
    from repro_torch.core import maxsim
    from repro_torch.kernels import ref

    solver, stats = r.solver_state, r.index.stats
    x = solver["x_ols"]
    g = maxsim.token_maxsim(x, tok, mask)
    g_plain = ref.token_maxsim_ref(x, tok, mask, chunk=64)
    g_err = float((g - g_plain).abs().max())
    g_tol = ref.TF32_SPLIT_RTOL * max(1.0, float(g_plain.abs().max()))
    w_plain = torch.cholesky_solve(solver["feats"].T @ ((g_plain - stats.mean) / stats.std),
                                   solver["chol"]).T
    W = r.index.store.W[torch.as_tensor(ids, device=tok.device).long()]
    sv = torch.linalg.svdvals(solver["chol"])
    cond = float((sv.max() / sv.min()) ** 2)
    w_err = float((W - w_plain).abs().max())
    w_tol = ref.TF32_SPLIT_RTOL * cond * float(w_plain.abs().max())
    require(g_err <= g_tol, f"added docs' targets: max abs err {g_err} > {g_tol}")
    require(w_err <= w_tol, f"added docs' W rows: max abs err {w_err} > {w_tol} "
                            f"(Gram condition number {cond:.3g})")
    return dict(targets_max_abs_err=g_err, targets_tol=g_tol, W_max_abs_err=w_err,
                W_tol=w_tol, gram_condition=cond)


def churn_round(torch, r, rng, seed, n_del, n_add, n_upd, gone):
    """One round through the facade: delete n_del random live docs, add n_add
    new ones, update n_upd live ones; each mutation timed (synchronized host
    clock; the add split into fit, extend_ivf and add_docs), its bytes, the
    token MaxSim launches it made, and the new W rows held to the plain
    fit.  ``gone`` collects the ids that must never be served again."""
    from repro_torch.kernels import ops

    out, parts = {}, {}
    ids = pick_live(torch, r, rng, n_del)
    ops.reset_launch_counts()
    with timed_parts(torch, parts):
        _, out["delete_ms"] = synced_ms(torch, lambda: r.delete(ids))
        out["delete_bytes"] = r.last_mutation_bytes
        gone.update(ids.tolist())
        tok, mask = churn_docs(torch, rng, seed, n_add, r.device, r.index.store.d)
        _, out["add_ms"] = synced_ms(torch, lambda: r.add(tok, mask))
        out["add_bytes"] = r.last_mutation_bytes
        added = r.last_added_ids
        out["add_parts_ms"] = {k: v[-1] for k, v in parts.items() if k != "delete_docs_ms"}
        upd = pick_live(torch, r, rng, n_upd, avoid=added.tolist())
        utok, umask = churn_docs(torch, rng, seed, n_upd, r.device, r.index.store.d)
        new_ids, out["update_ms"] = synced_ms(torch, lambda: r.update(upd, utok, umask))
        out["update_bytes"] = r.last_mutation_bytes
        gone.update(upd.tolist())
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    out["w_rows"] = check_w_rows(torch, r, added, tok, mask)
    out["w_rows_update"] = check_w_rows(torch, r, new_ids, utok, umask)
    out["added_ids"] = [int(added[0]), int(added[-1])]
    return out


def check_churned_routes(torch, r, batches, gone, routes):
    """Each route of ``routes`` on ``batches`` after churn, held to the plain
    composition (ids up to counted near-ties), the scores to exact MaxSim
    over the stored tokens, no tombstoned or deleted id in any top-k."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.core.model import pool_queries
    from repro_torch.retriever import IVFSearchParams, SearchParams
    from repro_torch.retriever.facade import first_stage

    index, st = r.index, r.index.store
    gone_t = torch.as_tensor(sorted(gone), device=st.W.device)
    line = {}
    plains = {}
    for name, (kw, bkw) in routes.items():
        params = SearchParams(**kw, backend=IVFSearchParams(**bkw) if bkw else None)
        p = r.resolve(params)
        ties = {}
        lat = []
        for i, (q, qm, _) in enumerate(batches):
            (s, ids), ms = synced_ms(torch, lambda: r.search(q, qm, params))
            lat.append(ms)
            require(s.shape == (q.shape[0], p.k) and bool(torch.isfinite(s).all())
                    and bool((ids >= 0).all()), f"churned {name}: scores or ids malformed")
            require(not bool(torch.isin(ids.long(), gone_t).any())
                    and bool(st.alive[ids.long()].all()), f"churned {name}: a deleted doc served")
            cand = first_stage(index, q, qm, p)
            if p.use_ann:
                if i not in plains:
                    plains[i] = plain_search(torch, index, q, qm, p)
                probe = stable_topk(pool_queries(index.psi, q, qm) @ index.ann.centroids.T,
                                    p.backend.nprobe)[1].int()
                kinds = classify_rows(torch, ids, s, plains[i], {"probe": probe, "cand": cand},
                                      p.k_prime)
            else:
                kinds = classify_exact(torch, st.W, None, ids, s, cand,
                                       exact_plain(torch, index, q, qm, p))
            for k, v in kinds.items():
                ties[k] = ties.get(k, 0) + v
            exact = plain_pair_scores(torch, st, q, qm, ids, chunk=32)
            torch.testing.assert_close(s, exact, rtol=1e-5, atol=1e-4)
            require(bool((s[:, :-1] >= s[:, 1:]).all()), f"churned {name}: scores not sorted")
        line[name] = dict(near_tie_rows=ties, rows_checked=sum(b[0].shape[0] for b in batches),
                          search_ms=lat)
    return line


def store_census(torch, r):
    from repro_torch.core import pages

    st, ann = r.index.store, r.index.ann
    return dict(free_pages=len(pages.free_list(st)), n_pages=st.n_pages,
                free_slots=st.capacity - r.m, capacity=st.capacity, m=r.m, alive=r.n_alive,
                list_cap=ann.capacity, pages_per_doc=st.pages_per_doc)


def mutation_phase(torch, args, r, batches, card):
    """CHURN_ROUNDS rounds of delete / add / update on the served index
    through the facade (its solver drawn by the seeded fallback: the index
    came from arrays), each round's routes checked after it.  Returns the
    mutation line."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(args.seed + 11)
    st = r.index.store
    ptrs = (st.tok_pages.data_ptr(), st.W.data_ptr(), r.index.ann.vecs.data_ptr())
    before = store_census(torch, r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    gone = set(torch.nonzero(~st.alive[:r.m]).flatten().tolist())
    rounds, launches = [], {}
    for i in range(CHURN_ROUNDS):
        rd = churn_round(torch, r, rng, args.seed, CHURN_DELETE, CHURN_ADD, CHURN_UPDATE, gone)
        for k, v in rd["launches"].items():
            launches[k] = launches.get(k, 0) + v
        ops.reset_launch_counts()
        rd["routes"] = check_churned_routes(torch, r, batches[1:2], gone, CHURN_ROUTES)
        rd["memory_allocated_change_gib"] = (torch.cuda.memory_allocated() - mem0) / 2**30
        rounds.append(rd)
        print(f"churn round {i} ok: delete {rd['delete_ms']:.1f} ms, add {rd['add_ms']:.1f} ms "
              f"({rd['add_parts_ms']}), update {rd['update_ms']:.1f} ms, routes "
              f"{ {k: v['near_tie_rows'] for k, v in rd['routes'].items()} }", flush=True)
    after = store_census(torch, r)
    st = r.index.store
    in_place = (st.tok_pages.data_ptr(), st.W.data_ptr()) == ptrs[:2]
    require(in_place or after["n_pages"] > before["n_pages"]
            or after["capacity"] > before["capacity"],
            "an add within the pool and the slot capacity copied the pool or W")
    require(launches.get("token_maxsim", 0) == 2 * CHURN_ROUNDS,
            f"mutation launches {launches}: token_maxsim once an add and an update")
    return dict(card=card, rounds=rounds, before=before, after=after,
                launches_on_mutation_path=launches, deleted_or_replaced=len(gone),
                pool_and_W_written_in_place=in_place,
                lists_written_in_place=r.index.ann.vecs.data_ptr() == ptrs[2],
                list_cap_grew=after["list_cap"] > before["list_cap"],
                pool_grew=after["n_pages"] > before["n_pages"],
                memory_allocated_change_gib=(torch.cuda.memory_allocated() - mem0) / 2**30,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                solver="seeded fallback (from_arrays keeps no OLS tokens): n_ols tokens "
                       "drawn from the pages")

# --------------------------------------------------------------------------
# online serving, the fleet router and the index lifecycle
# --------------------------------------------------------------------------

ONLINE_LADDER = ((32, 64, 128, 256), 64)   # Tq rungs, largest micro-batch
FLEET_LADDER = ((32, 64), 32)
RAGGED_TQ = (4, 64)          # query tokens, uniform over the range
ONLINE_QUERIES = 512         # distinct queries a phase; a trace cycles them
ONLINE_S = 3.0               # seconds of a timed replay
STEP_S = 1.5                 # seconds of a step of the step-up
TRACE_S = 1.0                # seconds of the traced replay at the sustained rate
STEP_P99_MS = 100.0          # a step is sustained under this p99 (from arrival)
STEP_RATES = (500, 1000, 2000, 4000, 8000, 16000, 32000)
BARRIER_QPS = 1000.0
BARRIER_QUERIES = 64         # distinct queries of the barrier run: a hold searches each once
LIFECYCLE_QPS = 400.0
SHIFT_BATCH = 512            # docs a lifecycle add
INDIST_ADDS = 2              # adds of the build's distribution that must leave the monitor quiet
SHIFT_ADDS = 16              # two-topic bursts at most, before the monitor must have triggered
COVERAGE_DOCS = 256          # docs of the coverage diagnosis (own_list_probe)
# The drift monitor on the build cell.  Its baseline is taken over as many
# docs as a full reservoir holds: the fidelity, a Pearson correlation pooled
# over (probe token, doc) pairs, reads ~0.43 over 64 docs and ~0.34 over 256
# of the same docs (PERF.md §6), so JAX's 64-doc baseline against a
# 256-doc reservoir reads a drop of 0.1 with no drift.  Coverage is reported
# and not a trigger: the build's IVF reaches a doc's own list for ~2 % of
# the docs at nprobe 32 (own_list_probe), a baseline of 0-2 of the docs,
# which a quarter of cannot resolve.
MONITOR = dict(reservoir=256, baseline_docs=256, coverage_ratio_threshold=0.0)
# the kernels a lifecycle run must launch: the served search, the drift
# monitor's fidelity probe and the refresh's refit and Gram features
LIFECYCLE_KERNELS = SERVE_KERNELS + ("token_maxsim", "fused_psi")


def ragged_queries_from(tokens, rng, n):
    """Host (Tq, d) fp32 queries: the first Tq tokens of ``n`` rows of
    ``tokens`` (a (n', T, d) tensor or array), Tq uniform over RAGGED_TQ."""
    tq = rng.integers(RAGGED_TQ[0], RAGGED_TQ[1] + 1, n)
    toks = tokens[:n].cpu().numpy() if hasattr(tokens, "cpu") else np.asarray(tokens[:n])
    return [np.ascontiguousarray(toks[i, :t], dtype=np.float32) for i, t in enumerate(tq)]


def direct_check(torch, r, queries, outcomes, params=None, want=None):
    """Every served (scores, ids) against a direct ``r.search`` of its query
    alone (``outcomes``: (query index, (scores, ids)) pairs; each distinct
    query searched once, into ``want``): ids equal, or differing only where
    the direct scores are within NEAR_TIE (relative) of each other
    (counted), scores within rtol 1e-5 / atol 1e-4."""
    want = {} if want is None else want
    ties = equal_rows = 0
    err = 0.0
    for qi, (s, ids) in outcomes:
        if qi not in want:
            q = queries[qi]
            ws, wi = r.search(q[None], np.ones((1, len(q)), bool), params)
            want[qi] = (ws[0].cpu().numpy(), wi[0].cpu().numpy())
        ws, wi = want[qi]
        require(s.shape == ws.shape and bool(np.isfinite(s[wi >= 0]).all()),
                "served result shape or values")
        fin = wi >= 0
        e = float(np.abs(s[fin] - ws[fin]).max()) if fin.any() else 0.0
        require(np.allclose(s, ws, rtol=1e-5, atol=1e-4),
                f"served scores against the direct search: max abs err {e}")
        err = max(err, e)
        diff = ids != wi
        gap = np.abs(s - ws) / np.maximum(np.abs(ws), 1.0)
        require(bool(np.all(gap[diff] < NEAR_TIE)),
                "a served id differs from the direct search without a near-tie")
        ties += int(diff.sum())
        equal_rows += int(not diff.any())
    return dict(results=len(outcomes), direct_searches=len(want), near_tie_ids=ties,
                rows_ids_equal=equal_rows, max_abs_err=err)


def summary_of(rep, keys=("p50_ms", "p95_ms", "p99_ms", "submit_p50_ms", "submit_p95_ms",
                          "submit_p99_ms", "qps", "offered_qps", "n_requests", "n_rejected",
                          "n_expired", "n_lost")):
    return {k: rep[k] for k in keys if k in rep}


def step_up(torch, target, queries, seed, rates=None):
    """Short open-loop replays at rising rates: the highest rate ``target``
    (a server or a router) sustains — nothing lost, rejected or expired,
    completed QPS >= 90 % of the trace's offered rate and p99 from scheduled
    arrival under STEP_P99_MS — and one step between it and the first that
    fails."""
    from repro_torch.serving import poisson_trace, replay

    def step(rate):
        _, rep = replay(target, queries, poisson_trace(rate, STEP_S, seed), timeout=300)
        ok = (rep["n_lost"] == 0 and rep["n_rejected"] == 0 and rep["n_expired"] == 0
              and rep["qps"] >= 0.9 * rep["offered_qps"] and rep["p99_ms"] < STEP_P99_MS)
        steps.append(dict(rate=rate, offered_qps=rep["offered_qps"], qps=rep["qps"],
                          p99_ms=rep["p99_ms"],
                          mean_occupancy=rep.get("mean_occupancy"), sustained=ok))
        return ok

    steps, best, failed = [], None, None
    for rate in rates or STEP_RATES:
        if not step(rate):
            failed = rate
            break
        best = rate
    require(best is not None, f"no rate sustained in the step-up: {steps}")
    if failed is not None:
        mid = float(np.sqrt(best * failed))
        if step(mid):
            best = mid
    return float(best), steps


class RecordingTarget:
    """A server or router whose submits are recorded, in order, under
    ``lock`` (with a completion time each): a barrier taken under the same
    lock splits the requests into those before and after it."""

    def __init__(self, target):
        self.target = target
        self.lock = threading.Lock()
        self.futs = []
        self.done_t = {}

    def submit(self, *a, **kw):
        with self.lock:
            f = self.target.submit(*a, **kw)
            self.futs.append(f)
        done_t = self.done_t           # the callback holds the dict, not self: no cycle
        f.add_done_callback(lambda f: done_t.setdefault(id(f), time.perf_counter()))
        return f

    def __getattr__(self, name):
        return getattr(self.target, name)


def online_phase(torch, args, r, card):
    """The served (churned) index behind a RetrieverServer: warm every
    bucket, step up to the highest sustained rate, replay at 1,000 QPS and
    at about 50 % and 90 % of it (every result against a direct search of
    its query alone, the kernels' launches a micro-batch), then a 1,000 QPS
    replay with an add, a delete and an update barrier (each version's
    results checked under the facade's lock before its barrier applies)."""
    from repro_torch.kernels import ops
    from repro_torch.retriever import SearchParams
    from repro_torch.serving import (BucketLadder, RetrieverServer, pad_single,
                                     poisson_trace, replay, warm_buckets)

    t_all = time.time()
    rng = np.random.default_rng(args.seed + 31)
    st = r.index.store
    d = st.d
    q64, _, _ = make_queries(torch, st, rng, ONLINE_QUERIES, Tq=RAGGED_TQ[1])
    queries = ragged_queries_from(q64, rng, ONLINE_QUERIES)
    del q64
    ladder = BucketLadder(*ONLINE_LADDER)
    p = r.resolve(SearchParams())
    line = dict(card=card, m=r.m, ladder=list(ladder.tq_ladder), max_batch=ladder.max_batch,
                q_tokens=list(RAGGED_TQ), distinct_queries=ONLINE_QUERIES,
                params=dict(k=p.k, k_prime=p.k_prime, nprobe=p.backend.nprobe))
    tc0 = r.trace_count()
    t0 = time.time()
    line["warmed_shapes"] = warm_buckets(r, ladder, d)
    torch.cuda.synchronize()
    line["warm_s"] = time.time() - t0

    with RetrieverServer(r, ladder=ladder, max_wait_us=2000) as srv:
        tc_served = r.trace_count()
        best, steps = step_up(torch, srv, queries, args.seed)
        line["step_up"] = dict(steps=steps, sustained_qps=best, step_s=STEP_S,
                               p99_bound_ms=STEP_P99_MS)
        print(f"online step-up: sustained {best:.0f} QPS ({steps})", flush=True)
        rates = {"qps_1000": 1000.0, "sustained_50pct": 0.5 * best,
                 "sustained_90pct": 0.9 * best}
        if abs(0.5 * best - 1000.0) < 100.0:     # half the sustained rate is 1,000 QPS
            del rates["sustained_50pct"]
            rates["sustained_70pct"] = 0.7 * best
        runs, outcomes = {}, []
        for name, rate in rates.items():
            arrivals = poisson_trace(rate, ONLINE_S, args.seed + 1)
            ops.reset_launch_counts()
            res, rep = replay(srv, queries, arrivals, timeout=300)
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            nb = rep["n_batches"]
            require(launches == {k: nb for k in SERVE_KERNELS},
                    f"online {name}: launches {launches} over {nb} micro-batches")
            require(rep["n_lost"] == 0 and not any(isinstance(x, Exception) for x in res),
                    f"online {name}: {rep['n_lost']} lost, "
                    f"{sum(isinstance(x, Exception) for x in res)} rejected or expired")
            outcomes += [(i % len(queries), x) for i, x in enumerate(res)]
            runs[name] = dict(rate=rate, **summary_of(rep), mean_occupancy=rep["mean_occupancy"],
                              occupancy_hist=rep["occupancy_hist"],
                              bucket_hist=rep["bucket_hist"], n_batches=nb,
                              launches_per_micro_batch={k: v / nb for k, v in launches.items()})
            print(f"online {name}: {json.dumps(runs[name])}", flush=True)
        line["trace_count"] = dict(served=r.trace_count() - tc_served,
                                   with_warmup=r.trace_count() - tc0,
                                   compile_bound=ladder.compile_bound())
        require(r.trace_count() - tc0 <= ladder.compile_bound(),
                f"served shapes {r.trace_count() - tc0} > bound {ladder.compile_bound()}")
        t0 = time.time()
        line["checks"] = direct_check(torch, r, queries, outcomes)
        line["checks"]["s"] = time.time() - t0
        # padding: a query padded to its rung against the raw query, bit for bit
        pad_bits = dict(queries=64, scores_equal=0, ids_equal=0)
        for q in queries[:64]:
            qp, mp = pad_single(q, np.ones(len(q), bool), ladder.tq_bucket(len(q)))
            s0, i0 = r.search(q[None], np.ones((1, len(q)), bool))
            s1, i1 = r.search(qp[None], mp[None])
            pad_bits["scores_equal"] += int(torch.equal(s0, s1))
            pad_bits["ids_equal"] += int(torch.equal(i0, i1))
        line["padded_query_bits"] = pad_bits
        require(pad_bits["scores_equal"] == pad_bits["ids_equal"] == pad_bits["queries"],
                f"a query padded to its rung answers other bits than the raw query: {pad_bits}")
        line["runs"] = runs
        # traced at the lowest rate the step-up did not sustain: the server saturated
        sat = min((st["rate"] for st in steps if not st["sustained"] and st["rate"] > best),
                  default=2.0 * best)
        line["trace"] = trace_replay(torch, srv, queries, sat, args.seed + 3)
        print(f"online trace: {json.dumps(line['trace'])}", flush=True)
        line["barriers"] = barrier_run(torch, args, r, srv, queries, rng)
    line["s"] = time.time() - t_all
    return line


def trace_replay(torch, srv, queries, rate, seed):
    """A TRACE_S replay at ``rate`` under torch.profiler: the card's busy
    time (the union of its kernels' and copies' intervals) against the
    traced wall time, each a micro-batch; the server worker's time in its
    micro-batches (pad, copy in, search, copy out — it waits for the card
    there — and the futures; host clock around ``_run_batch``); and the
    runtime calls in the card's idle gaps (``idle_gaps``).  Tracing adds
    host cost, so these are not the latencies of the untraced runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import poisson_trace, replay

    worker = []
    run_batch = srv._run_batch

    def timed(batch):
        t = time.perf_counter()
        run_batch(batch)
        worker.append(time.perf_counter() - t)

    torch.cuda.synchronize()
    srv._run_batch = timed
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res, rep = replay(srv, queries, poisson_trace(rate, TRACE_S, seed), timeout=300)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del srv._run_batch
    require(rep["n_lost"] == 0, "traced replay: a request lost")
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    require(busy_ms > 0, "traced replay: no device activity in the trace")
    nb = rep["n_batches"]
    return dict(rate=rate, s=TRACE_S, n_requests=rep["n_requests"], n_batches=nb,
                mean_occupancy=rep["mean_occupancy"], qps=rep["qps"], p99_ms=rep["p99_ms"],
                wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms if wall_ms else None,
                device_events=len(dev), wall_ms_per_micro_batch=wall_ms / max(nb, 1),
                device_ms_per_micro_batch=busy_ms / max(nb, 1),
                worker_busy_ms=1e3 * sum(worker),
                worker_busy_share=1e3 * sum(worker) / wall_ms if wall_ms else None,
                worker_ms_per_micro_batch=1e3 * sum(worker) / max(len(worker), 1),
                idle_gaps=idle_gaps(torch, events))


def barrier_run(torch, args, r, srv, queries, rng):
    """A BARRIER_QPS replay of BARRIER_QUERIES distinct queries with an add,
    a delete and an update barrier at a quarter, a half and three quarters
    of it.  At each barrier the facade's lock is held (the worker cannot
    apply it) while the requests submitted before it resolve and are held
    against direct searches of the version they were served at (each
    distinct query once); the requests after it must be served at a later
    version and never return a deleted doc."""
    from repro_torch.serving import poisson_trace, replay

    dev = r.device
    queries = queries[:BARRIER_QUERIES]
    rec = RecordingTarget(srv)
    tok, mask = churn_docs(torch, rng, args.seed, 2, dev, r.index.store.d)
    victims = pick_live(torch, r, rng, 2)
    plan = [(0.25, "add", lambda: srv.add(tok[:1], mask[:1])),
            (0.5, "delete", lambda: srv.delete(victims[:1])),
            (0.75, "update", lambda: srv.update(victims[1:], tok[1:], mask[1:]))]
    barriers, errors = [], []
    checked = {}                           # future id -> check done
    v_start = r.version
    mem0 = torch.cuda.memory_allocated()

    def check_before(n_before, version, want):
        outs = []
        for i, f in enumerate(rec.futs[:n_before]):
            if id(f) in checked:
                continue
            x = f.result(timeout=120)
            require(getattr(f, "snapshot_version", None) == version,
                    f"a request before the barrier answered at version "
                    f"{getattr(f, 'snapshot_version', None)}, not {version}")
            checked[id(f)] = True
            outs.append((i % len(queries), x))
        return direct_check(torch, r, queries, outs, want=want)

    def run_barriers(t0):
        try:
            for frac, kind, enqueue in plan:
                time.sleep(max(0.0, t0 + frac * ONLINE_S - time.perf_counter()))
                t_b = time.perf_counter()
                with r.lock:                    # no mutation until this version is checked
                    with rec.lock:
                        n_before = len(rec.futs)
                        mf = enqueue()
                    version = r.version
                    chk = check_before(n_before, version, {})
                mf.result(timeout=120)
                barriers.append(dict(kind=kind, at_s=frac * ONLINE_S, n_before=n_before,
                                     version_before=version,
                                     snapshot_version=mf.snapshot_version,
                                     result=np.asarray(mf.result()).tolist(),
                                     hold_s=time.perf_counter() - t_b, checks=chk))
        except Exception as e:    # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    t0 = time.perf_counter()
    th = threading.Thread(target=run_barriers, args=(t0,), daemon=True)
    th.start()
    res, rep = replay(rec, queries, poisson_trace(BARRIER_QPS, ONLINE_S, args.seed + 2),
                      timeout=300)
    th.join(timeout=300)
    require(not th.is_alive(), "the barrier thread hung")
    if errors:
        raise errors[0]
    require(len(barriers) == 3 and [b["snapshot_version"] for b in barriers]
            == [v_start + 1, v_start + 2, v_start + 3], f"barrier versions {barriers}")
    require(rep["n_lost"] == 0 and not any(isinstance(x, Exception) for x in res),
            "barrier run: a request lost, rejected or expired")
    # after each barrier: a later version, and no deleted doc
    gone = set(victims.tolist())
    for b in barriers:
        for f in rec.futs[b["n_before"]:]:
            require(f.snapshot_version >= b["snapshot_version"],
                    f"a request after the {b['kind']} barrier answered at version "
                    f"{f.snapshot_version} < {b['snapshot_version']}")
    for f in rec.futs:
        if f.snapshot_version >= v_start + 2:
            require(not gone.intersection(f.result()[1].tolist()),
                    "a deleted doc served after the delete barrier")
    final = check_before(len(rec.futs), r.version, {})
    return dict(rate=BARRIER_QPS, **summary_of(rep), barriers=barriers, final_version_checks=final,
                memory_allocated_change_gib=(torch.cuda.memory_allocated() - mem0) / 2**30,
                note="latency includes the barriers' holds (each version's results checked "
                     "under the facade's lock before its barrier applies)")


def fleet_phase(torch, args, r, corpus, card):
    """Two clones of the build cell's trained index behind a Router: the
    rate the two sustain (a step-up), then a replay at half of it with the
    SLO controller's target set below any latency (one downshift to the
    second rung) and raised past any (one recovery), an add barrier at a
    quarter of it and a replica killed at half; every accepted request
    resolved exactly once, the results after the add held against direct
    searches of replica 0 at the rung that answered them."""
    from repro_torch.data.synthetic import queries_from_corpus_query
    from repro_torch.fleet import Router, SLOController, build_rungs, clone_replicas, warm_replicas
    from repro_torch.kernels import ops
    from repro_torch.serving import BucketLadder, poisson_trace, replay

    t_all = time.time()
    rng = np.random.default_rng(args.seed + 41)
    dev = r.device
    queries = ragged_queries_from(queries_from_corpus_query(
        corpus, ONLINE_QUERIES, q_tokens=RAGGED_TQ[1], seed=QUERY_SEED + 1), rng, ONLINE_QUERIES)
    ladder = BucketLadder(*FLEET_LADDER)
    reps = clone_replicas(r, 2)
    rungs = build_rungs(reps[0], n_rungs=2)
    t0 = time.time()
    warmed = warm_replicas(reps, ladder, corpus.d, params_list=rungs)
    torch.cuda.synchronize()
    line = dict(card=card, m=r.m, replicas=2, ladder=list(ladder.tq_ladder),
                max_batch=ladder.max_batch, warmed_shapes=warmed, warm_s=time.time() - t0,
                rungs=[dict(k_prime=p.k_prime, nprobe=p.backend.nprobe) for p in rungs])
    with Router(reps, ladder=ladder, max_queue_depth=None) as router:
        best, steps = step_up(torch, router, queries, args.seed)
    line["step_up"] = dict(steps=steps, sustained_qps=best)
    rate = 0.5 * best
    print(f"fleet step-up: two replicas sustain {best:.0f} QPS; replaying at {rate:.0f}",
          flush=True)
    slo = SLOController(rungs, target_p99_ms=1e-6, window=64, min_window=16, eval_every=16,
                        hold=2)
    tok, mask = churn_docs(torch, rng, args.seed + 1, 1, dev, corpus.d)  # the build's centres
    side, errors = {}, []
    dur = 4.0

    def chaos(router, t0):
        try:
            time.sleep(max(0.0, t0 + 0.25 * dur - time.perf_counter()))
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            af = router.add(tok, mask)
            m_new = af.result(timeout=300)
            torch.cuda.synchronize()
            side["add"] = dict(m=m_new, snapshot_version=af.snapshot_version,
                               replica_versions=[rp.version for rp in reps],
                               memory_before_gib=mem0 / 2**30,
                               memory_after_gib=torch.cuda.memory_allocated() / 2**30)
            time.sleep(max(0.0, t0 + 0.5 * dur - time.perf_counter()))
            side["kill"] = dict(at_s=time.perf_counter() - t0, rehomed=router.kill_replica(1))
            time.sleep(max(0.0, t0 + 0.625 * dur - time.perf_counter()))
            slo.target_p99_ms = 1e9
            side["target_raised_at_s"] = time.perf_counter() - t0
        except Exception as e:    # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    ops.reset_launch_counts()
    with Router(reps, ladder=ladder, slo=slo, max_queue_depth=None) as router:
        rec = RecordingTarget(router)
        v0 = router.version
        t_replay = time.perf_counter()
        th = threading.Thread(target=chaos, args=(router, t_replay), daemon=True)
        th.start()
        res, rep = replay(rec, queries, poisson_trace(rate, dur, args.seed + 3), timeout=300)
        th.join(timeout=300)
        require(not th.is_alive(), "the fleet's side thread hung")
        if errors:
            raise errors[0]
        quarantined, stats = router.quarantined(), router.stats.summary()
        n_completed = router.stats.n_completed
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    # exactly once: every accepted request resolved, one outcome each
    rids = [f.request_id for f in rec.futs]
    n_ok = sum(isinstance(x, tuple) for x in res)
    require(len(set(rids)) == len(rids) == len(res) and all(f.done() for f in rec.futs),
            "fleet: duplicate request ids or unresolved requests")
    require(rep["n_lost"] == 0 and n_ok == len(res) == n_completed,
            f"fleet: {len(res)} requests, {n_ok} results, {n_completed} completions, "
            f"{rep['n_lost']} lost")
    require(quarantined == [1], f"fleet: quarantined {quarantined}")
    add = side["add"]
    require(add["snapshot_version"] == v0 + 1 and add["replica_versions"] == [v0 + 1] * 2,
            f"fleet add barrier: {add}")
    after = [(i % len(queries), x, f.params) for i, (f, x) in enumerate(zip(rec.futs, res))
             if f.snapshot_version == v0 + 1]
    checks = {}
    for j, p in enumerate(rungs):
        outs = [(qi, x) for qi, x, fp in after if fp == p]
        checks[f"rung_{j}"] = direct_check(torch, reps[0], queries, outs, params=p)
    downs = [t for t in slo.transitions if t.direction == "down"]
    ups = [t for t in slo.transitions if t.direction == "up"]
    require(len(downs) == 1 and len(ups) == 1,
            f"SLO transitions {[(t.from_rung, t.to_rung) for t in slo.transitions]}")
    for k in SERVE_KERNELS:
        require(launches.get(k, 0) >= 1, f"fleet: {k} not launched ({launches})")
    line.update(rate=rate, **summary_of(rep), n_redispatched=stats["n_redispatched"],
                n_failed=stats["n_failed"], exactly_once=dict(accepted=len(res), results=n_ok,
                                                              completions=n_completed),
                add_barrier=add, kill=side["kill"], target_raised_at_s=side["target_raised_at_s"],
                quarantined=quarantined, floor_breaches=slo.n_floor_breaches,
                rung_transitions=[dict(at_s=t.t - t_replay, from_rung=t.from_rung,
                                       to_rung=t.to_rung, p99_ms=t.p99_ms, target_ms=t.target_ms)
                                  for t in slo.transitions],
                checks_after_add=checks, launches=launches, s=time.time() - t_all)
    return line


def same_bits(torch, x, y, rows=1 << 16):
    """``torch.equal`` a block of rows at a time: the equality's temporary
    of an 8 GiB list tensor would not fit beside two refreshes."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dim() == 0:
        return torch.equal(x, y)
    return all(torch.equal(x[i:i + rows], y[i:i + rows]) for i in range(0, x.shape[0], rows))


def own_list_probe(torch, r, ids):
    """Why the drift monitor's coverage is what it is: for the docs ``ids``
    with their own tokens as the query, the rank of the doc's own IVF list
    among the lists the probe orders by q . c (the build assigns a row to a
    list by L2, argmax x . c - |c|^2 / 2, and the search probes by inner
    product: JAX's rules, ``repro/anns/ivf.py:110`` and ``:241``), the
    share whose own list the default nprobe reaches, the share the first
    stage returns (coverage), and the share the exact latent scan (top-k'
    of q . W over every slot) returns."""
    from repro_torch.anns.base import stable_topk
    from repro_torch.anns.ivf import assign_clusters
    from repro_torch.core import pages
    from repro_torch.core.model import pool_queries
    from repro_torch.retriever import SearchParams

    p = r.resolve(SearchParams())
    with r.lock, torch.inference_mode():
        idx = r.index
        ann = idx.ann
        sel = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=r.device)
        toks, mask = pages.gather_docs(idx.store, sel.int())
        pq = pool_queries(idx.psi, toks, mask)
        w = idx.store.W[sel]
        own = assign_clusters(w - ann.mean[None] if ann.mean is not None else w, ann.centroids)
        cs = pq @ ann.centroids.T
        rank = (cs > cs.gather(1, own[:, None])).sum(1).float()
        cand = r.candidates(toks, mask).long()
        lat = stable_topk(pq @ idx.store.W[:idx.m].T, p.k_prime)[1].long()
    return dict(docs=len(sel), nlist=int(ann.centroids.shape[0]), nprobe=p.backend.nprobe,
                own_list_rank_quantiles={str(x): float(rank.quantile(x))
                                         for x in (0.1, 0.25, 0.5, 0.75, 0.9)},
                own_list_probed=float((rank < p.backend.nprobe).float().mean()),
                coverage=float((cand == sel[:, None]).any(1).float().mean()),
                latent_self_retrieval=float((lat == sel[:, None]).any(1).float().mean()),
                valid_candidates=float((cand >= 0).sum(1).float().mean()))


def lifecycle_phase(torch, args, r, corpus, card):
    """The build cell's trained index behind a RetrieverServer with a
    DriftMonitor (coverage reported, not a trigger: MONITOR): docs of the
    build corpus's distribution, which must leave it quiet, a six-topic
    burst (recorded), then two-topic bursts added until it triggers; a
    LifecycleManager refreshes in the background while an open-loop replay
    goes on, and warm-swaps through ``apply``; docs of the build's
    distribution again, which must leave the recalibrated monitor quiet;
    then two refreshes of one snapshot with one seed, held bit for bit.
    The launches are counted over the managed replay and refresh, and over
    the two refreshes, apart from the warm-up and the monitor's attach."""
    from repro_torch.data.synthetic import queries_from_corpus_query
    from repro_torch.kernels import ops
    from repro_torch.lifecycle import (DriftMonitor, LifecycleManager, RefreshFailed,
                                       SwapAborted, SwapCompleted, build_refresh)
    from repro_torch.serving import (BucketLadder, RetrieverServer, poisson_trace, replay,
                                     warm_buckets)

    t_all = time.time()
    rng = np.random.default_rng(args.seed + 51)
    dev, d = r.device, corpus.d
    queries = ragged_queries_from(queries_from_corpus_query(
        corpus, ONLINE_QUERIES, q_tokens=RAGGED_TQ[1], seed=QUERY_SEED + 2), rng, ONLINE_QUERIES)
    ladder = BucketLadder(*FLEET_LADDER)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    def drift(rep):
        return dict(coverage=rep.coverage, baseline_coverage=rep.baseline_coverage,
                    fidelity=rep.fidelity, baseline_fidelity=rep.baseline_fidelity,
                    skew=rep.skew, n_reservoir=rep.n_reservoir, triggered=rep.triggered,
                    reason=rep.reason)

    def add(srv, seed, **burst):
        tok, mask = churn_docs(torch, rng, seed, SHIFT_BATCH, dev, d, **burst)
        srv.add(tok, mask).result(timeout=300)
        return r.last_added_ids.copy()

    reports = {"in_distribution": [], "two_topic_bursts": []}
    mon = DriftMonitor(r, seed=args.seed, **MONITOR)

    def on_event(ev):
        if isinstance(ev, SwapCompleted):   # the same reservoir, before the reset
            reports["after_swap"] = drift(mon.report())

    def lists(ann):
        c = ann.counts.float()
        return dict(nlist=int(c.numel()), cap=ann.capacity, max=int(c.max()),
                    median=float(c.median()), lists_le_3=float((c <= 3).float().mean()))

    probe_ids = np.sort(rng.choice(r.m, COVERAGE_DOCS, replace=False))
    line = dict(card=card, m=r.m, ladder=list(ladder.tq_ladder), max_batch=ladder.max_batch,
                monitor=MONITOR, ivf_lists_before=lists(r.index.ann),
                coverage_diagnosis={"build_docs_build_fit": own_list_probe(torch, r, probe_ids)})
    with RetrieverServer(r, ladder=ladder) as srv:
        warm_buckets(r, ladder, d)
        t0 = time.time()
        mon.attach()
        line["attach_s"] = time.time() - t0
        # JAX's default baseline, over 64 docs, beside MONITOR's over 256
        line["baseline_64_docs"] = dict(zip(("fidelity", "coverage"), DriftMonitor(
            r, seed=args.seed)._measure_baseline()))
        torch.cuda.synchronize()
        mem_add = torch.cuda.memory_allocated()
        for i in range(INDIST_ADDS):
            add(srv, args.seed + 1)              # the build corpus's topic centres
            if i == 0:
                torch.cuda.synchronize()
                line["first_add_memory_change_gib"] = (
                    torch.cuda.memory_allocated() - mem_add) / 2**30
            rep = mon.report()
            reports["in_distribution"].append(drift(rep))
            require(not rep.triggered, f"the monitor triggered on docs of the build's "
                                       f"distribution (add {i + 1}): {rep}")
        add(srv, args.seed + 1000, centers=6, strength=4.0)
        reports["six_topic_burst"] = drift(mon.report())
        n_shift = 0
        for n_shift in range(1, SHIFT_ADDS + 1):
            burst_ids = add(srv, args.seed + 2000, centers=2, strength=4.0)
            rep = mon.report()
            reports["two_topic_bursts"].append(drift(rep))
            if rep.triggered:
                break
        require(rep.triggered, f"the monitor did not trigger after {n_shift} two-topic "
                               f"bursts: {rep}")
        line["two_topic_burst_docs"] = n_shift * SHIFT_BATCH
        print(f"lifecycle: drift {reports}", flush=True)

        rec = RecordingTarget(srv)
        mgr = LifecycleManager(srv, monitor=mon, seed=args.seed, cooldown_s=0.0,
                               min_reservoir=16, swap_timeout_s=600.0, on_event=on_event)
        chunks = []
        ops.reset_launch_counts()            # the managed replay and refresh alone
        mgr.start(auto=True)
        try:
            t_end = time.time() + 300
            while time.time() < t_end:
                t_chunk = time.perf_counter()
                res, rep = replay(rec, queries, poisson_trace(LIFECYCLE_QPS, 2.0,
                                                              args.seed + len(chunks)),
                                  timeout=300)
                chunks.append(dict(**summary_of(rep), dropped=rep["n_lost"] + sum(
                    not isinstance(x, tuple) for x in res)))
                swaps = mgr.events(SwapCompleted)
                if mgr.events(RefreshFailed) or mgr.events(SwapAborted):
                    break
                if swaps and swaps[0].t < t_chunk:
                    break
        finally:
            mgr.stop(timeout=600)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        evs = {type(e).__name__: e for e in mgr.events()}
        require("SwapCompleted" in evs and "RefreshFailed" not in evs
                and "SwapAborted" not in evs,
                f"lifecycle events {[e.kind for e in mgr.events()]}")
        for k in LIFECYCLE_KERNELS:
            require(launches.get(k, 0) >= 1,
                    f"lifecycle: {k} not launched in the managed replay and refresh ({launches})")
        t_start, t_done = evs["RefreshStarted"].t, evs["RefreshCompleted"].t
        t_swap = evs["SwapCompleted"].t
        done = list(rec.done_t.values())
        dropped = sum(c["dropped"] for c in chunks)
        require(dropped == 0, f"lifecycle: {dropped} searches dropped")
        res_ = mgr.last_refresh_result
        line["coverage_diagnosis"].update(
            build_docs_refreshed_fit=own_list_probe(torch, r, probe_ids),
            burst_docs_refreshed_fit=own_list_probe(torch, r, burst_ids[-COVERAGE_DOCS:]))
        mon.attach()      # the manager's stop detached it; the baseline, of the new fit
        add(srv, args.seed + 1)                  # the build's distribution again
        rep = mon.report()
        reports["in_distribution_after_swap"] = drift(rep)
        require(not rep.triggered, f"the monitor, recalibrated at the swap, triggered on "
                                   f"docs of the build's distribution: {rep}")
        line.update(
            drift=reports, events=[e.kind for e in mgr.events()],
            refresh_s=res_.wall_s, refresh_phase_s=res_.phase_s,
            install_s=t_swap - t_done, swap_version=evs["SwapCompleted"].version,
            caught_up=evs["SwapCompleted"].caught_up,
            searches_during_refresh=sum(t_start <= t <= t_done for t in done),
            searches_during_refresh_and_install=sum(t_start <= t <= t_swap for t in done),
            searches=len(done), dropped=dropped, replay_qps=LIFECYCLE_QPS, chunks=chunks,
            ivf_lists_after=lists(r.index.ann))
    mon.detach()
    require("after_swap" in reports, "no drift report after the swap")
    # the installed refresh's W and lists, which the post-swap add copied
    del mgr, res_, rec, mon
    torch.cuda.empty_cache()

    # two refreshes of one snapshot with one seed, bit for bit
    ops.reset_launch_counts()
    a = build_refresh(r, seed=args.seed + 5)
    b = build_refresh(r, seed=args.seed + 5)
    torch.cuda.synchronize()
    launches_refreshes = {k: v for k, v in ops.launch_counts().items() if v}
    for k in ("token_maxsim", "fused_psi"):
        require(launches_refreshes.get(k, 0) >= 2,
                f"two refreshes: {k} not launched by each ({launches_refreshes})")
    same = dict(W=same_bits(torch, a.W, b.W), **{
        f"solver_{k}": same_bits(torch, a.solver[k], b.solver[k])
        for k in ("chol", "feats", "x_ols")},
        **{f"ann_{k}": same_bits(torch, v, getattr(b.ann, k))
           for k, v in a.ann._asdict().items() if v is not None})
    require(all(same.values()), f"two refreshes of one snapshot differ: {same}")
    line.update(refresh_bits_equal=same, refresh_twice_s=[a.wall_s, b.wall_s],
                refresh_twice_phase_s=[a.phase_s, b.phase_s], launches=launches,
                launches_two_refreshes=launches_refreshes,
                memory_change_gib=(torch.cuda.memory_allocated() - mem0) / 2**30,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, s=time.time() - t_all)
    return line


# --------------------------------------------------------------------------
# the other first-stage backends behind the registry
# --------------------------------------------------------------------------

BACKEND_NAMES = ("bruteforce", "muvera", "dessert", "token_pruning")
BACKEND_BATCHES = 9       # a warm-up and 8 timed batches a backend
BACKEND_ROUND = 1024      # adds and deletes of each backend's round
PLAIN_QUERIES = {"bruteforce": 16, "muvera": 16, "dessert": 2, "token_pruning": 4}
FDE_CHECK_DOCS = 2048     # stored doc FDEs recomputed in fp64


def ivf_through_registry(torch, r, batch):
    """The IVF backend reached through the registry and composed by hand
    (the psi-pool, its search, the tombstone mask, the paged rerank) against
    the default route: ids and scores bit for bit."""
    from repro_torch.anns import registry
    from repro_torch.anns.base import QueryBatch
    from repro_torch.core import pages
    from repro_torch.core.model import pool_queries
    from repro_torch.kernels import ops
    from repro_torch.retriever import SearchParams

    q, qm, _ = batch
    st, p = r.index.store, r.resolve(SearchParams())
    s, ids = r.search(q, qm)
    be = registry.get_backend("ivf")
    _, cand = be.search(r.index.ann, QueryBatch(pool_queries(r.index.psi, q, qm), q, qm),
                        p.k_prime, p.backend)
    s2, ids2 = ops.fused_rerank_paged(q, qm, pages.mask_dead(st, cand), st.tok_pages,
                                      st.page_table, st.n_tokens, p.k)
    require(torch.equal(ids, ids2) and torch.equal(s, s2),
            "ivf through the registry: ids or scores differ from the default route")
    return dict(rows=int(q.shape[0]), ids_and_scores_bit_equal=True)


def plain_first_stage(torch, r, q, qm, k):
    """The backend's first stage in the JAX package's form on the port's
    pooled latent and the query tokens -> (scores, ids) before the tombstone
    mask: bruteforce the full latent product; MUVERA the full product of the
    query FDEs and the doc FDEs in fp64 (the FDEs themselves are held to
    fp64 by check_fdes); DESSERT the (B, m, L, Tq) lookup over every doc;
    token pruning each token's probed lists gathered whole."""
    from repro_torch.anns import dessert, muvera
    from repro_torch.anns import token_pruning as tp
    from repro_torch.anns.base import stable_topk
    from repro_torch.core.model import pool_queries

    name, ann = r.backend, r.index.ann
    if name == "bruteforce":
        return stable_topk(pool_queries(r.index.psi, q, qm) @ ann["W"].T, k)
    if name == "muvera":
        qf = muvera.query_fde(q, qm, ann.mcfg, ann.parts)
        top, ids = stable_topk(qf.double() @ ann.dfde.double().T, k)
        return top.float(), ids
    if name == "dessert":
        return dessert.search_dessert_direct(ann, q, qm, k_prime=k)
    return tp.search_token_pruning_direct(ann.index, q, qm, nprobe=8, k_prime=k, m=ann.m)


def check_backend(torch, r, batch, gone, what):
    """The backend's candidates for a few queries against its plain first
    stage (ids up to counted near-ties), the served top-100 of the batch
    against the plain rerank of the same candidates, no tombstoned or
    deleted id served.  Returns the near-tie counts."""
    from repro_torch.anns import registry
    from repro_torch.anns.base import QueryBatch
    from repro_torch.core.model import pool_queries
    from repro_torch.retriever import SearchParams

    q, qm, _ = batch
    st, p = r.index.store, r.resolve(SearchParams())
    n = PLAIN_QUERIES[r.backend]
    be = registry.get_backend(r.backend)
    got_s, got_i = be.search(r.index.ann, QueryBatch(pool_queries(r.index.psi, q[:n], qm[:n]),
                                                     q[:n], qm[:n]), p.k_prime, p.backend)
    want_s, want_i = plain_first_stage(torch, r, q[:n], qm[:n], p.k_prime)
    _, fs_ties, _ = same_topk(torch, got_s, got_i.long(), want_s, want_i.long(), 1e-5,
                              f"{what}: first stage", exact_ties=False)
    s, ids = r.search(q, qm)
    cand = r.candidates(q, qm)
    top, pids = plain_rerank(torch, st, q, qm, cand, p.k)
    err, rr_ties, _ = same_topk(torch, s, ids, top, pids, 1e-5, f"{what}: top-{p.k}",
                                exact_ties=False)
    gone_t = torch.as_tensor(sorted(gone) or [-2], device=q.device)
    require(bool((ids >= 0).all()) and bool(st.alive[ids.long()].all())
            and not bool(torch.isin(ids.long(), gone_t).any())
            and not bool(torch.isin(cand.long(), gone_t).any()),
            f"{what}: a tombstoned or deleted doc served")
    out = dict(first_stage_queries=n, first_stage_near_tie_ids=fs_ties,
               rows=int(q.shape[0]), near_tie_ids=rr_ties, max_abs_err=err)
    if r.backend == "muvera":
        out["fdes_fp64"] = check_fdes(torch, r, what)
    return out


def check_fdes(torch, r, what):
    """The stored doc FDEs of the first FDE_CHECK_DOCS slots against the
    FDEs recomputed in fp64 from the pages, within 1e-5 x max(1, max|FDE|),
    on the live slots (a doc deleted after the build reads back all-masked)
    whose tokens hash to the same buckets in both precisions; a token whose
    bucket differs must have a dot with a plane within 1e-5 ||token||
    ||plane|| of 0 (the sign of a rounding).  Returns (max abs err, docs
    held, docs with a flipped bucket)."""
    from repro_torch.anns import muvera

    ann, n = r.index.ann, min(FDE_CHECK_DOCS, r.m)
    toks, tmask = r.index.read_docs(0, n)
    p64 = muvera.MuveraParts(*(None if t is None else t.double() for t in ann.parts))
    flip = ((muvera.bucket_ids(toks, ann.parts.hyper) != muvera.bucket_ids(toks.double(),
                                                                          p64.hyper))
            & tmask[:, None, :])                                   # (n, R, T)
    hyp = ann.parts.hyper.reshape(-1, toks.shape[-1])
    dots = toks @ hyp.T                                            # (n, T, R k)
    near = dots.abs() < 1e-5 * toks.norm(dim=-1)[..., None] * hyp.norm(dim=-1)
    require(not bool((flip.any(1) & ~near.any(-1)).any()),
            f"{what}: a token's bucket flips without a near-zero dot")
    want = muvera.doc_fde(toks.double(), tmask, ann.mcfg, p64)
    held = r.index.store.alive[:n] & ~flip.any(-1).any(-1)
    err = float((ann.dfde[:n][held].double() - want[held]).abs().max())
    tol = 1e-5 * max(1.0, float(want[held].abs().max()))
    require(err <= tol, f"{what}: stored doc FDEs differ from fp64 by {err} > {tol}")
    return dict(max_abs_err=err, tol=tol, docs_held=int(held.sum()),
                docs_with_a_flipped_bucket=int(flip.any(-1).any(-1).sum()))


def paged_rerank(torch, r, q, qm, cand, k):
    """The served rerank of ``r``'s store on ``cand``: the residual paged
    kernel on the compressed tier, the fp32 one otherwise."""
    from repro_torch.kernels import ops

    st = r.index.store
    if st.residual:
        return ops.fused_rerank_paged_res(q, qm, cand, st.cent_pages, st.code_pages,
                                          st.page_table, st.n_tokens, st.codec.centroids,
                                          st.codec.values, k)
    return ops.fused_rerank_paged(q, qm, cand, st.tok_pages, st.page_table, st.n_tokens, k)


def serve_backend(torch, r, batches, kernels):
    """Serve ``batches`` through ``r`` (counters from 0 just before, read
    just after), then time its first stage and its rerank apart on the
    timed batches; the recall queries' top-10 against exact MaxSim."""
    from repro_torch.kernels import ops
    from repro_torch.retriever import SearchParams

    p = r.resolve(SearchParams())
    ops.reset_launch_counts()
    lat = []
    for i, (q, qm, _) in enumerate(batches):
        (s, ids), ms = synced_ms(torch, lambda: r.search(q, qm))
        require(s.shape == (q.shape[0], p.k) and bool(torch.isfinite(s).all()),
                f"{r.backend}: scores not finite (B, k)")
        if i:
            lat.append(ms)
    launches = ops.launch_counts()
    want = {k: (len(batches) if k in kernels else 0) for k in launches}
    require(launches == want, f"{r.backend}: launches {launches}, expected {want}")
    fs, rk = [], []
    for q, qm, _ in batches[1:]:
        cand, ms = synced_ms(torch, lambda: r.candidates(q, qm))
        fs.append(ms)
        rk.append(synced_ms(torch, lambda: paged_rerank(torch, r, q, qm, cand, p.k))[1])
    q, qm, src = (t[:RECALL_QUERIES] for t in batches[0])
    truth = truth_top10(torch, r.index.store, q, qm)
    got = r.search(q, qm)[1][:, :10]
    recall = float((got[:, :, None] == truth[:, None, :]).any(1).float().mean())
    # the doc each query's tokens were drawn from (make_queries): the one doc
    # the query overlaps beyond chance on this weakly clustered corpus
    src_at_10 = float((got == src[:, None]).any(1).float().mean())
    src_in_cand = float((r.candidates(q, qm) == src[:, None]).any(1).float().mean())
    B = batches[0][0].shape[0]
    return dict(batches=len(lat), batch=B, p50_ms=float(np.median(lat)), max_ms=float(max(lat)),
                qps=B * len(lat) / (sum(lat) / 1e3), first_stage_p50_ms=float(np.median(fs)),
                rerank_p50_ms=float(np.median(rk)), k=p.k, k_prime=p.k_prime,
                recall_at_10=recall, recall_queries=RECALL_QUERIES,
                source_doc_at_10=src_at_10, source_doc_in_candidates=src_in_cand,
                launches={k: v for k, v in launches.items() if v}, search_ms=lat)


def state_bytes(torch, r):
    from repro_torch.anns import registry

    arrays, _ = registry.get_backend(r.backend).pack_state(r.index.ann)
    return {k: int(v.numel() * v.element_size()) for k, v in arrays.items()}


def backends_phase(torch, args, holder, card):
    """Each other backend over the served index (``holder``: the served
    retriever, handed over), one at a time: ``with_backend`` from the pages
    (stage seconds, state bytes, memory), 8 timed batches with the first
    stage and the rerank apart, recall@10, the plain checks, one round of
    1,024 deletes and 1,024 adds through the backend and the checks again;
    then DESSERT over the compressed tier.  Each backend's retriever takes
    the store over from the last (no other view holds it), so a round
    writes the pool in place."""
    import gc

    from repro_torch.anns.params import ResidualConfig
    from repro_torch.kernels import ops
    from repro_torch.retriever import LemurRetriever

    cur = holder.pop()
    st = cur.index.store
    rng = np.random.default_rng(args.seed + 23)
    batches = [make_queries(torch, st, rng, args.batch) for _ in range(BACKEND_BATCHES)]
    line = dict(card=card, m=cur.m, ivf_through_registry=ivf_through_registry(
        torch, cur, batches[0]), backends={})
    gone = set()
    for name in BACKEND_NAMES:
        t_all = time.time()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (rb, build_ms) = synced_ms(torch, lambda: cur.with_backend(
            name, generator=torch.Generator().manual_seed(args.seed)))
        cur = None
        gc.collect()
        torch.cuda.empty_cache()
        out = dict(build_s=build_ms / 1e3, build_stages_s=rb.build_log["seconds"],
                   state_bytes=state_bytes(torch, rb),
                   memory_allocated_change_gib=(torch.cuda.memory_allocated() - mem0) / 2**30,
                   build_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        if name == "token_pruning":
            lists = rb.index.ann.index
            out.update(nlist=int(lists.centroids.shape[0]), cap=int(lists.doc_lists.shape[1]),
                       tokens=int(lists.counts.sum()),
                       list_len_max_mean=[int(lists.counts.max()),
                                          float(lists.counts.float().mean())])
        print(f"backend {name}: built in {out['build_s']:.1f} s {out['build_stages_s']}, "
              f"state {sum(out['state_bytes'].values()) / 1e9:.2f} GB", flush=True)
        cur = rb
        out.update(serve_backend(torch, rb, batches, ("fused_psi_pool", "rerank_paged_scores")))
        out["traced_batch"] = profile_batch(torch, rb, *batches[1][:2])
        out["checks"] = check_backend(torch, rb, batches[1], gone, name)
        # the round: rb is the store's only holder now (the last retriever is
        # gone), so a retriever that owns the index writes the pool in place
        rm = LemurRetriever._owning(rb.index, solver_state=rb.solver_state, x_ols=rb.x_ols)
        cur = rb = None
        dead = pick_live(torch, rm, rng, BACKEND_ROUND)
        ops.reset_launch_counts()
        _, del_ms = synced_ms(torch, lambda: rm.delete(dead))
        gone.update(dead.tolist())
        tok, mask = churn_docs(torch, rng, args.seed, BACKEND_ROUND, rm.device, rm.index.store.d)
        _, add_ms = synced_ms(torch, lambda: rm.add(tok, mask))
        round_launches = {k: v for k, v in ops.launch_counts().items() if v}
        require(round_launches.get("token_maxsim", 0) >= 1,
                f"{name}: the add fit no W rows through token MaxSim: {round_launches}")
        arrays, meta = registry_pack(rm)
        rows = meta.get("m", next(iter(arrays.values())).shape[0])
        require(rows == rm.m, f"{name}: the state serves {rows} docs of {rm.m}")
        del tok, mask, arrays
        out["round"] = dict(delete=BACKEND_ROUND, add=BACKEND_ROUND, delete_ms=del_ms,
                            add_ms=add_ms, launches=round_launches,
                            checks=check_backend(torch, rm, batches[2], gone, f"{name} churned"),
                            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        out["s"] = time.time() - t_all
        line["backends"][name] = out
        print(f"backend {name} ok: p50 {out['p50_ms']:.3f} ms (first stage "
              f"{out['first_stage_p50_ms']:.3f}, rerank {out['rerank_p50_ms']:.3f}), recall@10 "
              f"{out['recall_at_10']:.4f}, source doc at 10 {out['source_doc_at_10']:.3f}, "
              f"near-tie ids {out['checks']['first_stage_near_tie_ids']}"
              f"/{out['checks']['near_tie_ids']}, churned "
              f"{out['round']['checks']['near_tie_ids']}, {out['s']:.1f} s", flush=True)
        cur = rm
        del rm

    # DESSERT over the compressed tier: its decoded tokens, reranked by the
    # residual paged kernel
    t_all = time.time()
    idx = cur.index
    cur = None
    gc.collect()
    torch.cuda.empty_cache()
    rcfg = ResidualConfig()
    codec, _ = train_codec(torch, args, idx.store, rcfg)
    rstore = residual_store(torch, args, idx.store, codec)
    rcur = LemurRetriever(idx._replace(cfg=idx.cfg.replace(residual=rcfg.replace(enabled=True),
                                                           anns="bruteforce"),
                                       store=rstore, backend="bruteforce",
                                       ann={"W": rstore.W[:idx.m]}))
    del idx
    torch.cuda.reset_peak_memory_stats()
    rr, build_ms = synced_ms(torch, lambda: rcur.with_backend(
        "dessert", generator=torch.Generator().manual_seed(args.seed)))
    del rcur
    out = dict(build_s=build_ms / 1e3, build_stages_s=rr.build_log["seconds"],
               state_bytes=state_bytes(torch, rr),
               build_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               codec=dict(bits=codec.bits, ncent=codec.ncent))
    out.update(serve_backend(torch, rr, batches, ("fused_psi_pool", "rerank_paged_res_scores")))
    out["checks"] = check_backend(torch, rr, batches[1], gone, "dessert, residual tier")
    out["s"] = time.time() - t_all
    line["backends"]["dessert_residual_tier"] = out
    print(f"backend dessert on the residual tier ok: p50 {out['p50_ms']:.3f} ms, recall@10 "
          f"{out['recall_at_10']:.4f}", flush=True)
    del rr, rstore
    gc.collect()
    torch.cuda.empty_cache()
    return line


def registry_pack(r):
    from repro_torch.anns import registry

    return registry.get_backend(r.backend).pack_state(r.index.ann)


# --------------------------------------------------------------------------
# the launchers, the v0 surface and the examples (the launch phase)
# --------------------------------------------------------------------------

LAUNCH_ARGV = ["--m", "50000", "--d", "128", "--d-prime", "2048", "--batch", "64",
               "--n-batches", "5", "--k", "10", "--backend", "all", "--mesh", "1", "--online",
               "--online-rate", "500", "--online-duration", "3", "--fleet", "2",
               "--fleet-slo-ms", "50"]
LIFECYCLE_ARGV = ["--d", "128", "--m", "20000", "--duration", "3", "--refresh",
                  "--drift-burst", "512", "--refresh-min-reservoir", "64"]
EXAMPLES = {"quickstart": ["--m", "800", "--epochs", "8"], "serve_batched": [],
            "serve_online": ["--duration", "2"], "serve_fleet": ["--duration", "2"],
            "lifecycle_refresh": []}
#: the kernels each part of the phase must launch
LAUNCH_KERNELS = {
    "launcher": ("fused_psi_pool", "ivf_probe_scan", "rerank_paged_scores", "token_maxsim",
                 "fused_psi", "mips_topk", "rerank_gather_scores"),
    "ops_entries": ("token_maxsim", "fused_psi", "ivf_probe_scan", "ivf_probe_res_scan"),
    "serve_batched": ("fused_psi_pool", "ivf_probe_scan", "rerank_paged_scores", "mips_sq8",
                      "query_fused"),
}
F = r"\d+(?:\.\d+)?"
LAUNCH_LINES = {
    "backend": rf"\[serve\] backend=(?P<name>[a-z_]+) +QPS=(?P<qps>\d+)  "
               rf"recall@10=(?P<recall>{F})  jit_traces=(?P<traces>\d+)",
    "sharded": rf"\[serve\] mesh= *(?P<mesh>\S+) sharded QPS=(?P<qps>\d+)  "
               rf"recall@10=(?P<recall>{F})  jit_traces=(?P<traces>\d+)  sq8=(?P<sq8>\w+)  "
               rf"one_launch=(?P<one_launch>\w+)",
    "online": rf"\[serve\] online rate=(?P<rate>{F})qps p50=(?P<p50>{F})ms p95=(?P<p95>{F})ms "
              rf"p99=(?P<p99>{F})ms achieved=(?P<qps>\d+)qps occupancy=(?P<occ>{F}) "
              rf"jit_traces=(?P<traces>\d+)/(?P<bound>\d+)",
    "fleet": rf"\[serve\] fleet replicas=(?P<replicas>\d+) rate=(?P<rate>{F})qps "
             rf"p50=(?P<p50>{F})ms p99=(?P<p99>{F})ms achieved=(?P<qps>\d+)qps "
             rf"rejected=(?P<rejected>\d+) expired=(?P<expired>\d+) lost=(?P<lost>\d+) "
             rf"healthy=(?P<healthy>\d+) jit_traces=(?P<traces>\d+)/(?P<bound>\d+)",
}


def parse_launcher(out):
    """The launcher's printed rows by kind, their numbers as floats."""
    rows = {k: [] for k in LAUNCH_LINES}
    for line in out.splitlines():
        for kind, pat in LAUNCH_LINES.items():
            mt = re.match(pat, line)
            if mt:
                rows[kind].append({k: (v if k in ("name", "mesh", "sq8", "one_launch")
                                       else float(v)) for k, v in mt.groupdict().items()})
    return rows


@contextlib.contextmanager
def counted(torch, launches, part):
    """Launch counters from 0 around a part; its counts land in launches[part]."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    yield
    torch.cuda.synchronize()
    launches[part] = {k: v for k, v in ops.launch_counts().items() if v}


def captured(fn, *a):
    """Run fn(*a) with its stdout kept, then echo it indented: (result, text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a)
    out = buf.getvalue()
    print("\n".join("    " + ln for ln in out.splitlines()), flush=True)
    return res, out


def saved_index_both_ways(torch, r, save_dir, batch):
    """The launcher's saved index on the card (its reloaded retriever) and on
    the CPU: one batch through both; card candidates against the CPU's, the
    card's top-10 against the CPU rerank of the card's candidates and, on
    rows whose candidates agree, against the CPU's own top-10; then the v0
    query / candidates on the card's index against the facade, bit for bit."""
    from repro_torch.core import index as v0
    from repro_torch.kernels import ops
    from repro_torch.retriever import LemurRetriever, SearchParams
    from repro_torch.retriever.facade import first_stage

    q, qm, _ = batch
    p = SearchParams(k=10)
    t0 = time.time()
    cpu = LemurRetriever.load(save_dir, device="cpu")
    load_s = time.time() - t0
    s, i = r.search(q, qm, p)
    cand = r.candidates(q, qm, p)
    qc, qmc = q.cpu(), qm.cpu()
    t0 = time.time()
    cs, ci = cpu.search(qc, qmc, p)
    ccand = cpu.candidates(qc, qmc, p)
    cpu_s = time.time() - t0
    same = (cand.cpu().sort(1).values == ccand.sort(1).values).all(1)
    st = cpu.index.store
    rs, ri = ops.fused_rerank_paged(qc, qmc, cand.cpu(), st.tok_pages, st.page_table,
                                    st.n_tokens, 10)
    err, ties, _ = same_topk(torch, s.cpu(), i.cpu(), rs, ri, 1e-5, "saved index: card rerank")
    err2, ties2, _ = same_topk(torch, s.cpu()[same], i.cpu()[same], cs[same], ci[same], 1e-5,
                               "saved index: card vs CPU")
    require(int((~same).sum()) <= 2, f"saved index: candidates differ in {int((~same).sum())} "
                                     f"of {len(same)} rows")
    idx = r.index
    v0_bits = {}
    for kw in ({}, {"use_ann": False}, {"nprobe": 8}):
        ws, wi = r.search(q, qm, v0._legacy_params(idx, **kw))
        gs, gi = v0.query(idx, q, qm, **kw)
        spelled = ", ".join(f"{k}={v}" for k, v in kw.items())
        v0_bits[f"query({spelled})"] = bool(torch.equal(gs, ws) and torch.equal(gi, wi))
    for use_ann in (False, True):
        pp = v0._legacy_params(idx, k_prime=256, use_ann=use_ann)
        got = v0.candidates(idx, q, qm, k_prime=256, use_ann=use_ann)
        v0_bits[f"candidates(use_ann={use_ann})"] = bool(torch.equal(got, first_stage(
            idx, q, qm, pp)))
    require(all(v0_bits.values()), f"v0 functions differ from the facade: {v0_bits}")
    del cpu
    return dict(cpu_load_s=load_s, cpu_batch_s=cpu_s, rows=len(same),
                rows_same_candidates=int(same.sum()), max_abs_err_card_rerank=err,
                near_tie_ids_card_rerank=ties, max_abs_err_card_vs_cpu=err2,
                near_tie_ids_card_vs_cpu=ties2, v0_bit_for_bit=v0_bits)


def ops_entries_case(torch, seed):
    """The four ops entries on the served widths of a small case (d 128, d'
    2,048; 64 SQ8 / fp32 lists and 64 residual lists of a 4-bit codec
    trained on 4,096 latent rows) against the wrappers they call, bit for
    bit."""
    from repro_torch.anns.quantization import residual_encode, sq8_quant, train_residual_codec
    from repro_torch.core.model import Psi
    from repro_torch.kernels import fused_psi, gather_scan, ops
    from repro_torch.kernels import maxsim as kmaxsim

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 25)
    d, dp, nlist = 128, 2048, 64
    x = torch.nn.functional.normalize(torch.randn(256, d, generator=g, device=dev), dim=-1)
    docs = torch.nn.functional.normalize(torch.randn(300, 80, d, generator=g, device=dev), dim=-1)
    dmask = torch.rand(300, 80, generator=g, device=dev) > 0.3
    psi = Psi.init(d, dp, torch.Generator().manual_seed(seed), device=dev)
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    jdict = {"dense": {"kernel": w[0], "bias": w[1]}, "ln": {"scale": w[2], "bias": w[3]}}
    lat = torch.nn.functional.normalize(torch.randn(4096, dp, generator=g, device=dev), dim=-1)
    codec = train_residual_codec(torch.Generator().manual_seed(seed), lat, bits=4, ncent=nlist,
                                 iters=4, sample=4096)
    cid, codes = residual_encode(codec, lat)
    order = torch.sort(cid.long(), stable=True).indices
    counts = torch.bincount(cid.long(), minlength=nlist)
    cap = int(counts.max())
    slot = torch.arange(len(order), device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    ids[cid[order].long(), slot] = order.int()
    rcodes = torch.zeros((nlist, cap, codes.shape[1]), dtype=torch.uint8, device=dev)
    rcodes[cid[order].long(), slot] = codes[order]
    vecs = torch.zeros((nlist, cap, dp), device=dev)
    vecs[cid[order].long(), slot] = lat[order]
    sq, sc = sq8_quant(vecs)
    q = fused_psi.fused_psi_pool(x[:64].reshape(8, 8, d), None, *w)
    probe = torch.topk(q @ codec.centroids.T, 16).indices.int()
    cases = {
        "token_maxsim": (lambda: ops.token_maxsim(x, docs, dmask),
                         lambda: kmaxsim.token_maxsim(x, docs, dmask)),
        "fused_psi(Psi)": (lambda: ops.fused_psi(x, psi), lambda: fused_psi.fused_psi(x, *w)),
        "fused_psi(dict)": (lambda: ops.fused_psi(x, jdict), lambda: fused_psi.fused_psi(x, *w)),
        "fused_ivf_scan(sq8)": (lambda: ops.fused_ivf_scan(q, probe, ids, sq, sc),
                                lambda: gather_scan.ivf_probe_scan(q, probe, ids, sq, sc)),
        "fused_ivf_scan(fp32)": (lambda: ops.fused_ivf_scan(q, probe, ids, vecs),
                                 lambda: gather_scan.ivf_probe_scan(q, probe, ids, vecs)),
        "fused_ivf_scan_res": (
            lambda: ops.fused_ivf_scan_res(q, probe, ids, rcodes, codec.centroids, codec.values),
            lambda: gather_scan.ivf_probe_res_scan(q, probe, ids, rcodes, codec.centroids,
                                                   codec.values)),
    }
    out = {}
    for name, (entry, wrapper) in cases.items():
        want = wrapper()
        got = entry()
        require(torch.equal(got, want), f"ops.{name} differs from its wrapper")
        out[name] = list(got.shape)
    return dict(bit_for_bit=True, shapes=out, lists=nlist, cap=cap)


#: one lifecycle launcher run in a process of its own: its result and its
#: launch counts (from 0 at its start) as JSON
LIFECYCLE_CHILD = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.kernels import ops
from repro_torch.launch import serve_lifecycle
ops.reset_launch_counts()
res = serve_lifecycle.main(sys.argv[3:])
mon = res["monitor_report"]
json.dump(dict(
    n_swaps=res["n_swaps"], version=res["version"],
    events=[dict(kind=ev.kind, **dataclasses.asdict(ev)) for ev in res["events"]],
    reports=[{k: v for k, v in rep.items() if isinstance(v, (int, float))}
             for rep in res["reports"]],
    monitor_last_report=dataclasses.asdict(mon) if mon is not None else None,
    launches={k: v for k, v in ops.launch_counts().items() if v}),
    open(sys.argv[1], "w"), default=str)
"""
LIFECYCLE_TIMEOUT_S = 600


def event_chain(events):
    """Every refresh start ends in a swap or a failure before the next, and
    a swap advances the version past the one its rebuild started from."""
    start = None
    for ev in events:
        if ev["kind"] == "RefreshStarted":
            require(start is None, f"lifecycle: two refresh starts in a row: {events}")
            start = ev
        elif ev["kind"] in ("SwapCompleted", "SwapAborted", "RefreshFailed"):
            require(start is not None, f"lifecycle: {ev['kind']} without a start")
            if ev["kind"] == "SwapCompleted":
                require(ev["version"] > start["version"],
                        f"lifecycle: the swap to {ev['version']} did not advance past "
                        f"{start['version']}")
            start = None
    require(start is None, "lifecycle: a refresh start without an end")


def check_example(torch, name, argv, res, out):
    """An example's own assertions, and what its line keeps."""
    ex = {"argv": " ".join(argv)}
    if name == "quickstart":
        require("save/load round-trip OK" in out, "quickstart: round trip")
        ex["recall_at_10"] = res["recall"]
    elif name == "serve_batched":
        r = res["retriever"]
        one = res["rows"]["1launch"]
        q, qm, _ = res["batches"][1]
        ex["rows"] = {k: {kk: v for kk, v in rw.items() if kk != "params"}
                      for k, rw in res["rows"].items()}
        # the facade's plan for the one-launch row, and what one search of it
        # puts on the card
        ex["one_launch_plan"] = one["plan"]
        ex["one_launch_cuda"] = cuda_launches(torch, lambda: r.search(q, qm, one["params"]))
    elif name == "serve_online":
        require(res["new_doc_found"], "serve_online: the added doc was not found")
        ex.update(steady_p99_ms=res["steady"]["p99_ms"], qps=res["steady"]["qps"])
    elif name == "serve_fleet":
        require("[1] parity ok" in out and res["added_found"] and res["quarantined"] == [0]
                and res["overload"]["n_lost"] == 0,
                "serve_fleet: parity, the add, the quarantine or a lost request")
        ex.update(overload_p99_ms=res["overload"]["p99_ms"],
                  rejected=res["overload"]["n_rejected"])
    else:
        kinds = [ev.kind for ev in res["events"]]
        require("RefreshFailed" in kinds and kinds[-1] == "SwapCompleted",
                f"lifecycle_refresh: events {kinds}")
        ex["events"] = kinds
    return ex


def launch_phase(torch, args, card):
    """The launchers, the v0 surface, the ops entries and the five examples
    on the card -> (launch line, launches by part)."""
    import importlib
    import shutil
    import tempfile

    import torch.distributed as tdist

    from repro_torch.anns import registry
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    launches, seconds, line = {}, {}, {}
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the launcher at full width
        t0 = time.time()
        with counted(torch, launches, "launcher"):
            res, out = captured(serve.main, LAUNCH_ARGV + ["--save-dir", tmp])
        seconds["launcher"] = time.time() - t0
        require(not tdist.is_initialized(), "the launcher left a process group")
        rows = parse_launcher(out)
        names = [rw["name"] for rw in rows["backend"]]
        require(names == registry.list_backends(), f"launcher backend rows {names}")
        require(all(rw["traces"] == 1 for rw in rows["backend"]), "a backend traced twice")
        require(len(rows["sharded"]) == 2, "launcher: the two sharded rows")
        require(len(rows["online"]) == 1 and rows["online"][0]["traces"]
                <= rows["online"][0]["bound"], "launcher: online row / trace bound")
        require(len(rows["fleet"]) == 1 and rows["fleet"][0]["lost"] == 0,
                "launcher: fleet row / lost requests")
        line["launcher"] = dict(
            argv=" ".join(LAUNCH_ARGV), backends={rw["name"]: dict(
                qps=rw["qps"], recall_at_10=rw["recall"], jit_traces=rw["traces"])
                for rw in rows["backend"]},
            sharded=rows["sharded"], online=rows["online"][0], fleet=rows["fleet"][0],
            online_report={k: v for k, v in res["rows"]["online"].items()
                           if isinstance(v, (int, float))},
            fleet_report={k: v for k, v in res["rows"]["fleet"].items()
                          if isinstance(v, (int, float))},
            slo_transitions=[ln.strip() for ln in out.splitlines() if "slo " in ln])
        # 2. the saved index on the card and on the CPU, the v0 functions
        t0 = time.time()
        with counted(torch, launches, "saved_index"):
            line["saved_index"] = saved_index_both_ways(torch, res["retriever"], tmp,
                                                        res["batches"][0])
        seconds["saved_index"] = time.time() - t0
        del res
    gc.collect()
    torch.cuda.empty_cache()
    # 3. the ops entries
    t0 = time.time()
    with counted(torch, launches, "ops_entries"):
        line["ops_entries"] = ops_entries_case(torch, args.seed)
    seconds["ops_entries"] = time.time() - t0
    # 4. the lifecycle launcher, single and behind a router: each in a
    # process of its own, both beside the examples (a run that sees no swap
    # serves on for 120 s: the JAX launcher's wait)
    children = {}
    tmp = tempfile.mkdtemp(prefix="lifecycle_")
    try:
        for name, extra in (("lifecycle_single", []),
                            ("lifecycle_replicas_2", ["--replicas", "2"])):
            log = open(os.path.join(tmp, f"{name}.log"), "w")
            children[name] = (subprocess.Popen(
                [sys.executable, "-c", LIFECYCLE_CHILD, os.path.join(tmp, f"{name}.json"),
                 os.path.join(HERE, "src"), *LIFECYCLE_ARGV, *extra],
                stdout=log, stderr=subprocess.STDOUT), log, extra, time.time())
        # 5. the five examples, their own assertions holding
        line["examples"] = {}
        for name, argv in EXAMPLES.items():
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            t0 = time.time()
            with counted(torch, launches, name):
                res, out = captured(mod.main, argv)
            seconds[name] = time.time() - t0
            line["examples"][name] = check_example(torch, name, argv, res, out)
            del res
            gc.collect()
        for name, (proc, log, extra, t0) in children.items():
            rc = proc.wait(timeout=max(1.0, LIFECYCLE_TIMEOUT_S - (time.time() - t0)))
            seconds[name] = time.time() - t0
            log.close()
            with open(os.path.join(tmp, f"{name}.log")) as f:
                out = f.read()
            print(f"  {name}:\n" + "\n".join("    " + ln for ln in out.splitlines()),
                  flush=True)
            require(rc == 0, f"{name}: exit code {rc}")
            with open(os.path.join(tmp, f"{name}.json")) as f:
                res = json.load(f)
            require(all(rep["n_lost"] == 0 for rep in res["reports"]), f"{name}: lost requests")
            event_chain(res["events"])
            launches[name] = res["launches"]
            drift = [ev for ev in res["events"] if ev["kind"] == "DriftDetected"]
            line[name] = dict(
                argv=" ".join(LIFECYCLE_ARGV + extra), n_swaps=res["n_swaps"],
                version=res["version"], events=[ev["kind"] for ev in res["events"]],
                p99_ms=[rep["p99_ms"] for rep in res["reports"]],
                replays=len(res["reports"]), lost=sum(rep["n_lost"] for rep in res["reports"]),
                drift_report=drift[0] if drift else None,
                monitor_last_report=res["monitor_last_report"],
                ran_beside="the examples, in a process of its own")
    finally:
        for proc, log, _, _ in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    require(not tdist.is_initialized(), "a process group was left behind")
    for part, need in LAUNCH_KERNELS.items():
        missing = [k for k in need if not launches[part].get(k)]
        require(not missing, f"launch phase, {part}: no launch of {missing}")
    torch.cuda.empty_cache()
    line.update(seconds=seconds, total_s=time.time() - t_phase, launches=launches,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
    return line, launches


# --------------------------------------------------------------------------
# the model layer: the LM configs at full width
# --------------------------------------------------------------------------

def _norm_or_bias(name):
    """Leaves ``lm.param_count`` leaves out: norm scales and biases."""
    return any(s in name for s in ("ln1/", "ln2/", "final_norm/", "q_norm/", "kv_norm/",
                                   "/bias", "/bq", "/bk", "/bv"))


def lm_flops(cfg, lm, batch, q_len, kv_len, readout_tokens):
    """(block matmul, readout matmul, attention) operations of a forward of
    batch x q_len tokens attending to kv_len keys: 2 a token and block
    parameter (every expert: one device runs them all), 2 a readout token
    and embedding entry, and the attention's q.k and p.v over the allowed
    (causal) pairs only.  The matmuls run in bf16, the attention in fp32."""
    block_params = lm.param_count(cfg) - cfg.vocab * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    if cfg.attn == "mla":
        dk, dv = cfg.kv_lora + cfg.qk_rope, cfg.kv_lora
    else:
        dk, dv = cfg.head_dim, cfg.head_dim
    pairs = batch * sum(kv_len - q_len + i + 1 for i in range(q_len))
    return (2 * batch * q_len * block_params, 2 * readout_tokens * cfg.d_model * cfg.vocab,
            2 * pairs * cfg.n_heads * (dk + dv) * cfg.n_layers)


def lm_bound(nbytes, mm_flops, attn_flops):
    """The least time (ms, by): the bytes at the memory rate against the
    matmuls at the bf16 tensor-core rate plus the fp32 attention at the
    CUDA cores' rate (the scores are fp32 products, TF32 off)."""
    t_mem = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (mm_flops / PEAK_BF16_S + attn_flops / PEAK_FP32_S) * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def lm_serve(torch, cfg, batch, seq, steps, seed, reduced=None, mesh_cfg=None):
    """One config on the card: ``init_lm`` from a seeded generator, a
    prefill of batch x seq tokens (twice: the first warms cuBLAS), ``steps``
    greedy ``make_decode_step`` steps, the first step's logits held against
    ``forward_train`` at the same position, then the mesh forms' prefill
    and MESH_DECODE_STEPS decode steps against these (``lm_mesh_serve``;
    ``mesh_cfg``: the config the mesh forms run, default ``cfg``) -> (line,
    params)."""
    from repro_torch.common.pytree import named_leaves
    from repro_torch.models import lm

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    line = {"config": cfg.name, "n_layers": cfg.n_layers, "batch": batch, "seq": seq,
            "decode_steps": steps}
    if reduced:
        line["reduced"] = reduced
    t0 = time.time()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(seed), cfg, device="cuda")
    torch.cuda.synchronize()
    line["init_s"] = time.time() - t0
    leaves = named_leaves(params)
    counted = sum(t.numel() for n, t in leaves if not _norm_or_bias(n))
    require(counted == lm.param_count(cfg), f"{cfg.name}: {counted} params, param_count "
            f"{lm.param_count(cfg)}")
    p_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    require(all(t.dtype == torch.bfloat16 for _, t in leaves), f"{cfg.name}: a leaf not bf16")
    line.update(params=sum(t.numel() for _, t in leaves), param_count=lm.param_count(cfg),
                param_gb=p_bytes / 1e9)
    toks = torch.randint(0, cfg.vocab, (batch, seq), device=dev,
                         generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    cache_len = seq + steps
    prefill = lm.make_prefill_step(cfg, cache_len)
    step = lm.make_decode_step(cfg)
    with torch.no_grad():
        prefill_s = []
        for _ in range(2):
            caches = None
            torch.cuda.synchronize()
            t0 = time.time()
            logits, caches = prefill(params, toks)
            torch.cuda.synchronize()
            prefill_s.append(time.time() - t0)
        require(bool(torch.isfinite(logits).all()), f"{cfg.name}: prefill logits not finite")
        cache_bytes = sum(t.numel() * t.element_size() for _, t in named_leaves(caches))
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        first_tok, step_ms, step_host_ms = tok, [], []
        want_prefill, fed, want_steps = logits.float(), [], []
        for s in range(steps):
            if s < MESH_DECODE_STEPS:
                fed.append(tok)
            if s == steps - 1:          # the last step traced, not timed
                out = []
                trace = profile_call(
                    torch, lambda: out.append(step(params, tok, caches, seq + 1 + s)))
                nxt, lg, caches = out[0]
            else:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.time()
                e0.record()
                nxt, lg, caches = step(params, tok, caches, seq + 1 + s)
                e1.record()
                torch.cuda.synchronize()
                step_host_ms.append((time.time() - t0) * 1e3)
                step_ms.append(e0.elapsed_time(e1))
            require(bool(torch.isfinite(lg).all()), f"{cfg.name}: decode step {s} not finite")
            if s < MESH_DECODE_STEPS:
                want_steps.append(lg.float())
            if s == 0:
                first = lg.float()
            tok = nxt
        # the first decode step against the train forward at the same position
        h, _ = lm.forward_train(params, torch.cat([toks, first_tok], 1), cfg)
        ref = lm._readout(params, h[:, -1], cfg).float()
        del h
    err, scale = float((first - ref).abs().max()), float(ref.abs().max())
    require(err <= lm.BF16_LOGIT_RTOL * scale,
            f"{cfg.name}: decode vs train {err} > {lm.BF16_LOGIT_RTOL} x {scale}")
    med = float(np.median(step_ms))
    blocks, readout, attn = lm_flops(cfg, lm, batch, seq, seq, batch)
    kv_mid = seq + steps // 2
    step_cache_bytes = cache_bytes * kv_mid / cache_len
    d_blocks, d_readout, d_attn = lm_flops(cfg, lm, batch, 1, kv_mid, batch)
    d_mm = d_blocks + d_readout
    line.update(
        prefill_s=prefill_s, prefill_tokens_per_s=batch * seq / prefill_s[1],
        prefill_bound_ms=lm_bound(p_bytes + cache_bytes, blocks + readout, attn),
        cache_len=cache_len,
        cache_gb=cache_bytes / 1e9, decode_ms_median=med,
        decode_ms=[float(x) for x in step_ms], decode_host_ms_median=float(
            np.median(step_host_ms)), decode_tokens_per_s=batch * 1e3 / med,
        decode_bound_ms=lm_bound(p_bytes, d_mm, d_attn),
        decode_bound_with_cache_ms=lm_bound(p_bytes + step_cache_bytes, d_mm, d_attn),
        decode_vs_train_max_abs_err=err, decode_vs_train_max_abs_logit=scale,
        decode_vs_train_rtol=lm.BF16_LOGIT_RTOL,
        decode_vs_train_argmax_agree=float((first.argmax(-1) == ref.argmax(-1)).float().mean()),
        decode_traced={k: trace[k] for k in ("wall_ms", "device_busy_ms", "idle_share")}
        | {"top": trace["top"][:6], "idle_gaps": trace["idle_gaps"]},
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del caches, logits, lg, first, ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    mesh_cfg = mesh_cfg or cfg
    line["mesh_forms"] = lm_mesh_serve(torch, mesh_cfg, params, toks, fed, want_prefill,
                                       want_steps)
    line["mesh_forms"]["capacity_factor"] = mesh_cfg.capacity_factor
    line["mesh_forms"]["s"] = time.time() - t0
    del want_prefill, want_steps, fed
    return line, params


def lm_attention_yardstick(torch, cfg, batch, seq):
    """The port's blocked attention on one layer's prefill shapes against
    ``F.scaled_dot_product_attention`` (the library's flash attention, bf16
    scores; timed as the yardstick of a later kernel, used nowhere)."""
    import torch.nn.functional as F

    from repro_torch.nn import attention

    g = torch.Generator(device="cuda").manual_seed(11)
    shape = (batch, seq, cfg.n_heads, cfg.head_dim)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    pos = torch.arange(seq, device="cuda").expand(batch, seq)
    kw = dict(causal=True, q_block=cfg.q_block, kv_block=cfg.kv_block)
    with torch.no_grad():
        port = lambda: attention.flash_attention(q, k, v, pos, pos[0], **kw)
        lib = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True)
        err = float((port().float() - lib().transpose(1, 2).float()).abs().max())
        return {"shape": list(shape), "port_ms": time_ms(torch, port, n=5, warmup=1),
                "sdpa_ms": time_ms(torch, lib, n=5, warmup=1), "max_abs_diff": err}


def lm_layer_card_vs_cpu(torch, cfg, params, tokens=256):
    """Layer 0 of ``params`` in fp32 at full width, on the card and on the
    CPU from the same parameters and inputs -> its line."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import lm

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    spec = lm.layer_stacks(cfg)[0][1][0]
    layer = tree_map(lambda t: t[0].float(), params["stack_0"]["pos_0"])
    x = torch.randn((1, tokens, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(12))
    pos = torch.arange(tokens, device="cuda")[None]
    t0 = time.time()
    with torch.no_grad():
        y, _ = lm._layer_train(cfg32, spec, layer, x, pos)
        y_cpu, _ = lm._layer_train(cfg32, spec, tree_map(lambda t: t.cpu(), layer), x.cpu(),
                                   pos.cpu())
    err, scale = float((y.cpu() - y_cpu).abs().max()), float(y_cpu.abs().max())
    require(err <= 1e-4 * scale, f"fp32 layer card vs cpu {err} > 1e-4 x {scale}")
    return {"config": cfg.name, "layer": 0, "tokens": tokens, "max_abs_err": err,
            "max_abs": scale, "rtol": 1e-4, "s": time.time() - t0}


def lm_train_step(torch, cfg, seq, seed):
    """Two ``make_train_step`` steps at full width (the first warms the
    backward), then two ``adam8_update`` steps on one step's gradients
    against two of ``adam_update``."""
    from repro_torch.common.pytree import named_leaves
    from repro_torch.models import lm
    from repro_torch.optim.adam import adam_init, adam_update
    from repro_torch.optim.adam8bit import adam8_init, adam8_update

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(seed), cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, seq + 1), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = adam_init(params)
    train_step = lm.make_train_step(cfg)
    step_s, losses = [], []
    new = params
    for _ in range(2):          # the first step also warms the backward's kernels
        torch.cuda.synchronize()
        t0 = time.time()
        new, opt, m = train_step(new, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        require(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0,
                f"train step: loss {loss}, grad norm {gnorm}")
        losses.append(loss)
        if len(step_s) == 1:
            moved = {n: float((a != b).float().mean()) for (n, a), (_, b) in
                     zip(named_leaves(new), named_leaves(params))}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(v > 0 for n, v in moved.items() if not _norm_or_bias(n)),
            f"train step: a weight did not move {moved}")
    del new, opt
    (_, _), grads = lm.value_and_grad(params, batch["tokens"], batch["labels"], cfg)
    # two updates of each on these gradients: the first equals Adam's bit for
    # bit (the int8 moments enter from the second); the second within
    # test_adam8_tracks_adam's drift, 0.15 over 20 steps of lr 0.01 (0.75 lr
    # a step), plus one bf16 ulp of the leaf's largest parameter
    worst = []
    with torch.no_grad():
        p_adam, s_adam, p_8, s_8 = params, adam_init(params), params, adam8_init(params)
        for step in range(2):
            p_adam, s_adam, _ = adam_update(grads, s_adam, p_adam, lr=1e-3, grad_clip=1.0)
            p_8, s_8, _ = adam8_update(grads, s_8, p_8, lr=1e-3, grad_clip=1.0)
            diffs = []
            for (n, a), (_, b), (_, p) in zip(named_leaves(p_adam), named_leaves(p_8),
                                              named_leaves(params)):
                diff = float((a.float() - b.float()).abs().max())
                tol = 0.0 if step == 0 else 2 * 0.75 * 1e-3 + 2 ** -7 * float(p.abs().max())
                require(diff <= tol, f"adam8 vs adam, step {step + 1}, {n}: {diff} > {tol}")
                diffs.append(diff)
            worst.append(max(diffs))
    blocks, readout, attn = lm_flops(cfg, lm, 1, seq, seq, seq)
    n = sum(t.numel() for _, t in named_leaves(params))
    # the forward, the blocks' recompute under remat and the backward: 4x the
    # blocks' forward, 3x the readout's, 4x the attention's; bytes: the bf16
    # weights read three times, the gradients written, then Adam reads p, g
    # and the fp32 moments and writes p and the moments (30 bytes a parameter)
    line = {"config": cfg.name, "n_layers": cfg.n_layers, "tokens": seq, "step_s": step_s,
            "loss": losses, "grad_norm": gnorm, "peak_gib": peak,
            "moved_min_share": min(v for n, v in moved.items() if not _norm_or_bias(n)),
            "adam8_vs_adam_max_abs_by_step": worst,
            "adam8_tol": "step 1: 0; step 2: 1.5 lr + 2^-7 max|p| a leaf",
            "bound_ms": lm_bound(30 * n, 4 * blocks + 3 * readout, 4 * attn)}
    del params, grads, p_adam, p_8, s_adam, s_8
    return line


def lm_mesh_forms(torch, seed):
    """The mesh forms on a one-rank NCCL mesh ("pod", "data", "model") at
    SMOKE width, each against its single-device form on the card."""
    from repro_torch.nn import attention, moe
    from repro_torch.optim.compress import dequantize_int8, ef_int8_allreduce, quantize_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    with nccl_mesh(torch, (1, 1, 1), ("pod", "data", "model")) as mesh:
        p = moe.init_moe(g, 4, 64, 32, n_shared=1, device="cuda")
        x = torch.randn((2, 16, 64), device="cuda", generator=g)
        want, want_aux = moe.moe_apply_dense(p, x, n_experts=4, top_k=2)
        for layout in ("ep", "ffslice"):
            for body, threshold in (("gather_tokens", 4096), ("gather_weights", 0)):
                y, aux = moe.moe_apply(moe.moe_local_params(p, layout, mesh),
                                       moe.local_tokens(x, mesh), layout=layout, n_experts=4,
                                       top_k=2, mesh=mesh, n_tokens=32, capacity_factor=8.0,
                                       token_gather_threshold=threshold)
                err = float((y - want.reshape(-1, 64)).abs().max())
                require(err <= 1e-5 * max(1.0, float(want.abs().max())),
                        f"moe_apply {layout} {body}: {err}")
                require(abs(float(aux) - float(want_aux)) <= 1e-6 * max(1.0, float(want_aux)),
                        f"moe_apply {layout} {body} aux")
                out[f"moe_apply_{layout}_{body}_max_abs_err"] = err
        q, k, v = (torch.randn((2, 256, 4, 16), device="cuda", generator=g) for _ in range(3))
        pos = torch.arange(256, device="cuda").expand(2, 256)
        got = attention.flash_attention_cp(q, k, v, pos, mesh, q_block=128, kv_block=128)
        ref = attention.flash_attention(q, k, v, pos, pos[0], q_block=128, kv_block=128)
        out["flash_attention_cp_max_abs_err"] = float((got - ref).abs().max())
        require(out["flash_attention_cp_max_abs_err"] <= 1e-5, "flash_attention_cp")
        err = {"g": torch.zeros(1000, device="cuda")}
        worst = 0.0
        for _ in range(3):
            grad = 3 * torch.randn(1000, device="cuda", generator=g)
            q8, scale = quantize_int8(grad + err["g"])
            want_red = dequantize_int8(q8, scale)
            red, err = ef_int8_allreduce({"g": grad}, err, mesh.get_group("pod"))
            worst = max(worst, float((red["g"] - want_red).abs().max()))
        require(worst <= 1e-6, f"ef_int8_allreduce {worst}")
        out["ef_int8_allreduce_max_abs_err"] = worst
    return out


def lm_phase(torch, args, card):
    """The ``lm`` line: gemma-7b served at full width and depth, one of its
    layers in fp32 on the card against the CPU, deepseek-v3 at full width cut
    to 2 layers, one train step at gemma's width (depth 2) and the mesh
    forms on a one-rank NCCL mesh.  Frees everything it made."""
    from repro_torch.configs import deepseek_v3_671b, gemma_7b

    t_phase = time.time()
    line = {"card": card}
    gemma = gemma_7b.CONFIG
    line["gemma_7b"], params = lm_serve(torch, gemma, 4, 2048, 32, args.seed)
    line["gemma_7b"]["attention_yardstick"] = lm_attention_yardstick(torch, gemma, 4, 2048)
    line["gemma_7b_layer_fp32"] = lm_layer_card_vs_cpu(torch, gemma, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ds = deepseek_v3_671b.CONFIG.replace(n_layers=2, prefix_dense_layers=1)
    # the mesh forms' ep MoE drops pairs over its capacity where moe_apply_dense
    # drops none: at capacity factor 8 (256 slots an expert for 1,024 tokens
    # of top-8 over 256 experts, 32 expected) none is dropped
    line["deepseek_v3_671b"], params = lm_serve(
        torch, ds, 2, 512, 16, args.seed,
        reduced={"n_layers": [61, 2], "prefix_dense_layers": [3, 1]},
        mesh_cfg=ds.replace(capacity_factor=8.0))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line["train_step"] = lm_train_step(torch, gemma.replace(n_layers=2), 2048, args.seed)
    line["train_step"]["reduced"] = {"n_layers": [28, 2]}
    gc.collect()
    torch.cuda.empty_cache()
    line["mesh_forms"] = lm_mesh_forms(torch, args.seed)
    line["s"] = time.time() - t_phase
    return line


# --------------------------------------------------------------------------
# the training path: deepfm and meshgraphnet at full width, the launcher,
# the training examples
# --------------------------------------------------------------------------

TRAIN_STEPS = 6          # deepfm TrainLoop steps: saves at 3 (async, overlapped) and 6
TRAIN_CUT_BATCH = 1024   # rows of the card-vs-CPU step
GNN_STEPS = 5
XDEEPFM_STEPS = 3
TRAIN_KERNELS = ("token_maxsim", "fused_psi", "fused_psi_pool", "ivf_probe_scan",
                 "rerank_paged_scores")


def mlp_flops(dims, rows):
    """2 x rows x the products of an MLP of ``dims`` (d_in, ..., d_out)."""
    return 2 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def timed_step(torch, step, sink):
    """``step`` with CUDA events around each call, appended to ``sink``."""
    def run(*a):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(*a)
        e1.record()
        sink.append((e0, e1))
        return out
    return run


def elapsed_ms(torch, sink):
    torch.cuda.synchronize()
    return [e0.elapsed_time(e1) for e0, e1 in sink]


def to_cpu(torch, tree):
    from repro_torch.common.pytree import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def step_card_vs_cpu(torch, step, loss_fn, params, opt, batch, lr=1e-3):
    """The gradients and one step on the card against the same on the CPU
    from the same state: gradients within 1e-3 x max |CPU grad| + 1e-7 a leaf
    (fp32 sums in another order through up to 15 LayerNorm'd layers: the CPU
    parity tests' 1e-4, set on 2-3 layer SMOKE configs, is exceeded at
    meshgraphnet's full depth, 1.1e-4 of the leaf's max on ``molecule``; the
    GNN's segment sums add in one fixed order on the card, so the check
    repeats run to run); the step's loss rtol 1e-5, grad norm
    rtol 1e-4, new parameters within 2 x lr (Adam moves a parameter by up to
    lr either way on a gradient at rounding level).  The largest parameter
    difference where the new first moment is above 1e-3 x its leaf's max is
    reported beside them."""
    from repro_torch.common.pytree import named_leaves, value_and_grad

    cpu = lambda tree: to_cpu(torch, tree)
    _, g_g = value_and_grad(lambda p: loss_fn(p, batch), params)
    _, g_c = value_and_grad(lambda p: loss_fn(p, cpu(batch)), cpu(params))
    grad_err = 0.0
    for (n, a), (_, b) in zip(named_leaves(g_g), named_leaves(g_c)):
        err, scale = float((a.cpu() - b).abs().max()), float(b.abs().max())
        require(err <= 1e-3 * scale + 1e-7, f"card vs CPU gradient {n}: {err} of {scale}")
        grad_err = max(grad_err, err / max(scale, 1e-30))
    del g_g, g_c
    p_g, o_g, m_g = step(params, opt, batch)
    p_c, o_c, m_c = step(cpu(params), cpu(opt), cpu(batch))
    loss_g, loss_c = float(m_g["loss"]), float(m_c["loss"])
    require(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), f"card vs CPU loss {loss_g} {loss_c}")
    gn_g, gn_c = float(m_g["grad_norm"]), float(m_c["grad_norm"])
    require(abs(gn_g - gn_c) <= 1e-4 * abs(gn_c), f"card vs CPU grad norm {gn_g} {gn_c}")
    worst_big, worst = 0.0, 0.0
    mu = dict(named_leaves(o_c.mu))
    for (n, a), (_, b) in zip(named_leaves(p_g), named_leaves(p_c)):
        d = (a.cpu() - b).abs()
        require(float(d.max()) <= 2 * lr, f"card vs CPU params {n}: {float(d.max())}")
        big = mu[n].abs() > 1e-3 * float(mu[n].abs().max())
        worst_big = max(worst_big, float(d[big].max()) if bool(big.any()) else 0.0)
        worst = max(worst, float(d.max()))
    return dict(loss_card=loss_g, loss_cpu=loss_c, grad_norm_card=gn_g, grad_norm_cpu=gn_c,
                max_grad_err_of_leaf_max=grad_err, max_abs_param_diff=worst,
                max_abs_param_diff_large_moment=worst_big,
                tolerance="gradients 1e-3 x max|grad| + 1e-7 a leaf; loss rtol 1e-5, "
                          "grad norm rtol 1e-4, params 2 lr")


def deepfm_train(torch, args, tmp):
    """deepfm at full width: ``TRAIN_STEPS`` TrainLoop steps on
    ``SHAPES["train_batch"]`` with async checkpoints, a second loop that
    restores and resumes at the saved step bit for bit, the card against the
    CPU at a cut batch, and the step beside its bound."""
    from repro_torch.common.pytree import named_leaves, tree_size
    from repro_torch.configs import deepfm
    from repro_torch.data import synthetic
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.models import recsys
    from repro_torch.optim import adam_init
    from repro_torch.train import TrainerConfig, TrainLoop

    cfg = deepfm.CONFIG
    B = deepfm.SHAPES["train_batch"]["batch"]
    vocab = np.array(cfg.vocab_sizes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = recsys.init_recsys(torch.Generator(device="cuda").manual_seed(args.seed), cfg,
                                device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = tree_size(params)
    t0 = time.time()
    host = [synthetic.make_clicks(B, cfg.n_fields, vocab, seed=args.seed + i)
            for i in range(TRAIN_STEPS + 1)]
    data_s = time.time() - t0
    batches = [{"ids": d["ids"], "labels": d["labels"]} for d in host]
    step = recsys.make_train_step(cfg)
    sink = []
    tc = TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS // 2,
                       checkpoint_dir=os.path.join(tmp, "deepfm"), log_every=0)
    loop = TrainLoop(tc, timed_step(torch, step, sink), params, adam_init(params),
                     logger=lambda s: None)
    t0 = time.time()
    out = loop.run(ShardedLoader(batches[:TRAIN_STEPS], device="cuda"))
    torch.cuda.synchronize()
    loop_s = time.time() - t0
    ms = elapsed_ms(torch, sink)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [h["loss"] for h in out["history"]]
    require(out["final_step"] == TRAIN_STEPS and all(np.isfinite(losses))
            and out["nan_skips"] == 0 and out["retries"] == 0, f"deepfm loop: {out}")
    # one save measured alone: the blocking host copy, then the write
    mgr = loop.ckpt
    t0 = time.perf_counter()
    mgr.save_async(TRAIN_STEPS, (loop.params, loop.opt_state))
    snap_s = time.perf_counter() - t0
    mgr.wait()
    write_s = time.perf_counter() - t0 - snap_s
    # a second loop from another init restores and resumes at the saved step
    p2 = recsys.init_recsys(torch.Generator(device="cuda").manual_seed(args.seed + 1), cfg,
                            device="cuda")
    loop2 = TrainLoop(tc.replace(total_steps=TRAIN_STEPS + 1), step, p2, adam_init(p2),
                      logger=lambda s: None)
    del p2
    t0 = time.time()
    require(loop2.try_restore() and loop2.step == TRAIN_STEPS, "deepfm: no resume")
    restore_s = time.time() - t0
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
               for (_, a), (_, b) in zip(named_leaves((loop.params, loop.opt_state)),
                                         named_leaves((loop2.params, loop2.opt_state))))
    require(same, "deepfm: restored state differs from the saved one")
    out2 = loop2.run(ShardedLoader(batches[TRAIN_STEPS:], device="cuda"))
    require(out2["final_step"] == TRAIN_STEPS + 1 and np.isfinite(out2["history"][-1]["loss"]),
            f"deepfm resumed loop: {out2}")
    del loop2
    # the card against the CPU on the first TRAIN_CUT_BATCH rows
    cut = {k: torch.as_tensor(v[:TRAIN_CUT_BATCH]).cuda() for k, v in batches[0].items()}
    t0 = time.time()
    vs_cpu = step_card_vs_cpu(torch, step, lambda p, b: recsys.ctr_loss(p, b, cfg),
                              loop.params, loop.opt_state, cut)
    vs_cpu["s"] = time.time() - t0
    full = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
    trace = profile_call(torch, lambda: step(loop.params, loop.opt_state, full))
    del full
    # bound: the function's state (params, m, v) read once and written once
    # in fp32 and the batch read once, against the MLP's products forward and
    # backward (3x the forward's) at the fp32 rate
    dims = (cfg.n_fields * cfg.embed_dim, *cfg.mlp_dims, 1)
    nbytes = 6 * 4 * n_params + B * (cfg.n_fields + 1) * 4
    flops = 3 * mlp_flops(dims, B)
    b_ms, b_by = bound(nbytes, flops)
    warm = float(np.median(ms[1:]))
    del loop, params
    return dict(config=cfg.name, shape="train_batch", batch=B, n_params=n_params,
                table_rows=cfg.total_vocab, init_s=init_s, data_s=data_s,
                step_ms=ms, step_ms_median_warm=warm, loss=losses,
                loop_s=loop_s, peak_gib=peak, save_snapshot_s=snap_s, save_write_s=write_s,
                checkpoint_gb=3 * 4 * n_params / 1e9, restore_s=restore_s,
                resumed_at=TRAIN_STEPS, resumed_bits_equal=same,
                resumed_loss=out2["history"][-1]["loss"], card_vs_cpu=vs_cpu,
                traced_step=trace,
                cut_batch=TRAIN_CUT_BATCH, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                flops=flops, bound_note="bytes: params, m, v read and written once (fp32) "
                "and the batch; operations: the MLP forward and backward at 67 TFLOP/s fp32",
                share_of_bound=b_ms / warm)


def xdeepfm_train(torch, args):
    """xdeepfm at full width on ``SHAPES["train_batch"]``: ``XDEEPFM_STEPS``
    steps with the CIN run a chunk of rows at a time (``recsys.cin_layer``:
    the one-shot (65,536, 200, 39, 10) product would be 20 GB), the step
    beside its bound."""
    from repro_torch.common.pytree import tree_size
    from repro_torch.configs import xdeepfm
    from repro_torch.data import synthetic
    from repro_torch.models import recsys
    from repro_torch.optim import adam_init

    cfg = xdeepfm.CONFIG
    B = xdeepfm.SHAPES["train_batch"]["batch"]
    d = synthetic.make_clicks(B, cfg.n_fields, np.array(cfg.vocab_sizes), seed=args.seed)
    batch = {"ids": torch.as_tensor(d["ids"]).cuda(), "labels": torch.as_tensor(d["labels"]).cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = recsys.init_recsys(torch.Generator(device="cuda").manual_seed(args.seed), cfg,
                                device="cuda")
    opt = adam_init(params)
    step = recsys.make_train_step(cfg)
    sink, losses = [], []
    run = timed_step(torch, step, sink)
    for _ in range(XDEEPFM_STEPS):
        params, opt, m = run(params, opt, batch)
        losses.append(float(m["loss"]))
    ms = elapsed_ms(torch, sink)
    require(all(np.isfinite(losses)), f"xdeepfm: losses {losses}")
    n_params = tree_size(params)
    F, dim = cfg.n_fields, cfg.embed_dim
    hs = (F, *cfg.cin_dims)
    # the CIN: an outer product (H_k F d a row) and its contraction (2 H H_k F d)
    cin = sum(B * dim * hs[i] * F * (1 + 2 * hs[i + 1]) for i in range(len(cfg.cin_dims)))
    flops = 3 * (cin + mlp_flops((F * dim, *cfg.mlp_dims, 1), B))
    nbytes = 6 * 4 * n_params + B * (F + 1) * 4
    b_ms, b_by = bound(nbytes, flops)
    warm = float(np.median(ms[1:]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, opt
    return dict(config=cfg.name, shape="train_batch", batch=B, n_params=n_params,
                cin_chunk_rows=recsys.CIN_CHUNK_ELEMS // (max(hs[:-1]) * F * dim),
                step_ms=ms, step_ms_median_warm=warm, loss=losses, peak_gib=peak,
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                bound_note="operations: the CIN's outer products and contractions and the "
                "MLP, forward and backward (the chunks' recompute not counted), at 67 TFLOP/s "
                "fp32", share_of_bound=b_ms / warm)


def cora_like(rng, spec, cfg):
    """A Cora-shaped graph: ``n_nodes`` nodes with sparse binary features
    (about 18 words of ``d_node_in``), ``n_edges`` uniform random edges,
    class labels, 140 labelled nodes (Cora's training split)."""
    N, E = spec["n_nodes"], spec["n_edges"]
    return {"node_feat": (rng.random((N, cfg.d_node_in)) < 18 / cfg.d_node_in).astype(np.float32),
            "edge_feat": rng.standard_normal((E, cfg.d_edge_in)).astype(np.float32),
            "senders": rng.integers(0, N, E).astype(np.int32),
            "receivers": rng.integers(0, N, E).astype(np.int32),
            "labels": rng.integers(0, cfg.d_out, N).astype(np.int32),
            "label_mask": (np.arange(N) < 140).astype(np.float32)}


def molecules(rng, spec, cfg):
    """``n_graphs`` graphs of ``n_nodes / n_graphs`` nodes, each with
    ``n_edges / n_graphs`` random edges inside it, and a target a graph."""
    G = spec["n_graphs"]
    n, e = spec["n_nodes"] // G, spec["n_edges"] // G
    base = np.repeat(np.arange(G) * n, e)
    return {"node_feat": rng.standard_normal((G * n, cfg.d_node_in)).astype(np.float32),
            "edge_feat": rng.standard_normal((G * e, cfg.d_edge_in)).astype(np.float32),
            "senders": (base + rng.integers(0, n, G * e)).astype(np.int32),
            "receivers": (base + rng.integers(0, n, G * e)).astype(np.int32),
            "labels": np.zeros((G * n, cfg.d_out), np.float32),
            "graph_ids": np.repeat(np.arange(G), n).astype(np.int32),
            "graph_labels": rng.standard_normal((G, cfg.d_out)).astype(np.float32)}


def gnn_train(torch, args, shape, make):
    """meshgraphnet at full width on one of its SHAPES: ``GNN_STEPS`` steps
    (CUDA events), the card against the CPU, the step beside its bound."""
    from repro_torch.common.pytree import tree_size
    from repro_torch.configs import meshgraphnet
    from repro_torch.models import gnn
    from repro_torch.optim import adam_init

    spec = meshgraphnet.SHAPES[shape]
    cfg = spec["cfg"]
    b = make(np.random.default_rng(args.seed), spec, cfg)
    batch = {k: torch.as_tensor(v).cuda() for k, v in b.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = gnn.init_gnn(torch.Generator(device="cuda").manual_seed(args.seed), cfg,
                          device="cuda")
    opt = adam_init(params)
    step = gnn.make_train_step(cfg)
    sink, losses = [], []
    run = timed_step(torch, step, sink)
    for _ in range(GNN_STEPS):
        params, opt, m = run(params, opt, batch)
        losses.append(float(m["loss"]))
    ms = elapsed_ms(torch, sink)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(np.isfinite(losses)), f"meshgraphnet {shape}: losses {losses}")
    t0 = time.time()
    vs_cpu = step_card_vs_cpu(torch, step, lambda p, b: gnn.loss_fn(p, b, cfg), params, opt,
                              batch)
    vs_cpu["s"] = time.time() - t0
    trace = profile_call(torch, lambda: step(params, opt, batch))
    N, E, dh = spec["n_nodes"], spec["n_edges"], cfg.d_hidden
    hid = [dh] * cfg.mlp_layers
    fwd = (mlp_flops((cfg.d_node_in, *hid, dh), N) + mlp_flops((cfg.d_edge_in, *hid, dh), E)
           + cfg.n_layers * (mlp_flops((3 * dh, *hid, dh), E) + mlp_flops((2 * dh, *hid, dh), N))
           + mlp_flops((dh, *hid, cfg.d_out), N))
    n_params = tree_size(params)
    nbytes = 6 * 4 * n_params + sum(v.nbytes for v in b.values())
    b_ms, b_by = bound(nbytes, 3 * fwd)
    warm = float(np.median(ms[1:]))
    del params, opt
    return dict(config=cfg.name, shape=shape, n_nodes=N, n_edges=E, n_layers=cfg.n_layers,
                d_hidden=dh, d_node_in=cfg.d_node_in, d_out=cfg.d_out, n_params=n_params,
                step_ms=ms, step_ms_median_warm=warm, loss=losses, peak_gib=peak,
                card_vs_cpu=vs_cpu, traced_step=trace, bound_ms=b_ms, bound_by=b_by,
                flops=3 * fwd,
                bytes=nbytes, bound_note="operations: the MLPs forward and backward (3x the "
                "forward; the remat's recompute not counted) at 67 TFLOP/s fp32",
                share_of_bound=b_ms / warm)


def train_phase(torch, args, card):
    """The ``train`` line: the training path on the card -> (line, launches
    by part).  deepfm and meshgraphnet at full width, every arch through
    ``multi_arch_smoke``, the launcher (``--arch lemur``, then deepfm with a
    restart) and ``train_retrieval_e2e``, launch counters from 0 around each
    part.  Frees everything it made."""
    import tempfile

    from repro_torch.examples import multi_arch_smoke, train_retrieval_e2e
    from repro_torch.launch import train

    t_phase = time.time()
    line, launches, seconds = {"card": card}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        with counted(torch, launches, "deepfm"):
            line["deepfm"] = deepfm_train(torch, args, tmp)
        seconds["deepfm"] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        with counted(torch, launches, "xdeepfm"):
            line["xdeepfm"] = xdeepfm_train(torch, args)
        seconds["xdeepfm"] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        for shape, make in (("full_graph_sm", cora_like), ("molecule", molecules)):
            t0 = time.time()
            with counted(torch, launches, f"meshgraphnet_{shape}"):
                line[f"meshgraphnet_{shape}"] = gnn_train(torch, args, shape, make)
            seconds[f"meshgraphnet_{shape}"] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        with counted(torch, launches, "mesh_forms"):
            line["mesh_forms"] = train_mesh_forms(torch, args)
        seconds["mesh_forms"] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        with counted(torch, launches, "multi_arch_smoke"):
            res, _ = captured(multi_arch_smoke.main, [])
        require(len(res) == 10 and all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
                                       for m in res.values()), f"multi_arch_smoke: {res}")
        line["multi_arch_smoke"] = res
        seconds["multi_arch_smoke"] = time.time() - t0
        t0 = time.time()
        with counted(torch, launches, "launcher_lemur"):
            res, out = captured(train.main, ["--arch", "lemur", "--steps", "2"])
        require(re.search(r"^\[lemur\] backend=ivf recall@10 = \d\.\d{3}$", out, re.M)
                and res["recall"] > 0.05, f"launcher --arch lemur: {res}")
        require(all(launches["launcher_lemur"].get(k, 0) > 0 for k in TRAIN_KERNELS),
                f"launcher --arch lemur launched {launches['launcher_lemur']}")
        line["launcher_lemur"] = res
        seconds["launcher_lemur"] = time.time() - t0
        t0 = time.time()
        ck = os.path.join(tmp, "launcher")
        with counted(torch, launches, "launcher_deepfm"):
            argv = ["--arch", "deepfm", "--steps", "4", "--checkpoint-every", "2",
                    "--checkpoint-dir", ck]
            first, _ = captured(train.main, argv)
            again, out = captured(train.main, argv[:3] + ["6"] + argv[4:])
        require(first["final_step"] == 4 and again["restores"] == 1
                and again["final_step"] == 6 and len(again["history"]) == 2
                and re.search(r"^\[train\] done: step 6, loss \S+, retries=0 nan_skips=0 "
                              r"stragglers=\d+$", out, re.M), f"launcher deepfm: {again}")
        line["launcher_deepfm"] = {"first": first["final_step"], "resumed": 4,
                                   "final": again["final_step"], "loss": again["loss"]}
        seconds["launcher_deepfm"] = time.time() - t0
        t0 = time.time()
        with counted(torch, launches, "train_retrieval_e2e"):
            res, _ = captured(train_retrieval_e2e.main, ["--steps", "20"])
        require(np.isfinite(res["loss"]) and res["recall"] > 0.05,
                f"train_retrieval_e2e: {res}")
        require(all(launches["train_retrieval_e2e"].get(k, 0) > 0 for k in TRAIN_KERNELS),
                f"train_retrieval_e2e launched {launches['train_retrieval_e2e']}")
        line["train_retrieval_e2e"] = res
        seconds["train_retrieval_e2e"] = time.time() - t0
    line.update(launches=launches, seconds=seconds, s=time.time() - t_phase)
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches


# --------------------------------------------------------------------------
# the mesh forms at full width, and the dist phase: two-tower retrieval on a
# one-rank NCCL mesh, then three cells of the single-pod mesh (a fake group
# of 256 ranks) dry-run and run for real at rank 0's shapes
# --------------------------------------------------------------------------

MESH_DECODE_STEPS = 8
DIST_CELLS = (("lemur", "serve_msmarco"), ("deepfm", "train_batch"),
              ("gemma-7b", "decode_32k"))


def lm_mesh_serve(torch, cfg, params, toks, fed, want_prefill, want_steps):
    """The LM's mesh forms on a one-rank NCCL (1, 1) ("data", "model") mesh:
    a prefill of the same tokens and MESH_DECODE_STEPS decode steps fed the
    same tokens, each step's logits within ``lm.BF16_LOGIT_RTOL`` x max
    |logit| of the ``mesh=None`` logits."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import lm

    B, T = toks.shape
    out = {"mesh": [1, 1], "steps": len(fed), "rtol": lm.BF16_LOGIT_RTOL}
    errs = []
    with nccl_mesh(torch, (1, 1), ("data", "model")) as mesh, torch.no_grad():
        local = sh.shard_tree(params, lm.lm_specs(cfg, params), mesh)
        require(lm.mesh_layout(mesh, B, T).cp, f"{cfg.name}: the mesh prefill is not "
                "context-parallel")
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = lm.prefill(local, toks, cfg, T + len(fed), mesh)
        torch.cuda.synchronize()
        out["prefill_s"] = time.time() - t0
        for s, (want, tok) in enumerate([(want_prefill, None)] + list(zip(want_steps, fed))):
            if tok is not None:
                logits, caches = lm.decode(local, tok, caches, T + s, cfg, mesh)
            err, scale = float((logits.float() - want).abs().max()), float(want.abs().max())
            require(err <= lm.BF16_LOGIT_RTOL * scale,
                    f"{cfg.name} mesh form step {s}: {err} > {lm.BF16_LOGIT_RTOL} x {scale}")
            errs.append(err / scale)
        del caches, logits, local
    out["max_abs_err_of_max_logit"] = max(errs)
    out["per_step_err_of_max_logit"] = errs
    return out


def mesh_vs_plain_steps(torch, step_mesh, step_plain, params, opt, mesh_args, batch,
                        n=2, lr=1e-3):
    """``n`` steps of a mesh form against ``n`` of its ``mesh=None`` form from
    one state.  After each step: loss rtol 1e-5, grad norm rtol 1e-4, and
    every leaf's new first moment (the clipped gradient folded into Adam's
    mean, so a per-leaf gradient check) within 1e-4 x its max + 1e-9 (the
    CPU parity tests' ``check_step``).  After the last: the parameters
    within 1e-5 x max(1, max |p|) wherever the first moment is above 1e-3 x
    its leaf's max, and within 2 lr + 2e-6 a step everywhere (Adam moves a
    parameter by less than lr a step; fp32 rounding of |p| < 8)."""
    from repro_torch.common.pytree import named_leaves

    pm, om = params, opt
    pp, op = params, opt
    worst_loss = worst_gn = worst_mu = 0.0
    for _ in range(n):
        pm, om, mm = step_mesh(*mesh_args(pm, om), batch)
        pp, op, mp = step_plain(pp, op, batch)
        lm_, lp = float(mm["loss"]), float(mp["loss"])
        gm, gp = float(mm["grad_norm"]), float(mp["grad_norm"])
        require(abs(lm_ - lp) <= 1e-5 * abs(lp), f"mesh vs plain loss {lm_} {lp}")
        require(abs(gm - gp) <= 1e-4 * abs(gp), f"mesh vs plain grad norm {gm} {gp}")
        worst_loss = max(worst_loss, abs(lm_ - lp) / abs(lp))
        worst_gn = max(worst_gn, abs(gm - gp) / abs(gp))
        for (k, a), (_, b) in zip(named_leaves(om.mu), named_leaves(op.mu)):
            d, scale = float((a - b).abs().max()), float(b.abs().max())
            require(d <= 1e-4 * scale + 1e-9, f"mesh vs plain first moment {k}: {d} of {scale}")
            worst_mu = max(worst_mu, d / max(scale, 1e-30))
    worst = worst_big = 0.0
    mu = dict(named_leaves(op.mu))
    for (k, a), (_, b) in zip(named_leaves(pm), named_leaves(pp)):
        diff = (a - b).abs()
        d = float(diff.max())
        require(d <= (2 * lr + 2e-6) * n, f"mesh vs plain params {k}: {d}")
        big = mu[k].abs() > 1e-3 * float(mu[k].abs().max())
        if bool(big.any()):
            db = float(diff[big].max())
            require(db <= 1e-5 * max(1.0, float(b.abs().max())),
                    f"mesh vs plain params {k} (large moment): {db}")
            worst_big = max(worst_big, db)
        worst = max(worst, d)
    return dict(steps=n, max_rel_loss_diff=worst_loss, max_rel_grad_norm_diff=worst_gn,
                max_first_moment_diff_of_leaf_max=worst_mu, max_abs_param_diff=worst,
                max_abs_param_diff_large_moment=worst_big, loss=lp,
                tolerance="loss rtol 1e-5, grad norm rtol 1e-4, first moments 1e-4 x leaf max "
                          "+ 1e-9 a step; params 1e-5 x max(1, |p|) where the moment is large, "
                          "2 lr + 2e-6 a step elsewhere")


def train_mesh_forms(torch, args):
    """deepfm at full width (batch 65,536): two ``make_train_step(cfg, mesh)``
    steps on a one-rank NCCL (1, 1) mesh against two ``mesh=None`` steps;
    meshgraphnet ``full_graph_sm``: its forward and one train step the same
    way."""
    from repro_torch.configs import deepfm, meshgraphnet
    from repro_torch.data import synthetic
    from repro_torch.dist import sharding as sh
    from repro_torch.models import gnn, recsys
    from repro_torch.optim import adam_init

    out = {}
    cfg = deepfm.CONFIG
    B = deepfm.SHAPES["train_batch"]["batch"]
    d = synthetic.make_clicks(B, cfg.n_fields, np.array(cfg.vocab_sizes), seed=args.seed)
    batch = {"ids": torch.as_tensor(d["ids"]).cuda(), "labels": torch.as_tensor(
        d["labels"]).cuda()}
    params = recsys.init_recsys(torch.Generator(device="cuda").manual_seed(args.seed), cfg,
                                device="cuda")
    opt = adam_init(params)
    with nccl_mesh(torch, (1, 1), ("data", "model")) as mesh:
        specs = sh.spec_tree(params, sh.RECSYS_RULES)
        t0 = time.time()
        out["deepfm"] = mesh_vs_plain_steps(
            torch, recsys.make_train_step(cfg, mesh), recsys.make_train_step(cfg), params,
            opt, lambda p, o: (sh.shard_tree(p, specs, mesh), o), batch)
        out["deepfm"].update(batch=B, s=time.time() - t0)
        del params, opt, batch
        gc.collect()
        torch.cuda.empty_cache()
        spec = meshgraphnet.SHAPES["full_graph_sm"]
        gcfg = spec["cfg"]
        b = cora_like(np.random.default_rng(args.seed), spec, gcfg)
        gb = {k: torch.as_tensor(v).cuda() for k, v in b.items()}
        gb["senders"], gb["receivers"] = gb["senders"].long(), gb["receivers"].long()
        gp = gnn.init_gnn(torch.Generator(device="cuda").manual_seed(args.seed), gcfg,
                          device="cuda")
        with torch.no_grad():
            f = lambda m: gnn.forward(gp, gb["node_feat"], gb["edge_feat"], gb["senders"],
                                      gb["receivers"], gcfg, m)
            want, got = f(None), f(mesh)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        require(err <= 1e-5 * max(scale, 1.0), f"meshgraphnet mesh forward {err} of {scale}")
        t0 = time.time()
        out["meshgraphnet_full_graph_sm"] = mesh_vs_plain_steps(
            torch, gnn.make_train_step(gcfg, mesh), gnn.make_train_step(gcfg), gp,
            adam_init(gp), lambda p, o: (p, o), gb, n=1)
        out["meshgraphnet_full_graph_sm"].update(
            forward_max_abs_err=err, forward_max_abs=scale, s=time.time() - t0)
    return out


def dist_cells_main(out_path):
    """The dist phase's cells, in a process of its own (a process has one
    default group): a fake group of 256 ranks as rank 0, the single-pod
    mesh; for each of DIST_CELLS ``dryrun.run_cell`` and rank 0's step run
    on the card at its local shapes, launch counters from 0 around the real
    steps.  Writes its results as JSON to ``out_path``."""
    import torch
    import torch.distributed as tdist

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.registry import build_cell
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_production_mesh

    torch.cuda.set_device(0)
    res = {"cells": {}}
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cuda")
        try:   # does the fake backend take CUDA tensors?
            t = torch.ones(8, device="cuda")
            tdist.all_reduce(t, group=mesh.get_group("model"))
            parts = [torch.empty_like(t) for _ in range(16)]
            tdist.all_gather(parts, t, group=mesh.get_group("data"))
            torch.cuda.synchronize()
            res["fake_backend_takes_cuda"] = True
        except Exception as e:  # noqa: BLE001 -- recorded; the bytes are still checked
            res["fake_backend_takes_cuda"] = False
            res["fake_backend_error"] = repr(e)[:500]
        launches = {}
        for arch, shape in DIST_CELLS:
            t0 = time.time()
            rec = dryrun.run_cell(arch, shape, mesh)
            cell = build_cell(arch, shape, mesh)
            args = dryrun.local_args(cell, mesh, "cuda", fill=True)
            nbytes = dryrun.tree_nbytes(args)
            row = roofline.summarize(rec, 256)
            line = {"dry_run_s": rec["run_s"], "argument_bytes_dry_run":
                    rec["memory"]["argument_bytes"], "argument_bytes_real": nbytes,
                    "peak_bytes_dry_run": rec["memory"]["peak_bytes"],
                    "flops_per_device": rec["flops_loop_corrected"],
                    "bytes_per_device": rec["bytes_loop_corrected"],
                    "collective_bytes_per_device": rec["collectives_loop_corrected"][
                        "total_bytes"],
                    "t_compute_ms": row["t_compute_s"] * 1e3,
                    "t_memory_ms": row["t_memory_s"] * 1e3,
                    "t_collective_ms": row["t_collective_s"] * 1e3,
                    "bound_ms": max(row["t_compute_s"], row["t_memory_s"]) * 1e3,
                    "bound_by": "operations" if row["t_compute_s"] >= row["t_memory_s"]
                    else "bytes",
                    "bound_note": "the dry run's FLOPs at 989 TFLOP/s bf16 and its unfused "
                                  "eager bytes at 3.35 TB/s; the collectives (t_collective_ms "
                                  "at 50 GB/s) move nothing on the fake group"}
            if res["fake_backend_takes_cuda"]:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                cell.fn(*args)                               # warm-up
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                times = []
                for _ in range(3):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    cell.fn(*args)
                    e1.record()
                    torch.cuda.synchronize()
                    times.append(e0.elapsed_time(e1))
                launches[f"{arch}|{shape}"] = {k: v for k, v in ops.launch_counts().items()
                                               if v}
                line.update(step_ms=times, step_ms_median=float(np.median(times)),
                            max_memory_allocated=torch.cuda.max_memory_allocated(),
                            args_allocated=nbytes, memory_before_step=base,
                            share_of_bound=line["bound_ms"] / float(np.median(times)))
            line["s"] = time.time() - t0
            res["cells"][f"{arch}|{shape}"] = line
            del args, cell
            gc.collect()
            torch.cuda.empty_cache()
        res["launches"] = launches
    with open(out_path, "w") as f:
        json.dump(res, f)


def dist_phase(torch, args, card):
    """The ``dist`` line (launch counters from 0 around each part): two-tower
    at full width (``configs/two_tower.CONFIG``) ``make_retrieval_step`` on a
    one-rank NCCL (1, 1) mesh over ``retrieval_cand``'s 1,000,000
    candidates, k 100, its ids against the ``mesh=None`` scores' stable top
    100; then the cells of DIST_CELLS in a process of its own
    (:func:`dist_cells_main`): each dry run's ``argument_bytes`` required
    equal to the real local arguments' bytes.  -> (line, launches by part)."""
    import tempfile

    from repro_torch.anns.base import stable_topk
    from repro_torch.configs import two_tower
    from repro_torch.models import recsys

    t_phase = time.time()
    line, launches = {"card": card}, {}
    cfg = two_tower.CONFIG
    n_cand = two_tower.SHAPES["retrieval_cand"]["n_candidates"]
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    with counted(torch, launches, "two_tower_retrieval"):
        params = recsys.init_recsys(g, cfg, device="cuda")
        cand = torch.randn((n_cand, cfg.out_dim), device="cuda", generator=g)
        ids = torch.stack([torch.randint(0, v, (1,), device="cuda", generator=g)
                           for v in cfg.vocab_sizes], 1)
        with torch.no_grad():
            u = recsys.two_tower_user(params, ids, cfg)
            # the 10 best rows copied into the second half: exact ties in the top 100
            best = stable_topk(u @ cand.T, 10)[1][0]
            taken = set(best.tolist())
            dest = [i for i in range(n_cand // 2, n_cand // 2 + 20) if i not in taken][:10]
            cand[torch.tensor(dest, device="cuda")] = cand[best]
            scores = u @ cand.T
        want_s, want_i = stable_topk(scores, 100)
        plain_ms = time_ms(torch, lambda: recsys.make_retrieval_step(cfg, None, k=100)(
            params, {"ids": ids}, cand), n=5, warmup=1)
        with nccl_mesh(torch, (1, 1), ("data", "model")) as mesh:
            step = recsys.make_retrieval_step(cfg, mesh, k=100)
            got_s, got_i = step(params, {"ids": ids}, cand)
            mesh_ms = time_ms(torch, lambda: step(params, {"ids": ids}, cand), n=5, warmup=1)
        require(torch.equal(got_i, want_i), "two-tower retrieval: ids differ from the "
                "mesh=None scores' top 100")
        require(int((want_s[0, 1:] == want_s[0, :-1]).sum()) >= 10, "two-tower retrieval: "
                "the copied rows tie with no other")
        require(bool(torch.equal(got_s, want_s)), "two-tower retrieval: scores differ")
        line["two_tower_retrieval"] = dict(
            n_candidates=n_cand, k=100, out_dim=cfg.out_dim, ids_equal=True,
            ties_in_top100=int((want_s[0, 1:] == want_s[0, :-1]).sum()),
            mesh_ms=mesh_ms, plain_ms=plain_ms)
        del params, cand, scores, u
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dist_cells.json")
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--dist-cells", path],
                           capture_output=True, text=True, timeout=600)
        require(r.returncode == 0, f"dist cells: {r.stderr[-3000:]}")
        with open(path) as f:
            cells = json.load(f)
    line["cells_s"] = time.time() - t0
    for key, c in cells["cells"].items():
        require(c["argument_bytes_dry_run"] == c["argument_bytes_real"],
                f"{key}: dry-run argument bytes {c['argument_bytes_dry_run']} != real "
                f"{c['argument_bytes_real']}")
    if cells["fake_backend_takes_cuda"]:
        lemur = cells["launches"].get("lemur|serve_msmarco", {})
        require(lemur.get("fused_psi_pool", 0) > 0 and lemur.get("rerank_gather_scores", 0) > 0,
                f"lemur serve cell launched {lemur}")
    launches.update(cells["launches"])
    line.update(cells, launches=launches, s=time.time() - t_phase)
    return line, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build-m", type=int, default=200_000, help="docs the build runs on")
    ap.add_argument("--m", type=int, default=800_000, help="docs of the served index")
    ap.add_argument("--batches", type=int, default=4, help="timed batches")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-cells", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if args.dist_cells:          # the dist phase's own process (dist_phase)
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
        dist_cells_main(args.dist_cells)
        return

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build

    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.time()
    reports = build.build()
    t_build = time.time() - t0
    print(f"build: {len(reports)} kernels compiled in {t_build:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # the ragged cases, then the launchers while the process holds nothing large
    ragged = (ragged_case(torch, args.seed), routes_ragged_case(torch, args.seed),
              residual_ragged_case(torch, args.seed))
    print(f"ragged cases ok (serving, query_fused / mips_topk / mips_sq8, residual): "
          f"max abs err {ragged}", flush=True)
    launch_line, launch_launches = launch_phase(torch, args, card)
    print(json.dumps({"launch": launch_line}, default=str), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"lm": lm_phase(torch, args, card)}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    train_line, train_launches = train_phase(torch, args, card)
    print(json.dumps({"train": train_line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    dist_line, dist_launches = dist_phase(torch, args, card)
    print(json.dumps({"dist": dist_line}), flush=True)

    build_line, maxsim_row, psi_build_launches, fleet_lifecycle = build_phase(torch, args, card)
    build_line.update(kernel_build_s=t_build)
    print(json.dumps({"build": build_line}), flush=True)
    print(json.dumps({"fleet": fleet_lifecycle["fleet"]}), flush=True)
    print(json.dumps({"lifecycle": fleet_lifecycle["lifecycle"]}), flush=True)
    t0 = time.time()
    widths = widths_phase(torch, args.seed)
    print(json.dumps({"widths": {"max_abs_err": widths, "s": time.time() - t0}}), flush=True)

    torch.cuda.reset_peak_memory_stats()
    (serving, routes, residual, sharded, mutation, online, backends,
     kernels) = serve_and_check(torch, args, ragged)
    serving.update(card=card, build_s=t_build, total_s=time.time() - t_start)
    kernels[0]["launches_per_build"] = psi_build_launches     # unpooled form, Gram features
    maxsim_row["launches_mutation_path"] = {
        name: rd["launches"].get("token_maxsim", 0) for name, rd in (
            [(f"round_{i}", rd) for i, rd in enumerate(mutation["rounds"])]
            + [("residual_round", mutation["residual_round"]),
               ("sharded_round", mutation["sharded_round"])])}
    maxsim_row["launches_backend_rounds"] = {
        name: b["round"]["launches"].get("token_maxsim", 0)
        for name, b in backends["backends"].items() if "round" in b}
    kernels.append(maxsim_row)
    phase_launches = {
        "online": {k: sum(run["launches_per_micro_batch"].get(k, 0) * run["n_batches"]
                          for run in online["runs"].values()) for k in SERVE_KERNELS},
        "fleet": fleet_lifecycle["fleet"]["launches"],
        "lifecycle": fleet_lifecycle["lifecycle"]["launches"]}
    for row in kernels:
        row["launches_backend_routes"] = {
            name: b["launches"].get(row["name"], 0) for name, b in backends["backends"].items()}
        row["launches_online_fleet_lifecycle"] = {
            name: int(c.get(row["name"], 0)) for name, c in phase_launches.items()}
        row["launches_launch_phase"] = {
            part: int(c.get(row["name"], 0)) for part, c in launch_launches.items()}
        row["launches_train_phase"] = {
            part: int(c.get(row["name"], 0)) for part, c in train_launches.items()}
        row["launches_dist_phase"] = {
            part: int(c.get(row["name"], 0)) for part, c in dist_launches.items()}
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"routes": routes}), flush=True)
    print(json.dumps({"residual": residual}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"mutation": mutation}), flush=True)
    print(json.dumps({"online": online}), flush=True)
    print(json.dumps({"backends": backends}), flush=True)
    t0 = time.time()
    from repro_torch.kernels import psi_ablation
    ablation = psi_ablation.run()
    print(json.dumps({"psi_ablation": {**ablation, "s": time.time() - t0}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def psi_row(torch, psi, q, qm, x):
    """The psi kernel's checks beyond its plain version: the pool against an
    fp64 psi-pool (within ref.PSI_SPLIT_RTOL: the product runs on the tensor
    cores' TF32 split), two calls' bits, and the unpooled form on ``x`` (the
    build's 16,384 OLS rows: real query tokens) against its plain version
    and fp64, timed beside them with its bound."""
    from repro_torch.core.model import pool_queries
    from repro_torch.kernels import fused_psi, ref

    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    w64 = [t.double() for t in w]
    got = pool_queries(psi, q, qm)
    require(torch.equal(got, pool_queries(psi, q, qm)), "fused_psi_pool: two calls differ")
    exact = ref.psi_pool_ref(q.double(), qm, *w64)
    err64 = float((got.double() - exact).abs().max())
    tol64 = ref.PSI_SPLIT_RTOL * max(1.0, float(exact.abs().max()))
    require(err64 <= tol64, f"fused_psi_pool: max abs err against fp64 {err64} > {tol64}")
    n, d = x.shape
    dp = w[0].shape[1]
    feats = fused_psi.fused_psi(x, *w)
    plain = ref.fused_psi_ref(x, *w)
    err = float((feats - plain).abs().max())
    require(err <= 1e-4 * max(1.0, float(plain.abs().max())),
            f"fused_psi (unpooled): max abs err {err}")
    exact = ref.fused_psi_ref(x[:2048].double(), *w64)
    err64_u = float((feats[:2048].double() - exact).abs().max())
    require(err64_u <= ref.PSI_SPLIT_RTOL * max(1.0, float(exact.abs().max())),
            f"fused_psi (unpooled): max abs err against fp64 {err64_u}")
    nbytes = x.numel() * 4 + (d * dp + 3 * dp) * 4 + n * dp * 4
    b_ms, b_by = bound(nbytes, 3 * 2 * n * d * dp, PEAK_TF32_S)
    return dict(max_abs_err_fp64=err64, tolerance_fp64=tol64, bits_equal_two_calls=True,
                unpooled=dict(shape=f"{n} rows x d {d} -> d' {dp}",
                              ms=time_ms(torch, lambda: fused_psi.fused_psi(x, *w)),
                              plain_ms=time_ms(torch, lambda: ref.fused_psi_ref(x, *w)),
                              bound_ms=b_ms, bound_by=b_by, bound_split="3xTF32",
                              bytes=int(nbytes), flops=int(2 * n * d * dp), max_abs_err=err,
                              max_abs_err_fp64_first_2048=err64_u))


def scan_spread(torch, probe, ids, kernel="ivf_probe_scan"):
    """How the probes spread over the lists: rows read probe by probe, the
    distinct live rows, readers a probed list (max, mean) and the largest
    work item of the kernel's grid by list (ivf_probe_scan or
    ivf_probe_res_scan; pairs: a chunk's queries x the live rows of its
    range of slots)."""
    import ctypes

    from repro_torch.kernels import build

    shape = (ctypes.c_int * 2)()
    getattr(build.library(kernel), f"{kernel}_item")(shape)
    per_q, per_r = shape[0], shape[1]
    nlist, cap = ids.shape
    pr = probe.long().flatten()
    pr = pr[(pr >= 0) & (pr < nlist)]
    readers = torch.bincount(pr, minlength=nlist)
    live = ids >= 0
    nr = -(-cap // per_r)
    live_r = torch.nn.functional.pad(live, (0, nr * per_r - cap)).reshape(nlist, nr, per_r)
    live_r = live_r.sum(-1).amax(-1)                       # the fullest range a list
    probed = readers > 0
    return dict(rows_read_probe_by_probe=int(live.sum(1)[pr].sum()),
                distinct_live_rows=int(live.sum(1)[probed].sum()),
                readers_max=int(readers.max()), readers_mean=float(readers[probed].float().mean()),
                item_queries=per_q, item_slots=per_r,
                largest_item_pairs=int((readers.clamp(max=per_q) * live_r).max()))


def serve_and_check(torch, args, ragged_cases):
    """Phases 2-8 on the card (``ragged_cases``: the three ragged cases'
    errors, run earlier); returns (serving numbers, routes line, residual
    line, sharded line, kernel rows)."""
    import gc

    from repro_torch.anns.ivf import default_nlist
    from repro_torch.core.model import pool_queries
    from repro_torch.kernels import gather_scan, ops, ref
    from repro_torch.retriever import LemurRetriever, SearchParams

    dev = torch.device("cuda")

    ragged, route_ragged, res_ragged = ragged_cases

    # -- 3. index at full width ---------------------------------------------
    t0 = time.time()
    store, psi, rng = build_corpus(torch, args)
    torch.cuda.synchronize()
    t_corpus = time.time() - t0
    cfg = paper().CONFIG                           # App. A: d'=2048, k=100, k'=1024
    t0 = time.time()
    r = LemurRetriever.from_arrays(cfg, psi, store,
                                   generator=torch.Generator().manual_seed(args.seed))
    torch.cuda.synchronize()
    t_ivf = time.time() - t0
    index = r.index
    ann = index.ann
    require(ann.nlist == default_nlist(args.m), "nlist is not default_nlist(m)")
    print(f"index: m={args.m} nlist={ann.nlist} cap={ann.capacity} "
          f"pages={store.n_pages} corpus {t_corpus:.1f} s, ivf {t_ivf:.1f} s",
          flush=True)

    p = r.resolve(SearchParams())
    require((p.k, p.k_prime, p.backend.nprobe) == (cfg.k, cfg.k_prime, cfg.ivf.nprobe),
            f"params {p}")
    batches = [make_queries(torch, store, rng, args.batch) for _ in range(args.batches + 1)]
    dead = torch.cat([batches[1][2][:8],
                      torch.as_tensor(rng.integers(0, args.m, 8), device=dev)]).unique()
    store.alive[dead] = False

    # -- 4. serve: the main path, counters from 0 ----------------------------
    ops.reset_launch_counts()
    lat, results, per_batch = [], [], []
    for i, (q, qm, _) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, ids = r.search(q, qm)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i:
            lat.append(dt)
        results.append((s, ids))
        per_batch.append(ops.launch_counts())
    launches = ops.launch_counts()
    for i, c in enumerate(per_batch):
        require(all(v == (i + 1 if k in SERVE_KERNELS else 0) for k, v in c.items()),
                f"launch counters after batch {i}: {c}")
    rr_path = gather_scan.rerank_paged_scores.last_path
    require(rr_path == "tensor cores", f"rerank_paged_scores: the served shape ran on the "
                                       f"{rr_path}")

    # -- 5. checks -----------------------------------------------------------
    ties = {"probe": 0, "candidates": 0, "final": 0}
    alive = store.alive
    valid_cands, plains = [], []
    for (q, qm, _), (s, ids) in zip(batches, results):
        require(s.shape == (args.batch, 100) and bool(torch.isfinite(s).all()),
                "scores not finite (B, 100)")
        plain = plain_search(torch, index, q, qm, p)
        plains.append(plain)
        stages = port_stages(torch, index, q, qm, p)
        n_valid = (stages["cand"] >= 0).sum(1)
        valid_cands.append(n_valid)
        require(bool((ids >= 0).all()),
                f"-1 ids in the top-100 of {int((ids < 0).any(1).sum())} rows; "
                f"valid candidates per row min {int(n_valid.min())} mean "
                f"{float(n_valid.float().mean()):.0f}; plain has -1 in "
                f"{int((plain['ids'] < 0).any(1).sum())} rows")
        require(not bool(torch.isin(ids.long(), dead).any()) and bool(alive[ids.long()].all()),
                "a tombstoned doc in the top-100")
        for kk, v in classify_rows(torch, ids, s, plain, stages, p.k_prime).items():
            ties[kk] += v
        exact = ref.rerank_scores_paged_ref(q, qm, ids, store.tok_pages,
                                            store.page_table, store.n_tokens, chunk=32)
        torch.testing.assert_close(s, exact, rtol=1e-5, atol=1e-4)
        require(bool((s[:, :-1] >= s[:, 1:]).all()), "scores not sorted")
    n_rows = args.batch * len(batches)
    print(f"checks ok: {n_rows} rows, near-tie rows by stage {ties}", flush=True)

    # -- 5b. the other routes, then their kernels at the served shapes -------
    routes, truth = routes_phase(torch, args, r, batches, plains,
                                 [ids for _, ids in results])
    del plains
    route_launches = {"query_fused": routes["one_launch_ivf"]["launches"]["query_fused"],
                      "mips_topk": routes["exact_one_launch"]["launches"]["mips_topk"],
                      "mips_sq8": routes["legacy_gathered"]["launches"]["mips_sq8"]}
    new_rows = route_kernel_rows(torch, r, batches, route_launches, route_ragged)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6. each kernel against its plain version, served shapes -------------
    q, qm, _ = batches[1]
    B, Tq, d = q.shape
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    dp = w[0].shape[1]
    st = port_stages(torch, index, q, qm, p)
    cand = st["cand"]
    kernels = []

    def entry(name, source, replaces, out, want, tol, fn, plain_fn, nbytes, flops, *,
              peak=PEAK_FP32_S, split=1, **extra):
        # flops: the function's operations; split: the products a split
        # (3xTF32) makes of each, counted in the bound at ``peak``
        fin = torch.isfinite(want)
        require(torch.equal(torch.isfinite(out), fin), f"{name}: pad pattern differs")
        err = float((out[fin] - want[fin]).abs().max())
        scale = max(1.0, float(want[fin].abs().max()))
        require(err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}")
        ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain_fn)
        b_ms, b_by = bound(nbytes, split * flops, peak)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], launches_per_search=launches[name] // len(batches),
            max_abs_err=err, tolerance=f"{tol} x max(1, max|plain|)",
            ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, peak=peak,
            bytes=int(nbytes), flops=int(flops), library_ms=None,
            **cuda_launches(torch, fn), **extra))

    nq_valid = int(qm.sum())
    psi_rows = psi_row(torch, psi, q, qm, torch.cat([b[0] for b in batches[:2]]).reshape(-1, d))
    entry("fused_psi_pool", "src/repro_torch/csrc/fused_psi_pool.cu",
          "src/repro/kernels/fused_psi.py:37",
          pool_queries(psi, q, qm), ref.psi_pool_ref(q, qm, *w), 1e-4,
          lambda: pool_queries(psi, q, qm), lambda: ref.psi_pool_ref(q, qm, *w),
          q.numel() * 4 + qm.numel() + (d * dp + 3 * dp) * 4 + B * dp * 4,
          2 * nq_valid * d * dp, peak=PEAK_TF32_S, split=3, bound_split="3xTF32",
          # the kernel computes every token's psi, masked or not
          bound_ms_all_tokens=3 * 2 * B * Tq * d * dp / PEAK_TF32_S * 1e3,
          bound_ms_fp32_cuda_cores=bound(q.numel() * 4 + qm.numel() + (d * dp + 3 * dp) * 4
                                         + B * dp * 4, 2 * nq_valid * d * dp)[0],
          **psi_rows)

    psi_q, probe = st["psi_q"], st["probe"]
    P, cap = probe.shape[1], ann.capacity
    uniq = probe.long().unique()
    rows_u = int(ann.counts[uniq].sum())
    scan_bytes = (len(uniq) * cap * 4 + rows_u * (dp * ann.vecs.element_size() + 4)
                  + psi_q.numel() * 4 + probe.numel() * 4 + B * P * cap * 4)
    rows_p = int(ann.counts[probe.long()].sum())      # rows read, probe by probe
    scan_ops = 2 * rows_p * dp
    spread = scan_spread(torch, probe, ann.ids)
    print(f"ivf_probe_scan spread: {json.dumps(spread)}", flush=True)
    entry("ivf_probe_scan", "src/repro_torch/csrc/ivf_probe_scan.cu",
          "src/repro/kernels/gather_scan.py:103",
          gather_scan.ivf_probe_scan(psi_q, probe, ann.ids, ann.vecs, ann.scales),
          ref.ivf_scan_ref(psi_q, probe, ann.ids, ann.vecs, ann.scales, chunk=4),
          SQ8_RTOL,
          lambda: gather_scan.ivf_probe_scan(psi_q, probe, ann.ids, ann.vecs, ann.scales),
          lambda: ref.ivf_scan_ref(psi_q, probe, ann.ids, ann.vecs, ann.scales, chunk=4),
          scan_bytes, scan_ops, **spread)

    pargs = (q, qm, cand, store.tok_pages, store.page_table, store.n_tokens)
    valid = cand >= 0
    nt = torch.where(valid, store.n_tokens[cand.clamp_min(0).long()], 0).long()
    # each distinct candidate once: its valid rows (not the rest of its last
    # page), its count and the page-table entries under ceil(n_tokens / 16)
    nt_u = store.n_tokens[cand[valid].long().unique()].long()
    rr_bytes = (int(nt_u.sum()) * d * 4 + int(((nt_u + 15) // 16).sum()) * 4 + len(nt_u) * 4
                + q.numel() * 4 + qm.numel() + 2 * cand.numel() * 4)
    rr_ops = 2 * int((nt * qm.sum(1, keepdim=True)).sum()) * d
    rr_plain = ref.rerank_scores_paged_ref(*pargs, chunk=16)
    rr_got = torch.where(valid, gather_scan.rerank_paged_scores(*pargs), 0.0)
    require(gather_scan.rerank_paged_scores.last_path == "tensor cores",
            "rerank_paged_scores: the served shape left the tensor cores")
    # the tensor cores' split against fp64 MaxSim over the stored tokens, 8 queries
    n8 = 8
    toks = store.tok_pages[store.page_table[cand[:n8].clamp_min(0).long()].long().clamp_min(0)]
    toks = toks.reshape(n8, cand.shape[1], -1, d)
    sc = torch.einsum("bqd,bktd->bkqt", q[:n8].double(), toks.double())
    pos = torch.arange(toks.shape[2], device=dev)
    sc = torch.where((pos < nt[:n8, :, None])[:, :, None, :], sc, ref.NEG)
    exact = torch.where(qm[:n8, None, :], sc.amax(-1), 0.0).sum(-1)
    ok8 = valid[:n8]
    rr_err64 = float((rr_got[:n8][ok8].double() - exact[ok8]).abs().max())
    require(rr_err64 <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact[ok8].abs().max())),
            f"rerank_paged_scores: max abs err against fp64 {rr_err64}")
    del toks, sc, exact
    entry("rerank_paged_scores", "src/repro_torch/csrc/rerank_paged.cu",
          "src/repro/kernels/gather_scan.py:261", rr_got,
          torch.where(valid, rr_plain, 0.0), 1e-5,
          lambda: gather_scan.rerank_paged_scores(*pargs),
          lambda: ref.rerank_scores_paged_ref(*pargs, chunk=16),
          rr_bytes, rr_ops, peak=PEAK_TF32_S, split=3, bound_split="3xTF32",
          # as in every tensor-core row: the bound had the products run on the
          # CUDA cores, the larger of the bytes and ops_ms_fp32
          bound_ms_fp32_cuda_cores=bound(rr_bytes, rr_ops)[0], path=rr_path,
          ops_ms_3xtf32=3 * rr_ops / PEAK_TF32_S * 1e3, ops_ms_fp32=rr_ops / PEAK_FP32_S * 1e3,
          max_abs_err_fp64=rr_err64)

    trace = profile_batch(torch, r, q, qm)
    lat_ms = [1e3 * x for x in lat]
    serving = dict(
        batches=len(lat), batch=args.batch, q_tokens=Tq,
        p50_ms=float(np.median(lat_ms)), max_ms=float(np.max(lat_ms)),
        qps=args.batch * len(lat) / sum(lat), k=p.k, k_prime=p.k_prime,
        nprobe=p.backend.nprobe, m=args.m, nlist=ann.nlist, cap=ann.capacity,
        dead_slots=int(len(dead)), near_tie_rows=ties, rows_checked=n_rows,
        valid_candidates_per_query=float(torch.cat(valid_cands).float().mean()),
        scanned_rows_per_query=int(ann.counts[st["probe"].long()].sum()) / B,
        empty_lists=int((ann.counts == 0).sum()),
        token_pool_bytes=store.tok_pages.numel() * 4,
        W_bytes=store.W.numel() * 4,
        list_bytes=sum(t.numel() * t.element_size() for t in
                       (ann.ids, ann.vecs, ann.scales, ann.centroids, ann.counts)),
        corpus_s=t_corpus, ivf_build_s=t_ivf,
        reduced={"m": args.m, "from": msmarco_docs(),
                 "why": "from_dense rounds the fp32 page pool to a power of two: "
                        "800k docs fill 2^22 pages (34.4 GB); 1M docs would need "
                        "2^23 (68.7 GB) beside W and the lists on an 80 GB card"},
        ragged_max_abs_err=ragged, traced_batch=trace,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    # -- 7. the residual tier beside it ----------------------------------------
    del st, cand
    gc.collect()
    torch.cuda.empty_cache()
    residual, res_rows = residual_phase(torch, args, r, batches, truth,
                                        routes["default_ivf"]["recall_at_10"], res_ragged)

    # -- 8. sharded serving, the residual tier freed -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lib_kp4096 = next(rw.get("library_ms_kp4096") for rw in new_rows
                      if rw["name"] == "mips_topk" and rw["variant"] == "sq8")
    sharded, sh_rows = sharded_phase(torch, args, r, batches, lib_kp4096)

    # -- 9. churn on the served index ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    mutation = mutation_phase(torch, args, r, batches, card_line())
    mutation["residual_round"] = residual.pop("churn_round")
    mutation["sharded_round"] = sharded.pop("churn_round")

    # -- 9c. online serving over the churned index -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    online = online_phase(torch, args, r, card_line())

    # -- 10. the other first-stage backends; the served retriever is handed
    # over, its IVF lists freed once the first backend is built ---------------
    gc.collect()
    torch.cuda.empty_cache()
    holder = [r]
    del r, index, ann
    backends = backends_phase(torch, args, holder, card_line())
    return (serving, routes, residual, sharded, mutation, online, backends,
            kernels + new_rows + res_rows + sh_rows)


if __name__ == "__main__":
    main()
