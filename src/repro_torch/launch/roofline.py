"""Roofline: the three roofline terms per (arch x shape) cell from the
dry-run records of ``launch/dryrun.py`` (twin of ``repro/launch/roofline.py``),
at the peaks of one NVIDIA H100 SXM5 80GB HBM3 (NVIDIA's data sheet):

  compute    t_c = FLOPs_per_device / PEAK_FLOPS    (989 TFLOP/s dense bf16)
  memory     t_m = bytes_per_device / HBM_BW        (3.35 TB/s HBM3)
  collective t_x = collective_bytes_per_device / LINK_BW  (50 GB/s)

``LINK_BW`` is one 400 Gb/s NIC a GPU: a 256-rank mesh spans 32 nodes of 8,
so its collectives cross the network (NVLink inside a node is faster).  The
numerators come from the step cost analysis (``launch/hlo_analysis.py``) of
one rank's eager step: every dispatched operation, loops included, so no
loop correction is needed; ``bytes`` is the unfused eager traffic.
``model_flops`` is the analytic useful work (6·N_active·D for training,
2·N_active·D a generated token for decode, family formulas otherwise); the
ratio MODEL_FLOPS / counted FLOPs exposes remat, dispatch and padding.

Usage:  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]
Writes results/roofline_<mesh>.json and a markdown table to stdout.
"""
from __future__ import annotations

import argparse
import json
import pathlib

PEAK_FLOPS = 989e12      # dense bf16 tensor cores, one H100 SXM
PEAK_TF32 = 495e12       # dense TF32 tensor cores (the 3xTF32 products' rate)
PEAK_FP32 = 67e12        # fp32 CUDA cores
HBM_BW = 3.35e12         # B/s, HBM3
LINK_BW = 50e9           # B/s: one 400 Gb/s NIC a GPU
CARD_BYTES = 80e9        # HBM3 of one H100 SXM5 80GB

TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
          "decode_32k": 128, "long_500k": 1}


def model_flops(arch: str, shape: str, n_chips: int) -> float:
    """Analytic useful FLOPs per device per step."""
    from repro_torch.configs.registry import get_arch

    mod = get_arch(arch)
    if mod.FAMILY == "lm":
        from repro_torch.models import lm

        cfg = mod.CONFIG
        n_active = lm.active_param_count(cfg)
        toks = TOKENS[shape]
        # attention score/AV flops (excluded from 6·N·D; dominant for MLA's
        # 128 heads × ~1.1k effective dim)
        if cfg.attn == "mla":
            dqk, dv = cfg.kv_lora + cfg.qk_rope, cfg.kv_lora
        else:
            dqk = dv = cfg.head_dim
        H = cfg.n_heads
        if shape == "train_4k":
            seq = 4096
            attn = 3.0 * 2.0 * 0.5 * seq * H * (dqk + dv) * cfg.n_layers * toks
            total = 6.0 * n_active * toks + attn
        elif shape == "prefill_32k":
            seq = 32768
            attn = 2.0 * 0.5 * seq * H * (dqk + dv) * cfg.n_layers * toks
            total = 2.0 * n_active * toks + attn
        else:  # decode: one new token against an S-token cache
            S = 32768 if shape == "decode_32k" else 524288
            attn = 2.0 * S * H * (dqk + dv) * cfg.n_layers * toks
            total = 2.0 * n_active * toks + attn
        return total / n_chips
    if mod.FAMILY == "gnn":
        cfg = mod.SHAPES[shape].get("cfg", mod.CONFIG)
        spec = mod.SHAPES[shape]
        dh = cfg.d_hidden
        mlp_cost = lambda d_in, d_out: 2 * (d_in * dh + (cfg.mlp_layers - 1) * dh * dh + dh * d_out)
        E = spec.get("n_edges", 0)
        if spec["kind"] == "sampled":  # two-hop sampled forward, not full E
            b = spec.get("batch_nodes", 1024)
            f1, f2 = cfg.fanout[0], cfg.fanout[1]
            n_enc = b * (1 + f1 + f1 * f2)
            total = n_enc * mlp_cost(cfg.d_node_in, dh) + b * (f1 + 1) * mlp_cost(2 * dh, dh) + b * mlp_cost(dh, cfg.d_out)
            return 3.0 * total / n_chips
        N = spec.get("n_nodes", 0)
        per_edge = mlp_cost(3 * dh, dh)
        per_node = mlp_cost(2 * dh, dh)
        enc = N * mlp_cost(cfg.d_node_in, dh) + E * mlp_cost(cfg.d_edge_in, dh)
        proc = cfg.n_layers * (E * per_edge + N * per_node)
        total = enc + proc + N * mlp_cost(dh, cfg.d_out)
        mult = 3.0 if spec["kind"] in ("full", "batched") else 1.0  # fwd+bwd
        return mult * total / n_chips
    if mod.FAMILY == "recsys":
        cfg = mod.CONFIG
        spec = mod.SHAPES[shape]
        B = spec.get("batch", spec.get("n_candidates", 1))
        d = cfg.embed_dim
        f = max(cfg.n_fields, 1)
        mlp_in = f * d if cfg.model in ("deepfm", "xdeepfm") else None
        per_ex = 0.0
        if cfg.model in ("deepfm", "xdeepfm"):
            dims = (f * d, *cfg.mlp_dims, 1)
            per_ex += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
            if cfg.model == "xdeepfm":
                hk = f
                for h in cfg.cin_dims:
                    per_ex += 2 * h * hk * f * d
                    hk = h
        elif cfg.model == "bst":
            L = cfg.seq_len + 1
            per_ex += 8 * L * d * d + 4 * L * L * d  # 1 block attention+proj
            per_ex += 2 * L * d * 4 * d * 2          # ffn
            dims = (L * d, *cfg.mlp_dims, 1)
            per_ex += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        else:  # two_tower
            dims_u = (f * d, *cfg.tower_dims, cfg.out_dim)
            per_ex += sum(2 * a * b for a, b in zip(dims_u[:-1], dims_u[1:]))
            if spec["kind"] == "retrieval":
                return (2.0 * B * cfg.out_dim) / n_chips * 1  # dot per candidate
            dims_i = (d, *cfg.tower_dims, cfg.out_dim)
            per_ex += sum(2 * a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
        mult = 3.0 if spec["kind"] == "train" else 1.0
        return mult * B * per_ex / n_chips
    if mod.FAMILY == "lemur":
        cfg = mod.CONFIG
        spec = mod.SHAPES[shape]
        m, T = spec["m"], spec["doc_tokens"]
        if spec["kind"] == "lemur_serve":
            B, Tq = spec["batch"], spec["q_tokens"]
            latent = 2.0 * B * m * cfg.d_prime                     # MIPS scan
            kpl = max(cfg.k, 4 * cfg.k_prime // n_chips)
            rerank = 2.0 * B * kpl * n_chips * Tq * T * cfg.d      # exact MaxSim
            psi = 2.0 * B * Tq * cfg.d * cfg.d_prime
            return (latent + rerank + psi) / n_chips
        # indexing: target matrix + OLS solves
        g = 2.0 * cfg.n_ols * m * T * cfg.d
        rhs = 2.0 * cfg.n_ols * cfg.d_prime * m
        solve = 2.0 * cfg.d_prime**2 * m
        return (g + rhs + solve) / n_chips
    raise ValueError(arch)


def summarize(rec: dict, n_chips: int) -> dict:
    flops = rec.get("flops_loop_corrected", rec.get("flops", 0.0))
    byts = rec.get("bytes_loop_corrected", rec.get("bytes_accessed", 0.0))
    coll = rec.get("collectives_loop_corrected", rec.get("collectives", {}))
    coll_b = coll.get("total_bytes", 0.0)
    mem = rec.get("memory", {})
    t_c = flops / PEAK_FLOPS
    t_m = byts / HBM_BW
    t_x = coll_b / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"], n_chips)
    step_time = max(terms.values())
    useful_frac = (mf / PEAK_FLOPS) / step_time if step_time > 0 else 0.0
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "dominant": dom,
        "hlo_flops": flops,
        "model_flops": mf,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": useful_frac,
        "hbm_bytes": byts,
        "collective_bytes": coll_b,
        "argument_gib": mem.get("argument_bytes", 0) / 2 ** 30,
        "peak_gib": mem.get("peak_bytes", 0) / 2 ** 30,
        "over_card": mem.get("peak_bytes", 0) > CARD_BYTES,
    }


def kernel_roofline(flops: float, hbm_bytes: float, measured_s: float, *,
                    peak_flops: float = PEAK_FLOPS) -> dict:
    """Roofline terms for ONE measured kernel launch (the benchmarks' per-row
    helper, vs :func:`summarize`'s per-step dry-run records).

    ``roofline_frac`` = ideal time (max of the compute and memory terms at
    the card's peaks) / measured wall time; 1.0 means the launch sits on the
    roofline.  The fraction is not capped: one above 1 means the FLOPs or
    bytes passed in overstate the launch's work (the caller flags it).  ``peak_flops`` is the rate of the operations the kernel
    runs: the bf16 tensor-core peak by default; the port's kernels run fp32
    (``PEAK_FP32``) and 3xTF32 products (``PEAK_TF32``).  On the CPU the
    fraction is tiny and only meaningful relatively (same op, shape and
    backend across runs)."""
    t_c = flops / peak_flops
    t_m = hbm_bytes / HBM_BW
    ideal = max(t_c, t_m)
    return {
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "dominant": "compute" if t_c >= t_m else "memory",
        "roofline_frac": ideal / max(measured_s, 1e-12),
    }


RECOMMEND = {
    "compute": "compute-bound: raise tensor-core utilization (bf16 everywhere, larger "
               "matmul tiles, drop remat where memory allows)",
    "memory": "memory-bound: fuse / shrink activation round-trips (the eager step "
              "runs unfused), quantize resident state (SQ8 corpus, int8 moments), "
              "raise arithmetic intensity per HBM pass",
    "collective": "collective-bound: reshard to cut all-gathers (kv-head vs "
                  "seq cache layout, 2D weight sharding), overlap collectives "
                  "with compute, compress cross-node traffic",
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", choices=["single", "multi"], default="single")
    p.add_argument("--results", default="results")
    args = p.parse_args(argv)

    path = pathlib.Path(args.results) / f"dryrun_{args.mesh}.json"
    recs = json.loads(path.read_text())
    n_chips = 512 if args.mesh == "multi" else 256

    rows = []
    for rec in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        rows.append(summarize(rec, n_chips))

    out = pathlib.Path(args.results) / f"roofline_{args.mesh}.json"
    out.write_text(json.dumps(rows, indent=1))

    print(f"\n## Roofline — {args.mesh} pod ({n_chips} H100s), per device per step\n")
    print("| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | dominant |"
          " MODEL/counted | roofline frac | args GiB | peak GiB |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        flag = " (over 80 GB)" if r["over_card"] else ""
        print(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.2f} "
            f"| {r['t_memory_s']*1e3:.2f} | {r['t_collective_s']*1e3:.2f} "
            f"| {r['dominant']} | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {r['argument_gib']:.2f} "
            f"| {r['peak_gib']:.2f}{flag} |"
        )
    print("\nbottleneck guidance:")
    for k, v in RECOMMEND.items():
        print(f"  - {k}: {v}")
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
