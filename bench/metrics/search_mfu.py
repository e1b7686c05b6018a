"""The whole search step's share of the card's peak, in %: the operations a
batch needs (first stage and rerank, ``counts``, mean over the sampled
batches) times the batches the traced window completed, over the window's
seconds and the TF32 tensor-core peak (the highest rate for 32-bit
operands, so it cannot pass 100).  Layer: search step; moves qps."""


def read(ctx):
    sample, w = ctx["sample"], ctx["window"]
    if not sample:
        return None
    ops = sum(b["first_stage"][1] + b["rerank"][1] for b in sample) / len(sample)
    return 100.0 * ops * w["batches"] / w["window_s"] / ctx["peaks"].TF32_FLOPS_S
