"""The inputs of a run, made from ``--seed`` on the run's device.

Both sides are handed the same inputs: the program's set-up (``system.py``)
and the reference (``reference.py``) read them from here, and neither reads
what the other made from them.  Every draw comes from a generator seeded by
:func:`mix` of the run's seed and a tag, so a chunk of docs or a batch of
queries can be made again, alone, and equal bit for bit.

Frozen copies, rewritten for the seed scheme and the compressed tier:

* :meth:`Corpus.chunk` is ``chip_smoke.build_corpus``'s fill: MS MARCO-shaped
  docs (token counts Poisson(67.5) clipped to [4, 80], Table 1), each token
  ``normalize(noise + 1.2 * centre)`` of one of its doc's 2 topic centres out
  of 4,096 (``data/synthetic.make_corpus``'s weight), and the doc's latent row
  ``W = psi(normalize(sum of its tokens))``;
* :meth:`Corpus.queries` is ``chip_smoke.make_queries``: a source doc's
  tokens at random positions plus noise 0.25, unit-normalised, 1 query in 8
  shorter (8 to Tq - 1 valid tokens).  The source docs are a pool drawn at
  set-up (``source_docs`` of the traffic), kept on the device;
* :meth:`Corpus.codec_sample` is ``chip_smoke.train_codec``'s sample, drawn
  from the first chunk of docs (the docs are drawn alike, one by one).
"""
from __future__ import annotations

import contextlib
import hashlib

import torch
import torch.nn.functional as F


def mix(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@contextlib.contextmanager
def matmul_fp32():
    """fp32 products on the card: TF32 off for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def psi_plain(x, kernel, bias, ln_scale, ln_bias, eps: float = 1e-5, mm=None):
    """psi(x) = LN(GELU_tanh(x @ kernel + bias)), LayerNorm in fp32 (the
    paper's eq. 4; a frozen copy of ``repro_torch/kernels/ref.fused_psi_ref``).
    ``mm`` replaces the product (the control's lower precision)."""
    h = (x @ kernel if mm is None else mm(x, kernel)) + bias
    h = F.gelu(h, approximate="tanh").float()
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()


class Corpus:
    """The corpus, psi's weights, the query pool and the deletions of one
    run.  ``cfg`` is a configuration file's dict, ``pool_docs`` the
    traffic's ``source_docs``."""

    def __init__(self, cfg: dict, seed: int, device, pool_docs: int):
        self.cfg, self.seed = cfg, int(seed)
        self.dev = torch.device(device)
        dev = self.dev
        self.m, self.d, self.dp = int(cfg["m"]), int(cfg["d"]), int(cfg["d_prime"])
        self.T = int(cfg["doc_tokens_max"])
        self.chunk_docs = int(cfg["doc_chunk"])
        if self.m % self.chunk_docs:
            raise ValueError("m must be a whole number of doc chunks")
        self.n_chunks = self.m // self.chunk_docs
        d, dp = self.d, self.dp
        g = self.generator("psi")
        kernel = torch.empty((d, dp), device=dev)
        std = d ** -0.5
        torch.nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=g)
        self.psi = (kernel, torch.zeros(dp, device=dev), torch.ones(dp, device=dev),
                    torch.zeros(dp, device=dev))
        g = self.generator("centres")
        self.centers = F.normalize(
            torch.randn(int(cfg["topic_centers"]), d, generator=g, device=dev), dim=1)
        g = self.generator("counts")
        rate = torch.full((self.m,), float(cfg["doc_tokens_mean"]), device=dev)
        self.counts = torch.poisson(rate, generator=g).clamp_(
            int(cfg["doc_tokens_min"]), self.T).long()
        # the query pool: source docs drawn once, their tokens kept on the
        # device as the chunks pass (fill_pool)
        g = self.generator("pool")
        self.pool_ids = torch.randperm(self.m, generator=g, device=dev)[:pool_docs].sort().values
        self.pool_cnt = self.counts[self.pool_ids]
        self.pool_tok = torch.zeros((len(self.pool_ids), self.T, d), device=dev)
        # 0.1 % of the docs deleted at set-up: half of them query sources,
        # so that queries meet their own doc tombstoned
        n_dead = max(2, round(float(cfg["delete_share"]) * self.m))
        g = self.generator("dead")
        src = self.pool_ids[torch.randperm(len(self.pool_ids), generator=g,
                                           device=dev)[:n_dead // 2]]
        rest = torch.randperm(self.m, generator=g, device=dev)[:n_dead]
        rest = rest[~torch.isin(rest, src)][:n_dead - len(src)]
        self.dead = torch.cat([src, rest]).sort().values
        self.alive = torch.ones(self.m, dtype=torch.bool, device=dev)
        self.alive[self.dead] = False

    def generator(self, *tags) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(mix(self.seed, *tags))

    # -- docs ---------------------------------------------------------------

    def chunk(self, c: int):
        """Docs ``[c * doc_chunk, (c + 1) * doc_chunk)`` -> (tokens (n, T, d)
        zero past each doc's count, mask (n, T), W (n, d')).  ``W`` is psi of
        the normalised token sum, in fp32."""
        s, n, T, d = c * self.chunk_docs, self.chunk_docs, self.T, self.d
        dev = self.dev
        g = self.generator("chunk", c)
        cnt = self.counts[s:s + n]
        topics = torch.randint(0, self.centers.shape[0], (n, 2), generator=g, device=dev)
        which = torch.randint(0, 2, (n, T), generator=g, device=dev)
        tok = torch.randn(n, T, d, generator=g, device=dev)
        tok += float(self.cfg["topic_strength"]) * self.centers[topics.gather(1, which)]
        tok = F.normalize(tok, dim=-1)
        mask = torch.arange(T, device=dev)[None, :] < cnt[:, None]
        tok *= mask[..., None]
        with matmul_fp32():
            W = psi_plain(F.normalize(tok.sum(1), dim=-1), *self.psi)
        return tok, mask, W

    def fill_pool(self, c: int, tok: torch.Tensor) -> None:
        """Copy the pool's docs of chunk ``c`` (its tokens ``tok``)."""
        s = c * self.chunk_docs
        lo, hi = torch.searchsorted(self.pool_ids, torch.tensor(
            [s, s + self.chunk_docs], device=self.dev)).tolist()
        if hi > lo:
            self.pool_tok[lo:hi] = tok[self.pool_ids[lo:hi] - s]

    def codec_sample(self, tok: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` valid tokens of the first chunk, drawn without replacement:
        the compressed tier's training sample."""
        flat = tok[mask]
        g = self.generator("codec_sample")
        return flat[torch.randperm(flat.shape[0], generator=g, device=self.dev)[:n]].contiguous()

    # -- queries ------------------------------------------------------------

    def queries(self, i: int, traffic: dict, g: torch.Generator):
        """Batch ``i`` of the traffic -> (tokens (B, Tq, d), mask (B, Tq)),
        drawn on the device by ``g`` reseeded for the batch."""
        B, Tq = int(traffic["batch"]), int(traffic["q_tokens"])
        dev = self.dev
        g.manual_seed(mix(self.seed, "queries", i))
        src = torch.randint(0, len(self.pool_ids), (B,), generator=g, device=dev)
        nt = self.pool_cnt[src]
        pos = (torch.rand(B, Tq, generator=g, device=dev) * nt[:, None]).long()
        tok = self.pool_tok[src[:, None], pos]
        tok += float(traffic["noise"]) * torch.randn(tok.shape, generator=g, device=dev)
        tok = F.normalize(tok, dim=-1).contiguous()
        short = torch.rand(B, generator=g, device=dev) < float(traffic["short_share"])
        qlen = torch.where(short, torch.randint(int(traffic["short_min"]), Tq, (B,),
                                                generator=g, device=dev), Tq)
        mask = torch.arange(Tq, device=dev)[None, :] < qlen[:, None]
        return tok, mask.contiguous()
