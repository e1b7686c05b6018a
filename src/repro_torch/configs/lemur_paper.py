"""The paper's own configuration (App. A): d'=2048, m'=8192, n=100k,
n'=16384, Adam(3e-3) 100 epochs, IVF+SQ8 ANNS, k=100, k'=1024.

Extra (beyond the 40 assigned cells): LEMUR serving / indexing dry-run cells
over the production mesh — the corpus dimensioned like MS MARCO (Table 1:
8.84M docs, ~67.5 tokens/doc, d=128 ColBERTv2).

Twin of ``repro/configs/lemur_paper.py``, value for value.
"""
from repro_torch.anns.params import IVFBackendConfig
from repro_torch.core.config import LemurConfig

CONFIG = LemurConfig(
    d=128,
    d_prime=2048,
    m_pretrain=8192,
    n_train=100_000,
    n_ols=16_384,
    lr=3e-3,
    epochs=100,
    batch_size=512,
    grad_clip=0.5,
    k=100,
    k_prime=1024,
    anns="ivf",
    ivf=IVFBackendConfig(nprobe=32, sq8=True),
)

FAMILY = "lemur"
# MS MARCO-scale serving corpus (Table 1)
SHAPES = {
    "serve_msmarco": dict(kind="lemur_serve", m=8_841_823, doc_tokens=80,
                          q_tokens=32, batch=256),
    "index_msmarco": dict(kind="lemur_index", m=8_841_823, doc_tokens=80),
}
SMOKE = CONFIG.replace(d=32, d_prime=128, m_pretrain=256, n_train=2048,
                       n_ols=512, epochs=3, k=10, k_prime=64)
