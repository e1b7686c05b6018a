"""meshgraphnet [arXiv:2010.03409]: 15 layers, 128 hidden, sum aggregator,
2-layer MLPs.  Per-cell input dims follow the assigned datasets (Cora-like /
Reddit-like / ogbn-products-like / batched molecules).

Twin of ``repro/configs/meshgraphnet.py``, value for value.
"""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    mlp_layers=2,
    aggregator="sum",
)

FAMILY = "gnn"
SHAPES = {
    "full_graph_sm": dict(
        kind="full", n_nodes=2708, n_edges=10556,
        cfg=CONFIG.replace(d_node_in=1433, d_edge_in=4, d_out=7, task="classification"),
    ),
    "minibatch_lg": dict(
        kind="sampled", n_nodes=232965, n_edges=114615892, batch_nodes=1024,
        d_feat=602,
        cfg=CONFIG.replace(d_node_in=602, d_edge_in=4, d_out=41, task="classification",
                           fanout=(15, 10)),
    ),
    "ogb_products": dict(
        kind="full", n_nodes=2449029, n_edges=61859140,
        cfg=CONFIG.replace(d_node_in=100, d_edge_in=4, d_out=47, task="classification"),
    ),
    "molecule": dict(
        kind="batched", n_nodes=30 * 128, n_edges=64 * 128, n_graphs=128,
        cfg=CONFIG.replace(d_node_in=16, d_edge_in=4, d_out=1, task="regression",
                           graph_readout=True),
    ),
}
SMOKE = CONFIG.replace(n_layers=3, d_hidden=32, d_node_in=8, d_edge_in=4, d_out=2)
