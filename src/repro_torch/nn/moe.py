"""Mixture-of-Experts (twin of ``repro/nn/moe.py``).

``moe_apply_dense`` computes every expert for every token and mixes them
with the gate: the single-device form the models run.  ``moe_apply`` is the
expert-parallel form on a ``DeviceMesh`` (axes ``("pod", "data",
"model")``), in the JAX twin's two layouts:

* ``ep``      - experts sharded over ("model", "data"); inside the body the
                weights are gathered over "data", so each "model" rank owns
                E/|model| experts.  Tokens are masked to the local experts,
                packed into an (E_loc, C, d) capacity buffer, computed, and
                summed over "model".
* ``ffslice`` - experts sharded over "data" with d_ff sharded over "model";
                after the "data" gather every rank holds all experts with a
                1/|model| slice of d_ff, and the partial outputs are summed
                over "model".

At or below ``token_gather_threshold`` tokens (decode shapes) the body
gathers the tokens instead of the weights: each rank computes its stored
expert shard and one sum over ("model", "data") combines them.

Dispatch is capacity-based packing (GShard-style dropping) from a cumsum
position-in-expert.  The top-k breaks ties toward the lower expert index,
as ``jax.lax.top_k``: the order of a token's k picks sets their cumsum
slots and so which pairs are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import collectives
from repro_torch.common.prng import PRNGSeq
from repro_torch.dist.sharding import batch_axes
from repro_torch.nn import layers


def init_moe(generator, n_experts, d_model, d_ff, *, gated=True, n_shared=0, shared_d_ff=None,
             dtype=torch.float32, device="cuda"):
    gs = PRNGSeq(generator, device).take(5)

    def w(g, shape, mode="fan_in"):
        return layers.variance_scaling(g, shape, mode=mode, dtype=dtype, device=device)

    p = {
        "router": w(gs[0], (d_model, n_experts)),
        "wo": w(gs[3], (n_experts, d_ff, d_model), mode="fan_out"),
    }
    if gated:
        p["wi_0"] = w(gs[1], (n_experts, d_model, d_ff))
        p["wi_1"] = w(gs[2], (n_experts, d_model, d_ff))
    else:
        p["wi"] = w(gs[1], (n_experts, d_model, d_ff))
    if n_shared:
        p["shared"] = layers.init_ffn(gs[4], d_model, (shared_d_ff or d_ff) * n_shared,
                                      gated=gated, dtype=dtype, device=device)
    return p


#: the JAX twin's ``moe_param_specs``: for each expert weight, the mesh axes
#: its dimensions are split over (None: whole), as PartitionSpec entries
def moe_param_specs(layout: str, *, stacked: bool = False) -> dict[str, tuple]:
    if layout == "ep":
        e3 = (("model", "data"), None, None)
    else:  # ffslice
        e3 = ("data", None, "model")
    wo = (("model", "data"), None, None) if layout == "ep" else ("data", "model", None)
    specs = {"router": (None, None), "wi_0": e3, "wi_1": e3, "wi": e3, "wo": wo}
    if stacked:
        specs = {k: (None, *v) for k, v in specs.items()}
    return specs


def moe_local_params(params: dict, layout: str, mesh) -> dict:
    """A rank's blocks of global MoE params: the expert weights cut by
    ``moe_param_specs(layout)``, the router and the shared expert whole."""
    from repro_torch.dist.sharding import local_block

    specs = moe_param_specs(layout)
    return {k: local_block(v, specs[k], mesh) if k in specs else v
            for k, v in params.items()}


def token_axes(mesh, n_tokens: int) -> tuple[tuple[str, ...], int]:
    """The batch axes the flattened tokens are split over and their count
    of shards: ("pod", "data") as present, or none when ``n_tokens`` does
    not divide (tiny decode batches: tokens replicated)."""
    axes = batch_axes(mesh)
    n = math.prod(collectives.axis_size(mesh, a) for a in axes)
    if n_tokens % max(n, 1):
        return (), 1
    return axes, n


def local_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's rows of the global (B, T, d) activations for ``moe_apply``:
    the flattened tokens cut over the batch axes (``token_axes``)."""
    from repro_torch.dist.sharding import local_block

    xf = x.reshape(-1, x.shape[-1])
    axes, _ = token_axes(mesh, xf.shape[0])
    return local_block(xf, (axes or None, None), mesh)


def _capacity(n_tokens: int, top_k: int, n_experts: int, factor: float, floor: int = 8):
    ideal = (n_tokens * top_k + n_experts - 1) // n_experts
    return int(min(max(floor, int(ideal * factor)), max(1, n_tokens * top_k)))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router_w, n_experts, top_k):
    """Router softmax, top-k, normalized gates, load-balance aux loss."""
    logits = (x @ router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eid = _top_k(probs, top_k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(eid, n_experts).float().sum(dim=1).mean(dim=0)
    return gate, eid, (me * ce).sum() * n_experts


def _pack_dispatch(x, eid, gate, n_local: int, capacity: int):
    """Pack the selected (token, expert) pairs into an (E_loc, C, d) buffer.

    x: (N, d); eid: (N, k) LOCAL expert ids (outside [0, n_local) means
    dropped); gate: (N, k).  Returns (buffer, eid_flat, pos_flat, keep, tok).
    Pairs are taken row-major over (N, k).  A dropped pair adds a zero row at
    slot (n_local - 1, C - 1), which a kept pair may also hold, so the
    writes accumulate.
    """
    N, k = eid.shape
    e_flat = eid.reshape(-1)
    valid = (e_flat >= 0) & (e_flat < n_local)
    e_safe = torch.where(valid, e_flat, n_local)              # park invalid in a trash row
    onehot = F.one_hot(e_safe, n_local + 1)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos_flat = pos.gather(1, e_safe[:, None])[:, 0]
    keep = valid & (pos_flat < capacity)
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    buf = torch.zeros((n_local, capacity, x.shape[-1]), dtype=x.dtype, device=x.device)
    rows = torch.where(keep[:, None], x[tok], torch.zeros((), dtype=x.dtype, device=x.device))
    buf = buf.index_put((torch.where(keep, e_flat, n_local - 1),
                         torch.where(keep, pos_flat, capacity - 1)), rows, accumulate=True)
    return buf, e_flat, pos_flat, keep, tok


def _expert_ffn(buf, wi_0, wi_1, wi, wo, activation):
    act = layers.ACTIVATIONS[activation]
    if wi_0 is not None:
        h = act(torch.bmm(buf, wi_0.to(buf.dtype))) * torch.bmm(buf, wi_1.to(buf.dtype))
    else:
        h = act(torch.bmm(buf, wi.to(buf.dtype)))
    return torch.bmm(h, wo.to(buf.dtype))


def _combine(x, out_buf, e_flat, pos_flat, keep, tok, gate):
    """Gather each kept (token, slot) row back, weight it by its gate, and
    add it to its token."""
    rows = out_buf[torch.where(keep, e_flat, 0), torch.where(keep, pos_flat, 0)]  # (N*k, d)
    g = (gate.reshape(-1) * keep).to(rows.dtype)
    return torch.zeros_like(x).index_add_(0, tok, rows * g[:, None])


def _moe_shard_body(x, router_w, wi_0, wi_1, wi, wo, *, mesh, layout, n_experts, top_k,
                    capacity_factor, activation, gathered=False):
    """One rank's part: the ZeRO weight gather over "data" (skipped when the
    caller ``gathered`` them), its tokens x (N_loc, d) through its experts,
    the sum over "model"."""
    if not gathered:
        gather = lambda a: None if a is None else collectives.all_gather(a, mesh, "data", 0)
        wi_0, wi_1, wi, wo = gather(wi_0), gather(wi_1), gather(wi), gather(wo)
    model_size = collectives.axis_size(mesh, "model")
    N = x.shape[0]
    gate, eid, aux = _route(x, router_w, n_experts, top_k)
    if layout == "ep":
        n_local = n_experts // model_size
        lo = collectives.axis_index(mesh, "model") * n_local
        local_eid = torch.where((eid >= lo) & (eid < lo + n_local), eid - lo, -1)
    else:  # all experts local (d_ff sliced)
        n_local = n_experts
        local_eid = eid
    # capacity from the GLOBAL expert count (expected tokens an expert: N*k/E)
    C = _capacity(N, top_k, n_experts, capacity_factor)
    buf, e_flat, pos_flat, keep, tok = _pack_dispatch(x, local_eid, gate, n_local, C)
    out_buf = _expert_ffn(buf, wi_0, wi_1, wi, wo, activation)
    y = collectives.psum(_combine(x, out_buf, e_flat, pos_flat, keep, tok, gate), mesh, "model")
    aux = collectives.psum(aux, mesh, "model") / model_size
    return y, aux


def _moe_tokengather_body(x, router_w, wi_0, wi_1, wi, wo, *, mesh, layout, n_experts,
                          top_k, capacity_factor, activation, batch_axes):
    """Decode-shape part: gather the TOKENS over the batch axes (never the
    weights), compute this rank's stored experts, sum over ("model",
    "data"), keep this rank's tokens."""
    n_local_tokens = x.shape[0]
    for ax in reversed(batch_axes):               # innermost first -> major-axis order
        x = collectives.all_gather(x, mesh, ax, 0)
    N = x.shape[0]
    gate, eid, aux = _route(x, router_w, n_experts, top_k)
    model_size = collectives.axis_size(mesh, "model")
    data_size = collectives.axis_size(mesh, "data")
    j = collectives.axis_index(mesh, "model")
    i = collectives.axis_index(mesh, "data")
    if layout == "ep":   # storage (("model","data"), ...) on E: shard s = j*data + i
        n_local = max(1, n_experts // (model_size * data_size))
        lo = (j * data_size + i) * n_local
    else:                # ffslice: storage ("data", None, "model"): data shard i owns E/data
        n_local = max(1, n_experts // data_size)
        lo = i * n_local
    local_eid = torch.where((eid >= lo) & (eid < lo + n_local), eid - lo, -1)
    C = _capacity(N, top_k, n_experts, capacity_factor)
    buf, e_flat, pos_flat, keep, tok = _pack_dispatch(x, local_eid, gate, n_local, C)
    out_buf = _expert_ffn(buf, wi_0, wi_1, wi, wo, activation)
    y = collectives.psum(_combine(x, out_buf, e_flat, pos_flat, keep, tok, gate), mesh,
                         ("model", "data"))
    idx = 0
    for ax in batch_axes:
        idx = idx * collectives.axis_size(mesh, ax) + collectives.axis_index(mesh, ax)
    y = y[idx * n_local_tokens:(idx + 1) * n_local_tokens]
    return y, collectives.psum(aux, mesh, "model") / model_size


def moe_apply(params, x, *, layout: str, n_experts: int, top_k: int, mesh, n_tokens: int,
              capacity_factor: float = 1.25, activation: str = "silu",
              token_gather_threshold: int = 4096, gathered: bool = False):
    """This rank's part of the expert-parallel MoE -> (y, aux_loss).

    ``params`` holds this rank's blocks of the expert weights, cut by
    ``moe_param_specs(layout)`` (``moe_local_params``), with the router and
    the shared expert whole; ``x`` (N_loc, d) holds its rows of the
    ``n_tokens`` flattened tokens, cut over ``token_axes`` (``local_tokens``).
    Returns the rank's rows of y and the aux loss.  At or below
    ``token_gather_threshold`` tokens it runs the token-gather body, above
    it the weight-gather body, as the JAX twin does.  With ``gathered`` the
    weight-gather body takes the expert weights already gathered over
    "data" (the LM's layers hold them in their own layout and gather them
    themselves).
    """
    batch_axes, n_shards = token_axes(mesh, n_tokens)
    if x.shape[0] * n_shards != n_tokens:
        raise ValueError(f"{x.shape[0]} local tokens are not 1/{n_shards} of {n_tokens}")
    args = (x, params["router"], params.get("wi_0"), params.get("wi_1"), params.get("wi"),
            params["wo"])
    kw = dict(mesh=mesh, layout=layout, n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, activation=activation)
    if n_tokens <= token_gather_threshold:
        y, aux = _moe_tokengather_body(*args, batch_axes=batch_axes, **kw)
    else:
        y, aux = _moe_shard_body(*args, gathered=gathered, **kw)
    if "shared" in params:
        y = y + layers.ffn(params["shared"], x, activation)
    return y, aux


def moe_apply_dense(params, x, *, n_experts: int, top_k: int, activation: str = "silu"):
    """Single-device MoE (no dropping): every expert for every token, mixed
    with the gate."""
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    gate, eid, aux = _route(xf, params["router"], n_experts, top_k)
    act = layers.ACTIVATIONS[activation]
    xe = xf.expand(n_experts, *xf.shape)                        # (E, N, d), a view
    if "wi_0" in params:
        h = act(torch.bmm(xe, params["wi_0"].to(xf.dtype)))
        h = h * torch.bmm(xe, params["wi_1"].to(xf.dtype))
    else:
        h = act(torch.bmm(xe, params["wi"].to(xf.dtype)))
    y_all = torch.bmm(h, params["wo"].to(xf.dtype))            # (E, N, d)
    mix = torch.zeros((xf.shape[0], n_experts), dtype=xf.dtype, device=xf.device)
    mix = mix.scatter_add(1, eid, gate.to(xf.dtype))           # (N, E)
    y = torch.einsum("ne,end->nd", mix, y_all).reshape(B, T, d)
    if "shared" in params:
        y = y + layers.ffn(params["shared"], x, activation)
    return y, aux
