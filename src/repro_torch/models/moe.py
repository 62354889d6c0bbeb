"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``).

The expert bank keeps the JAX package's physical layout ``(tp, E_loc, d,
f_loc)`` (``MeshContext.expert_layout``), so parameters, plans and
checkpoints match leaf for leaf; on one device tp = 1 and the bank is
``(1, E, d, d_ff)``.  A mesh whose model axis holds more than one rank
waits for the tensor-parallel forward and raises "not yet ported".

Routing is the reference's sort-free static-shape bucketing: top-k on the
fp32 router logits, tokens ranked per expert by a slot-major cumsum
(slot 0 of every token before slot 1), ranks below the capacity C kept in
an ``(E, C + 1, d)`` buffer whose row C is the overflow row, the SwiGLU
experts as batched matmuls, and the kept outputs combined in fp32 with
their gates and rounded to the activation dtype.  Each kept row receives
exactly one token, so the buffer is gathered (a zero row stands for
every empty or overflow slot) rather than summed into.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import MeshContext, get_mesh_context
from repro_torch.models.common import dense_init
from repro_torch.models.config import MoEConfig


def moe_capacity(n_tokens_local: int, cfg: MoEConfig) -> int:
    c = math.ceil(n_tokens_local * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts)
    return max(8, c)


def init_moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig,
                    ctx: MeshContext | None = None, dtype=torch.bfloat16,
                    stack: tuple = ()) -> dict:
    """Router (fp32) and the expert bank in the physical (tp, E_loc, d,
    f_loc) layout, each leaf with the leading ``stack`` dims (the layer
    axis).  The bank is drawn one expert matrix at a time, so the fp32
    transient is one (d, f_loc) matrix, not the bank (maverick's is
    21.5 GB per leaf in fp32)."""
    ctx = ctx or get_mesh_context()
    _, e_loc, f_loc = ctx.expert_layout(cfg.n_experts, cfg.d_ff)
    lead = tuple(stack) + (ctx.tp, e_loc)

    def bank(m, n):
        w = torch.empty(lead + (m, n), dtype=dtype, device=gen.device)
        for mat in w.view(-1, m, n):
            mat.copy_(dense_init(gen, (m, n), dtype=dtype))
        return w

    p = {"router": dense_init(gen, tuple(stack) + (d_model, cfg.n_experts),
                              dtype=torch.float32),
         "wg": bank(d_model, f_loc), "wu": bank(d_model, f_loc),
         "wd": bank(f_loc, d_model)}
    if cfg.n_shared_experts:
        fs = cfg.shared_d_ff * cfg.n_shared_experts
        p["shared_wg"] = dense_init(gen, tuple(stack) + (d_model, fs),
                                    dtype=dtype)
        p["shared_wu"] = dense_init(gen, tuple(stack) + (d_model, fs),
                                    dtype=dtype)
        p["shared_wd"] = dense_init(gen, tuple(stack) + (fs, d_model),
                                    dtype=dtype)
    return p


def _top_k(logits: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order
    among ties)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(logits: torch.Tensor, cfg: MoEConfig):
    """Top-k routing -> (expert ids (N, k), gates (N, k) fp32, probs):
    gates a softmax over the k logits (mixtral), a sigmoid for k = 1
    (llama4)."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = _top_k(logits, cfg.top_k)
    gates = (torch.sigmoid(vals) if cfg.top_k == 1
             else torch.softmax(vals, dim=-1))
    return ids, gates, probs


def dispatch(ids: torch.Tensor, E: int, C: int):
    """Capacity slots of the N tokens' k assignments, slot-major
    (assignment q = j * N + t is token t's j-th choice): (row (k*N,) into
    the flattened (E * (C + 1)) buffer, keep (k*N,) bool).  A token's rank
    in its expert counts the assignments before it in that order; ranks
    C and up are dropped and point at the expert's overflow row C."""
    N, k = ids.shape
    e_q = ids.T.reshape(-1)                                  # (k*N,)
    sel = e_q[None, :] == torch.arange(E, device=ids.device)[:, None]
    rank_q = (torch.cumsum(sel, dim=1) - 1).gather(0, e_q[None, :])[0]
    keep = rank_q < C
    return e_q * (C + 1) + torch.where(keep, rank_q, C), keep


def moe_layer(x: torch.Tensor, params: dict, cfg: MoEConfig,
              ctx: MeshContext | None = None,
              serving: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN: x (B, S, d) -> (y (B, S, d), aux loss () fp32).

    The capacity comes from this rank's B * S tokens.  ``serving``
    selects the reference's decode layout (tokens replicated over the
    data axis, expert FFNs sharded over it); on one device both layouts
    compute the same function, so it only travels with the call.  The
    aux (load balance) and z losses read the same router logits as the
    routing: on one device the reference's second router product over
    the global view is that product."""
    del serving
    ctx = ctx or get_mesh_context()
    E, k = cfg.n_experts, cfg.top_k
    _, e_loc, _ = ctx.expert_layout(E, cfg.d_ff)
    B, S, d = x.shape
    N = B * S
    C = moe_capacity(N, cfg)
    xf = x.reshape(N, d)
    logits = xf.float() @ params["router"]                   # (N, E)
    ids, gates, probs = _route(logits, cfg)

    row, keep = dispatch(ids, e_loc, C)
    # the buffer as a gather: each kept row's one token, else the zero row
    src = torch.full((e_loc * (C + 1) + 1,), N, dtype=torch.long,
                     device=x.device)
    tok = torch.arange(k * N, device=x.device) % N
    src[torch.where(keep, row, e_loc * (C + 1))] = tok
    xz = torch.cat([xf, xf.new_zeros(1, d)])
    buf = xz[src[:-1]].view(e_loc, C + 1, d)
    wg, wu, wd = params["wg"][0], params["wu"][0], params["wd"][0]
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd).view(e_loc * (C + 1), d)
    y = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        q = slice(j * N, (j + 1) * N)
        got = torch.where(keep[q, None], out[row[q]], 0)
        y = y + got.float() * gates[:, j, None]
    y = y.to(x.dtype).view(B, S, d)

    load = F.one_hot(ids, E).float().mean(dim=(0, 1))
    importance = probs.mean(dim=0)
    aux = E * torch.sum(load * importance) * cfg.aux_loss_coef
    z_loss = 1e-3 * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    if "shared_wg" in params:
        hs = F.silu(x @ params["shared_wg"]) * (x @ params["shared_wu"])
        y = y + hs @ params["shared_wd"]
    return y, aux + z_loss
