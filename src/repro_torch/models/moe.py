"""Mixture-of-Experts FFN (phi3.5-moe: 16 experts, top-2; qwen3-moe: 128
experts, top-8).

The port of the JAX package's ``repro.models.moe``.  Dispatch is the
reference's expert-centric consolidation: each sequence's (token, choice)
entries are sorted stably by expert, ranked within their expert, and packed
into that expert's buffer of C rows (``moe_capacity``); an entry ranked C or
later is dropped to the residual stream through a trash row whose output is
zero (Switch semantics).  The expert products are ``torch.bmm`` over
``[E, rows, D]``, as the reference leaves its einsums to XLA.

Where the obvious torch call would not give the reference's answer:

* top-k: ``torch.topk`` promises no order among ties, and in bf16 the
  router's K-th and (K+1)-th logits do tie.  ``top_k`` takes the first K of
  a stable descending sort, so a tie goes to the lower expert, as
  ``jax.lax.top_k``.
* Capacity is per sequence: the reference vmaps its routing over the batch,
  so ``route`` ranks every batch row on its own and each row has its own C
  rows of each expert.  The rows' products are batched all the same: the
  buffer is laid out ``[E, B, C]``, so one ``bmm`` per weight reads each
  expert's weights once for the whole batch (a decode step reads every
  expert once, not once a row).
* The combine: the reference scatter-adds a token's K contributions in
  expert order (``.at[tok].add`` over the expert-sorted entries), rounding
  in the compute dtype after each add.  ``index_add_`` on CUDA adds in no
  fixed order; ``apply_moe`` sums the K contributions in ascending expert
  id, K - 1 plain adds, the same on both devices.  A dropped entry adds 0.

On a mesh (``rules``, a rank's blocks of the weights with their FSDP split
of ``"expert_embed"`` gathered by the caller) the experts run expert
parallel over ``"model"``.  The reference declares ``"experts": "model"``
and leaves the partitioning of this function to GSPMD; the port writes it
out.  The tensor-parallel blocks leave the layer's input replicated over
``"model"`` (``models/manual_tp.py``), so every rank already holds every
token of its rows and no all-to-all is needed:

1. the router is gathered whole (``"embed"`` and ``"experts"``) and every
   token routed with the one-card code, so every model rank picks the same
   experts and drops the same entries;
2. the rank keeps its contiguous block of experts (``sharding.local_block``)
   and packs only their entries into an ``[E_loc, B, C]`` buffer (the
   others go to the trash row);
3. it sums its contributions in ascending expert id in float32, and one
   float32 ``all_reduce_sum`` over ``"model"`` adds the ranks' sums, as
   ``manual_tp.manual_mlp`` does.

Experts that the model axis does not split (the spec guard leaves them
whole, e.g. 4 experts at a model axis of 3, or a model axis of 1) are
computed whole on every rank with the one-card code, with no sum.  Under
autograd the packed rows and the gate values that weight the rank's
contributions sum their gradients over ``"model"`` (each rank's covers
only its experts' entries); the router's input keeps the identity, its
computation being repeated on every rank.  The aux loss is the global
batch's: its statistics (the picks and the probabilities summed, and the
row count) are summed over the batch axes before the product.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _act, _normal
from repro_torch.models.sharding import batch_axes, gather_dims, local_block


def moe_axes(gated=True) -> dict:
    a = {"router": ("embed", "experts"),
         "wi": ("experts", "expert_embed", "expert_mlp"),
         "wo": ("experts", "expert_mlp", "expert_embed")}
    if gated:
        a["wg"] = ("experts", "expert_embed", "expert_mlp")
    return a


def init_moe(gen, d, cfg: MoEConfig, dtype, gated=True, act="silu",
             device=None) -> dict:
    """``router [D, E]``, ``wi``/``wg [E, D, F]``, ``wo [E, F, D]`` with the
    reference's scales (``act`` is unused, as there)."""
    E, F_ = cfg.num_experts, cfg.expert_d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(F_)
    p = {"router": _normal(gen, (d, E), dtype, s_in, device),
         "wi": _normal(gen, (E, d, F_), dtype, s_in, device),
         "wo": _normal(gen, (E, F_, d), dtype, s_out, device)}
    if gated:
        p["wg"] = _normal(gen, (E, d, F_), dtype, s_in, device)
    return p


def moe_capacity(S: int, cfg: MoEConfig) -> int:
    """Rows of each expert's buffer for a sequence of S tokens: the
    reference's ``ceil(S * top_k / num_experts * capacity_factor)`` (the
    same float64 expression in the same order), at least 1."""
    return max(1, math.ceil(S * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor))


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest values of ``probs`` along the last axis and their
    indices, descending, a tie to the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(gate_idx: torch.Tensor, C: int, E: int) -> torch.Tensor:
    """The consolidation of each batch row on its own.  gate_idx: ``[B, S,
    K]`` expert ids.  Returns ``slot [B, S, K]`` (int64): the row
    ``e * C + rank`` of the sequence's ``[E * C]`` expert buffer each
    entry fills, where ``rank`` counts the sequence's earlier entries of
    expert ``e`` in (token, choice) order; ``E * C`` (the trash row) for an
    entry ranked C or later, which is dropped."""
    B, S, K = gate_idx.shape
    dev = gate_idx.device
    eid = gate_idx.reshape(B, S * K)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = torch.gather(eid, 1, order)
    start = torch.searchsorted(
        eid_s, torch.arange(E, device=dev).expand(B, E).contiguous())
    pos = torch.arange(S * K, device=dev) - torch.gather(start, 1, eid_s)
    slot_s = torch.where(pos < C, eid_s * C + pos, E * C)
    return torch.empty_like(slot_s).scatter_(1, order, slot_s).view(B, S, K)


def _gates(router, x, K):
    """(probs ``[B,S,E]`` float32, gate values and expert ids ``[B,S,K]``):
    router logits in x's dtype, their softmax in float32, the gates
    renormalised over the top K."""
    logits = torch.matmul(x, router.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)                # [B,S,E]
    gate_vals, gate_idx = top_k(probs, K)                        # [B,S,K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _contributions(p, x, gate_vals, gate_idx, slot, C, act, e0=0):
    """Each token's K entries weighted by their gates, ``[B,S,K,D]`` in x's
    dtype, in ascending expert id: the experts ``e0 ..`` whose weights ``p``
    holds (``wi [E_loc, D, F]``), an entry of any other expert and a
    dropped one 0."""
    B, S, D = x.shape
    E_loc = p["wi"].shape[0]
    dev = x.device
    # the buffer's rows in [E_loc, B, C] order, then one trash row (n)
    n = E_loc * B * C
    b = torch.arange(B, device=dev).view(B, 1, 1)
    e = slot // C - e0               # the trash slot E * C falls outside
    dst = torch.where((e >= 0) & (e < E_loc),
                      (e * B + b) * C + slot % C, n)             # [B,S,K]
    src = torch.full((n + 1,), B * S, dtype=torch.long, device=dev)
    tok = torch.arange(B * S, device=dev).view(B, S, 1).expand_as(gate_idx)
    src.scatter_(0, dst.reshape(-1), tok.reshape(-1))  # trash: any token
    xz = torch.cat([x.reshape(B * S, D), x.new_zeros(1, D)])     # + zero row
    xe = xz[src[:n]].view(E_loc, B * C, D)
    h = _act(torch.bmm(xe, p["wi"].to(x.dtype)), act)
    if "wg" in p:
        h = h * torch.bmm(xe, p["wg"].to(x.dtype))
    # serving writes the product into the buffer; ``out=`` has no
    # gradient, so training concatenates (one more copy, the same values),
    # as ssm.linear_scan does
    if torch.is_grad_enabled() and h.requires_grad:
        ye = torch.cat([torch.bmm(h, p["wo"].to(x.dtype)).view(n, D),
                        x.new_zeros(1, D)])                      # trash = 0
    else:
        ye = x.new_empty((n + 1, D))
        ye[n] = 0                                                # trash = 0
        torch.bmm(h, p["wo"].to(x.dtype), out=ye[:n].view(E_loc, B * C, D))
    asc = torch.argsort(gate_idx, dim=-1)
    return ye[torch.gather(dst, -1, asc)] * torch.gather(
        gate_vals, -1, asc).to(x.dtype)[..., None]               # [B,S,K,D]


def _combine(contrib: torch.Tensor) -> torch.Tensor:
    """``contrib [B,S,K,D]`` summed over K in order, K - 1 plain adds in
    its dtype."""
    y = contrib[:, :, 0]
    for j in range(1, contrib.shape[2]):
        y = y + contrib[:, :, j]
    return y


def apply_moe(p, x: torch.Tensor, cfg: MoEConfig, act: str = "silu",
              rules=None, aux: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: ``[B, S, D]`` -> (y ``[B, S, D]`` in x's dtype, the Switch
    load-balance aux loss, a float32 scalar).  Router logits in x's dtype,
    their softmax in float32; the gates renormalised over the top K.

    With ``rules``: the rank's weights, expert parallel over ``"model"``
    (module docstring); the aux loss is the global batch's, or None
    without ``aux`` (serving, which never reads it, makes no collective
    for it)."""
    if rules is not None:
        return _apply_sharded(p, x, cfg, act, rules, aux)
    S = x.shape[1]
    E, K = cfg.num_experts, cfg.top_k
    C = moe_capacity(S, cfg)
    probs, gate_vals, gate_idx = _gates(p["router"], x, K)
    slot = route(gate_idx, C, E)

    # each token's K contributions in ascending expert id
    y = _combine(_contributions(p, x, gate_vals, gate_idx, slot, C, act))

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    frac = F.one_hot(gate_idx, E).float().sum(2).mean((0, 1)) / K
    aux = E * torch.sum(frac * probs.mean((0, 1)))
    return y, aux


def pick_counts(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """How many entries of ``gate_idx`` pick each of the ``E`` experts,
    int64 ``[E]``: ``torch.bincount(gate_idx.reshape(-1), minlength=E)``'s
    integers, as a sum of ones into a tensor of static shape (bincount's
    shape depends on the data, which a step on fake tensors cannot
    trace)."""
    idx = gate_idx.reshape(-1).long()
    return torch.zeros(E, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _apply_sharded(p, x, cfg: MoEConfig, act, rules, want_aux):
    """:func:`apply_moe` on a mesh (module docstring)."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    mesh = rules.mesh
    router = gather_dims(p["router"], moe_axes("wg" in p)["router"], rules,
                         {"experts": E})
    C = moe_capacity(S, cfg)
    probs, gate_vals, gate_idx = _gates(router, x, K)
    slot = route(gate_idx, C, E)
    E_loc = p["wi"].shape[0]
    if E_loc == E:
        # experts whole on every rank: the one-card code, no sum
        y = _combine(_contributions(p, x, gate_vals, gate_idx, slot, C,
                                    act))
    else:
        e0, n = local_block("experts", E, rules)
        if n != E_loc:
            raise ValueError(f"a rank's {E_loc} experts are not its block "
                             f"of {n} by the rules")
        contrib = _contributions(
            p, mesh.sum_grad(x, "model"), mesh.sum_grad(gate_vals, "model"),
            gate_idx, slot, C, act, e0)
        y = mesh.all_reduce_sum(_combine(contrib.float()), "model").to(
            x.dtype)
    if not want_aux:
        return y, None
    # the aux loss of the global batch: its statistics summed over the
    # batch axes (the sum's gradient passes through: each rank's rows)
    stats = torch.cat([pick_counts(gate_idx, E).float(),
                       probs.sum((0, 1)), probs.new_full((1,), B * S)])
    for ax in batch_axes(rules):
        if mesh.shape[ax] > 1:
            stats = mesh.all_reduce_sum(stats, ax)
    rows = stats[2 * E]
    frac = stats[:E] / (rows * K)
    aux = E * torch.sum(frac * (stats[E:2 * E] / rows))
    return y, aux
