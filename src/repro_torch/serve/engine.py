"""Serving engine: prefill/decode steps + continuous batching.

The port of the JAX package's ``repro.serve.engine``.  ``ContinuousBatcher``
keeps the decode batch full: a finished sequence's slot is refilled by
running prefill for the next queued request at batch=1 and *inserting* the
resulting cache into the slot (per-sequence lengths make the insert exact).
Decode runs over every slot each step, as in the reference.  The decode
state lives on one device and is updated in place.

On a mesh (``mesh=``, ``rules=``: every rank of it runs the same batcher
on its shards of the params) the state is the rank's shard: its rows of
the batch over ``"data"``, its sequence shard of the cache over
``"model"``.  Every rank runs the same host loop and must take the same
admit and finish decisions: a prefill's first token and each step's next
tokens (the rank's rows, all-gathered over ``"data"``) are checked to
agree over the whole mesh, and a disagreement raises.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.factory import Model
from repro_torch.models.sharding import batch_rows


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab as int32; the first index wins a tie."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(model: Model, *, max_len: int, rules=None):
    def prefill_step(params, batch):
        logits, state = model.prefill(params, batch, max_len=max_len,
                                      rules=rules)
        return greedy_sample(logits), state
    return prefill_step


def make_decode_step(model: Model, *, mesh=None, rules=None):
    """(next tokens [B, 1], logits, state) of a decode step; on a mesh the
    rank's rows of the first two."""
    def decode_step(params, tokens, state):
        logits, state = model.decode(params, tokens, state, mesh=mesh,
                                     rules=rules)
        return greedy_sample(logits)[:, None], logits, state
    return decode_step


def agreed(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """``tokens`` (the same on every rank, or a fault) after checking that
    every rank of ``mesh`` holds the same: a max and a max of the negated
    over the whole mesh, which differ where any rank differs."""
    both = torch.stack([tokens, -tokens]).to(torch.int64)
    top = mesh.all_reduce_max(both)
    if not (torch.equal(top[0], tokens.to(torch.int64))
            and torch.equal(top[1], -tokens.to(torch.int64))):
        raise RuntimeError(f"rank {mesh.rank} of {mesh}: the ranks' tokens "
                           f"disagree ({tokens.flatten().tolist()} here)")
    return tokens


def insert_slot(state, pstate, slot: int):
    """Write a batch=1 prefill state into batch slot ``slot``, in place, and
    return ``state``.  Every leaf of the state's tree (a ``DecodeState``,
    whose absent parts are None, or an ``EncDecState``) has the batch on
    axis 1 (KVCache k/v ``[L,B,S,...]``, the ssm / lru leaves
    ``[L,B,...]``, encdec's cross k/v ``[L,B,F,...]``) but the lengths
    ``[B]``, which have it on axis 0."""
    for dst, src in zip(state, pstate):
        if dst is None:
            continue
        if isinstance(dst, tuple):
            insert_slot(dst, src, slot)
        elif dst.dim() == 1:
            dst[slot] = src[0]
        else:
            dst[:, slot].copy_(src[:, 0])
    return state


def _extra(value, device) -> torch.Tensor:
    """A request's extra (``[P, D]`` image embeddings, ``[F, D]`` frames) as
    a ``[1, ...]`` tensor on ``device``; float64 arrays become float32, as
    the reference's ``jnp.asarray`` makes them."""
    x = torch.as_tensor(np.asarray(value))
    if x.dtype == torch.float64:
        x = x.float()
    return x[None].to(device)


# ---------------------------------------------------------------------------
# continuous batching


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    extras: Optional[dict] = None  # vlm image_embeds / encdec frames
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class SlotInfo:
    rid: int = -1
    remaining: int = 0


class ContinuousBatcher:
    """Serves submitted requests ``batch_size`` at a time on ``device``
    (the card unless the caller asks for the CPU; ``params`` must already
    be there).  On a mesh (``mesh`` and ``rules``) ``params`` are the
    rank's shards (module docstring)."""

    def __init__(self, model: Model, params, batch_size: int, max_len: int,
                 *, device=None, mesh=None, rules=None, decode_fn=None,
                 prefill_fn=None):
        self.device = resolve_device(device)
        emb = params["embed"]["embedding"]
        if emb.device != self.device:
            raise ValueError(f"params are on {emb.device}, the batcher on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.B = batch_size
        self.max_len = max_len
        if mesh is not None and (rules is None or rules.mesh is not mesh):
            raise ValueError("a batcher on a mesh takes the rules its params "
                             "were sharded by (rules= over that mesh)")
        self.mesh, self.rules = mesh, rules
        self.state = model.decode_state_init(batch_size, max_len,
                                             device=self.device, rules=rules)
        # the global slots this rank's state rows hold
        self.rows = (slice(0, batch_size) if rules is None
                     else batch_rows(batch_size, rules))
        self.slots: List[SlotInfo] = [SlotInfo() for _ in range(batch_size)]
        self.queue: collections.deque = collections.deque()
        self.requests: Dict[int, Request] = {}
        self.tokens = np.zeros((batch_size, 1), np.int32)
        self._decode = decode_fn or make_decode_step(model, mesh=mesh,
                                                     rules=rules)
        self._prefill = prefill_fn or make_prefill_step(
            model, max_len=max_len, rules=rules)
        self.steps = 0
        self.tokens_out = 0

    def submit(self, req: Request):
        self.requests[req.rid] = req
        self.queue.append(req.rid)

    def _admit(self):
        for slot in range(self.B):
            if self.slots[slot].rid == -1 and self.queue:
                rid = self.queue.popleft()
                req = self.requests[rid]
                batch = {"tokens": torch.as_tensor(
                    np.asarray(req.prompt, np.int64)[None, :],
                    device=self.device)}
                for k, v in (req.extras or {}).items():
                    batch[k] = _extra(v, self.device)
                first, pstate = self._prefill(self.params, batch)
                if self.mesh is None:
                    self.state = insert_slot(self.state, pstate, slot)
                else:
                    first = agreed(first, self.mesh)
                    if self.rows.start <= slot < self.rows.stop:
                        self.state = insert_slot(self.state, pstate,
                                                 slot - self.rows.start)
                tok = int(first[0])
                req.generated.append(tok)
                self.tokens_out += 1
                self.tokens[slot, 0] = tok
                self.slots[slot] = SlotInfo(
                    rid=rid, remaining=req.max_new_tokens - 1)

    def step(self) -> bool:
        self._admit()
        if not any(s.rid != -1 for s in self.slots):
            return False
        nxt, logits, self.state = self._decode(
            self.params, torch.as_tensor(self.tokens.astype(np.int64),
                                         device=self.device), self.state)
        if self.mesh is not None:
            if self.rows.stop - self.rows.start < self.B:
                nxt = torch.cat(list(self.mesh.all_gather(nxt, "data")))
            nxt = agreed(nxt, self.mesh)
        nxt = nxt.cpu().numpy()
        self.steps += 1
        for slot, info in enumerate(self.slots):
            if info.rid == -1:
                continue
            req = self.requests[info.rid]
            tok = int(nxt[slot, 0])
            req.generated.append(tok)
            self.tokens_out += 1
            info.remaining -= 1
            if info.remaining <= 0 or (req.eos_id is not None
                                       and tok == req.eos_id):
                req.done = True
                self.slots[slot] = SlotInfo()
            else:
                self.tokens[slot, 0] = tok
        return True

    def run(self, max_steps: int = 10_000):
        while (any(s.rid != -1 for s in self.slots) or self.queue) \
                and self.steps < max_steps:
            if not self.step():
                break
        return {r.rid: r.generated for r in self.requests.values()}
