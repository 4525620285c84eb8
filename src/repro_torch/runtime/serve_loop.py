"""Batched serving loop with capability-authenticated sessions (PyTorch
port of ``repro.runtime.serve_loop``).

Continuous-batching-lite: a fixed number of decode slots; arriving requests
(prompt token lists) are admitted into free slots, prefilled token-by-token
through the decode path (slot-local cache warmup), then decoded until EOS
or max_tokens.  Every request must present a capability issued by the
serving authority (the paper's protocol policy at the inference tier);
requests with invalid tickets are rejected without touching the model.

As in the reference, every slot of a step writes at one cache row,
``cur_len = slot_len.max()``, passed to the decode step as an int, so a
step never waits on the device for it.  A step's tokens go to the device
the params lie on, and its only device-to-host copy is the (slots,) int64
argmax of its logits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.auth import CapabilityAuthority, Rights
from repro_torch.models.layers import tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_tokens: int
    capability: Any = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False


class ServeLoop:
    def __init__(
        self,
        decode_step: Callable,          # (params, cache, batch) -> (logits, cache)
        params: Any,
        init_cache: Callable[[], Any],  # fresh cache for the slot batch
        batch_slots: int,
        authority: CapabilityAuthority,
        eos_id: int = 0,
    ):
        leaves = []
        tree_map(leaves.append, params)
        self.device = leaves[0].device
        self.decode_step = decode_step
        self.params = params
        self.cache = init_cache()
        self.slots: list[Request | None] = [None] * batch_slots
        self.slot_len = np.zeros(batch_slots, np.int32)
        self.authority = authority
        self.eos_id = eos_id
        self.completed: list[Request] = []
        self.steps = 0

    def _admit(self, queue: list[Request]) -> None:
        for i in range(len(self.slots)):
            if self.slots[i] is None and queue:
                req = queue.pop(0)
                if not self.authority.verify(
                    req.capability, now=int(time.time()), op_rights=Rights.READ
                ):
                    req.rejected = True
                    req.done = True
                    self.completed.append(req)
                    continue
                self.slots[i] = req
                self.slot_len[i] = 0

    def run(self, requests: list[Request], max_steps: int = 10_000) -> list[Request]:
        queue = list(requests)
        self._admit(queue)
        while (
            any(s is not None for s in self.slots) or queue
        ) and self.steps < max_steps:
            self._admit(queue)
            tokens = np.zeros((len(self.slots), 1), np.int64)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                pos = int(self.slot_len[i])
                if pos < len(req.prompt):
                    tokens[i, 0] = req.prompt[pos]       # prefill phase
                elif req.out:
                    tokens[i, 0] = req.out[-1]           # decode phase
                else:
                    tokens[i, 0] = req.prompt[-1]
            logits, self.cache = self.decode_step(
                self.params, self.cache,
                {"tokens": torch.from_numpy(tokens).to(self.device),
                 "cur_len": int(self.slot_len.max())},
            )
            next_tok = logits[:, 0, :].argmax(dim=-1).cpu().numpy()
            self.steps += 1
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                self.slot_len[i] += 1
                if self.slot_len[i] < len(req.prompt):
                    continue                              # still prefilling
                tok = int(next_tok[i])
                req.out.append(tok)
                if tok == self.eos_id or len(req.out) >= req.max_tokens:
                    req.done = True
                    self.completed.append(req)
                    self.slots[i] = None
                    self.slot_len[i] = 0
        return self.completed
