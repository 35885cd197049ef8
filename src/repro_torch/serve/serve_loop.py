"""Serving loop: batched prefill + greedy decode with Vilamb-protected caches.

The port of ``repro.serve.serve_loop``.  In serving, the parameters are
immutable; the KV cache is the hot, sparsely written state: each decode
step dirties one page per layer, the closest analogue of the paper's
cache-line writes to DAX pages.  Recurrent-state caches (Mamba's ``h``
and ``conv``, xLSTM's ``C``, ``n`` and ``c``) are rewritten whole every
step and marked ALL-dirty.  A :class:`~repro_torch.core.ProtectedStore`
owns the redundancy lifecycle: ``decode_step`` records writes through
``store.on_write`` and the generate loop heartbeats ``store.tick``, the
same scheduling the reference uses.  The whole path runs under
``torch.inference_mode()``.

The caches are written in place, where the reference's arrays are
immutable.  On the card a due tick's update reads the leaves on the
store's side stream, so each decode step first orders the current stream
after the in-flight update (``store.await_inflight``, a device-side wait):
otherwise the step's writes could reach blocks the update is still
reading, and its adopted checksums would mix two steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..common import flatten_dict, unflatten_dict
from ..core.store import ProtectedStore


def make_prefill(model, max_len: int) -> Callable:
    def prefill(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill


def make_decode_step(model, store: Optional[ProtectedStore] = None) -> Callable:
    """decode_step(params, caches, red, token, pos) -> (logits, caches, red, next).

    The caches are written in place, after any in-flight update has read
    them (on the device).  A ``sync`` group's inline diff needs the old and
    the new caches, so the leaves are copied before the step only when the
    store has one.
    """
    def decode_step(params, caches, red, token, pos):
        protects = store is not None and store.protects
        old = None
        if protects:
            store.await_inflight()
        if protects and store.has_sync:
            old = {n: t.clone() for n, t in flatten_dict(caches).items()}
        logits, caches, next_token = model.decode_step(params, caches, token, pos)
        if protects:
            red = store.on_write(
                red, events=model.dirty_events_decode(caches, pos), old=old,
                new=flatten_dict(caches) if old is not None else None)
        return logits, caches, red, next_token

    return decode_step


@dataclasses.dataclass
class Server:
    model: Any
    store: Optional[ProtectedStore] = None
    max_len: int = 2048

    def __post_init__(self):
        if self.store is not None and not self.store.protects:
            self.store = None
        self.prefill = make_prefill(self.model, self.max_len)
        self.decode = make_decode_step(self.model, self.store)

    def init_redundancy(self, caches):
        if self.store is None:
            return {}
        return self.store.init(flatten_dict(caches))

    def read_verified(self, caches, red, name: str, blocks):
        """Degraded-mode read of cache blocks: not ported yet (the remesh
        item of ROADMAP.md)."""
        raise NotImplementedError(
            "Server.read_verified needs the store's degraded reads, which are "
            "not ported yet: ROADMAP.md, Queue 1 item 11.5 (remesh and "
            "read_verified)")

    def generate(self, params, batch, n_tokens: int,
                 scrub_every: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill then decode ``n_tokens`` greedily; returns ``(tokens,
        stats)``, tokens (B, n_tokens) int32.

        The store's tick owns the update and scrub cadence; ``scrub_every``
        overrides the policy's scrub period for this call (``None`` defers
        to the policy, ``0`` disables scrubbing).  Decode intervals feed the
        straggler governor.  With the store's health governor on,
        ``stats["health"]`` is the last tick's report and
        ``stats["health_actions"]`` counts the ladder's actions over the
        call; the scrub patroller's repairs are adopted as they land.
        """
        with torch.inference_mode():
            logits, caches, pos = self.prefill(params, batch)
            red = self.init_redundancy(caches)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            out = [token]
            mismatches = 0
            health, health_actions = None, 0
            last = time.perf_counter()
            for t in range(n_tokens - 1):
                logits, caches, red, token = self.decode(params, caches, red, token,
                                                         pos + t)
                out.append(token)
                if self.store is not None:
                    c = caches
                    red, report = self.store.tick(
                        lambda: flatten_dict(c), red, t + 1,
                        step_time=time.perf_counter() - last,
                        scrub_period=scrub_every)
                    mismatches += report.mismatches
                    if report.health is not None:
                        health = report.health
                        health_actions += len(report.health.actions)
                    if report.repaired:
                        # The patroller repaired cache leaves (in place, or
                        # into a new tensor where the lane view is a padded
                        # copy): decode continues on the repaired pages.
                        caches = self._adopt(caches, report.repaired)
                    last = time.perf_counter()
            if self.store is not None:
                # The last decode tick ran at step n_tokens - 1.
                red = self.store.settle(red, flatten_dict(caches), step=n_tokens - 1)
                caches = self._adopt(caches, self.store.take_repaired())
            return torch.stack(out, dim=1), {
                "mismatches": mismatches, "red": red, "caches": caches,
                "pos": pos + n_tokens - 1, "remesh": None, "health": health,
                "health_actions": health_actions}

    @staticmethod
    def _adopt(caches, repaired):
        if not repaired:
            return caches
        flat = flatten_dict(caches)
        flat.update(repaired)
        return unflatten_dict(flat)
