"""Train-step factory and the host Trainer, both driven by a ProtectedStore.

The port of ``repro.train.train_loop``.  The redundancy lifecycle (dirty
marking or the sync diff per leaf group, Algorithm-1 scheduling, the
scrub double-check, straggler back-off, the preemption flush) lives
behind :class:`~repro_torch.core.ProtectedStore`; this module wires the
model and optimizer step into it.  Three rules keep autograd and the
store apart:

- the step's forward, backward and optimizer run under
  ``torch.use_deterministic_algorithms(True)`` (on the card that needs
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before cuBLAS
  first runs), so a run with a store and one without give the same
  losses bit for bit;
- gradients are taken with respect to detached aliases of the params, so
  the store's leaves never require grad and its calls (``on_write``,
  ``tick``, ``recover_block``) never enter a graph;
- AdamW writes params and moments in place after the backward, and
  ``Trainer.run`` waits for the loss only (``loss.item()``, the current
  stream): the store's side stream, where a due update reads the leaves,
  runs on under the next step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..common import flatten_dict, replace_leaves
from ..core.state import empty_leaf_red
from ..core.store import ProtectedStore
from ..optim.adamw import AdamW
from .state import TrainState, protected_leaves, replace_protected


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block, restored after.  Memory that
    an op leaves uninitialised is not filled: the step reads none, and the
    fill would write every such buffer once more."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]


def loss_and_grads(model, params, batch):
    """``(loss, aux, grads)``: the loss and aux detached, grads by flat
    param path, taken through detached aliases of the params (which share
    their memory and never require grad themselves).  A leaf the loss does
    not read (the sLSTM's ``wk`` and ``wv``) gets zeros, as under
    ``jax.grad``."""
    alias = {n: p.detach().requires_grad_() for n, p in flatten_dict(params).items()}
    loss, aux = model.loss(replace_leaves(params, alias), batch)
    grads = torch.autograd.grad(loss, list(alias.values()), materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, dict(zip(alias, grads))


def make_train_step(model, opt: AdamW, store: Optional[ProtectedStore] = None,
                    accum_steps: int = 1) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; params and moments
    are updated in place and ``state.step`` advances.

    ``accum_steps > 1`` splits the batch into that many microbatches and
    accumulates their gradients in fp32.  Vilamb groups get the dirty
    events (``model.dirty_events_train`` expanded by
    ``store.expand_events``); a ``sync`` group's inline diff needs its
    leaves from before the update, so only those are copied.
    """
    protects = store is not None and store.protects

    def grads_of(params, batch):
        if accum_steps == 1:
            return loss_and_grads(model, params, batch)
        B = batch["tokens"].shape[0]
        b = B // accum_steps
        gacc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in flatten_dict(params).items()}
        loss_sum = None
        for i in range(accum_steps):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            loss, aux, g = loss_and_grads(model, params, mb)
            for n, t in g.items():
                gacc[n].add_(t)
            if loss_sum is None:
                loss_sum, aux_sum = loss, dict(aux)
            else:
                loss_sum = loss_sum + loss
                aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
        n = float(accum_steps)
        aux = {k: v if k == "expert_counts" else v / n for k, v in aux_sum.items()}
        return loss_sum / n, aux, {k: g.div_(n) for k, g in gacc.items()}

    def train_step(state: TrainState, batch):
        with deterministic():
            loss, aux, grads = grads_of(state.params, batch)
            sparse_events = model.dirty_events_train(batch, aux)
            row_masks = {k: v for k, v in sparse_events.items() if not isinstance(v, str)}
            old = None
            if protects and store.has_sync:
                old = {n: t.clone() for n, t in
                       protected_leaves(state.params, state.opt).items()
                       if store.leaf_policy(n).mode == "sync"}
            gnorm = opt.update(grads, state.opt, state.params, row_masks)
        red = state.red
        if protects:
            red = store.on_write(
                red, events=store.expand_events(sparse_events), old=old,
                new=protected_leaves(state.params, state.opt) if old is not None else None)
        metrics = {"loss": loss, "ce": aux["ce"], "grad_norm": gnorm,
                   "aux_loss": aux["aux_loss"]}
        return dataclasses.replace(state, red=red, step=state.step + 1), metrics

    return train_step


def make_redundancy_step(store) -> Callable:
    """Algorithm 1 over the protected state (the paper's background
    thread), outside the tick's schedule."""
    def redundancy_step(state: TrainState) -> TrainState:
        red = store.redundancy_step(protected_leaves(state.params, state.opt),
                                    state.red)
        return dataclasses.replace(state, red=red)
    return redundancy_step


@dataclasses.dataclass
class Trainer:
    """Host loop around ``store.tick``: periodic redundancy, scrubbing with
    the double-check, the preemption flush, straggler back-off, all owned
    by the store.  Runs where the model does (the card unless the model
    was built with ``device="cpu"``); a store must be on the same device.
    The reference's deprecated ``engine=``/``mode=`` shim and its
    ``donate`` flag (a jit option) are not ported."""
    model: Any
    opt: AdamW
    store: Optional[ProtectedStore] = None
    # None defers to the store's per-leaf policy; 0 disables scrubbing.
    scrub_period_steps: Optional[int] = None

    def __post_init__(self):
        if self.store is not None and not self.store.protects:
            self.store = None
        if self.store is not None and self.store.device != self.model.device:
            raise ValueError(f"the store is on {self.store.device}, the model on "
                             f"{self.model.device}")
        self.train_step = make_train_step(self.model, self.opt, self.store)
        self.redundancy_step = (make_redundancy_step(self.store)
                                if self.store is not None else None)
        self.step_times: list = []

    def scrub_fn(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Per-leaf mismatch masks of the protected state (no double-check)."""
        return self.store.scrub(protected_leaves(state.params, state.opt), state.red)

    @property
    def corruption_alarms(self) -> int:
        return self.store.corruption_alarms if self.store is not None else 0

    def init_state(self, gen: Optional[torch.Generator] = None) -> TrainState:
        """Random params from ``gen`` (a generator on the model's device),
        zero moments, and the store's full redundancy over both."""
        params = self.model.init(gen)
        opt_state = self.opt.init(params)
        red = {}
        if self.store is not None:
            red = self.store.init(protected_leaves(params, opt_state))
        return TrainState.create(params, opt_state, red)

    def state_struct(self) -> TrainState:
        """A TrainState of meta tensors with the shapes and dtypes of
        :meth:`init_state`'s (the template ``CheckpointManager.restore_into``
        fills; the reference uses ``jax.eval_shape``)."""
        params = dataclasses.replace(self.model, device=torch.device("meta")).init()
        red = {}
        if self.store is not None:
            red = {n: empty_leaf_red(m, device="meta")
                   for n, m in self.store.protected_metas.items()}
        return TrainState.create(params, self.opt.init(params), red)

    def scrub_check(self, state: TrainState) -> int:
        """Scrub with the paper's double-check (delegated to the store)."""
        if self.store is None:
            return 0
        return self.store.scrub_check(protected_leaves(state.params, state.opt),
                                      state.red)

    def flush(self, state: TrainState) -> TrainState:
        """Battery/preemption flush: force Algorithm 1 now (paper §3.3),
        adopting any in-flight update first, so the result equals the
        blocking tick's bit for bit."""
        if self.store is None:
            return state
        red = self.store.flush(protected_leaves(state.params, state.opt), state.red,
                               step=state.step)
        return dataclasses.replace(state, red=red)

    def settle(self, state: TrainState) -> TrainState:
        """Adopt in-flight overlapped updates (no new pass).  Call before
        handing ``state.red`` to code outside the store's lifecycle;
        ``flush`` and ``scrub_check`` settle on their own."""
        if self.store is None:
            return state
        red = self.store.settle(state.red, protected_leaves(state.params, state.opt))
        return dataclasses.replace(state, red=red)

    def run(self, state: TrainState, data, steps: int,
            on_step: Optional[Callable[[TrainState, Dict[str, Any]], None]] = None
            ) -> TrainState:
        """``steps`` train steps, each followed by the store's tick with the
        step's wall time.  Each step waits for its loss only
        (``loss.item()`` synchronises the current stream), never for the
        device: a due update on the store's side stream overlaps the next
        step."""
        for _ in range(steps):
            t0 = time.perf_counter()
            batch = data.get(state.step)
            state, metrics = self.train_step(state, batch)
            metrics["loss"].item()
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if self.store is not None:
                st = state
                red, report = self.store.tick(
                    lambda: protected_leaves(st.params, st.opt), st.red, st.step,
                    step_time=dt, scrub_period=self.scrub_period_steps)
                state = dataclasses.replace(state, red=red)
                if report.repaired:
                    lv = protected_leaves(state.params, state.opt)
                    lv.update(report.repaired)
                    state = replace_protected(state, lv)
            if on_step is not None:
                on_step(state, metrics)
        return state
