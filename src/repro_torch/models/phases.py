"""A differentiated function cut at its collectives, and its backward on the
caller's thread.

The reference differentiates a stage forward that holds collectives (the
MoE ``ep``/``tp`` exchanges) with ``jax.grad``: XLA transposes each
collective inside the backward program.  The port's ranks are threads of
one process, and a collective must be called by its rank's thread, never
inside an autograd backward (``launch/mesh.py``).  So a function that
exchanges is written as *phases* separated by *cuts*:

    state_0 -> phase_0 -> state_1 --cut_0--> state_1' -> phase_1 -> ...

A state is a dict of named tensors; a phase maps one to the next; a cut
replaces one entry of the state by a collective of it over the caller's
group, ``exchange(cut.name, tensor)``.  :func:`run_forward` runs the
phases with the exchanges in between (no autograd); :func:`phased_grads`
differentiates them:

* forward: every phase runs under autograd on detached leaves of its input
  state (floating entries require grad; integer ones, e.g. the MoE
  dispatch's expert ids and slots, are carried as they are), and the cuts
  exchange the detached outputs;
* backward: the phases in reverse, one ``torch.autograd.grad`` each, from
  the gradients of their outputs to those of their input leaves and of
  the parameters; between two phases the caller's thread calls the
  transposed collective of the cut (``all_to_all`` -> ``all_to_all``,
  ``all_gather`` (stacked) -> ``psum_scatter``, ``psum_scatter`` ->
  ``all_gather``), always, with zeros where no gradient reaches the cut,
  so that every rank of a group reaches the same collectives.

Each phase is differentiated once (no re-walk of the graph per cut), and
its own internals may still be checkpointed (no collective lies inside a
phase).  Parameter gradients are summed over the phases in the walk's
fixed order (last phase first), so a rerun gives the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

State = dict[str, torch.Tensor]
Phase = Callable[[State], State]
Exchange = Callable[[str, torch.Tensor], torch.Tensor]

#: the collective whose transpose (vector-Jacobian product) each cut takes
TRANSPOSE = {"all_to_all": "all_to_all", "all_gather": "psum_scatter",
             "psum_scatter": "all_gather"}


@dataclasses.dataclass(frozen=True)
class Cut:
    key: str   # the state entry the collective replaces
    name: str  # all_to_all | all_gather (stacked) | psum_scatter


def _check(phases: Sequence[Phase], cuts: Sequence[Cut]) -> None:
    if len(phases) != len(cuts) + 1:
        raise ValueError(f"{len(phases)} phases for {len(cuts)} cuts: "
                         f"a cut lies between two phases")
    for c in cuts:
        if c.name not in TRANSPOSE:
            raise ValueError(f"no transpose for collective {c.name!r}")


def chain(steps: Sequence[Phase]) -> Phase:
    """One phase of several steps run in turn."""
    def phase(state: State) -> State:
        for step in steps:
            state = step(state)
        return state

    return phase


def run_forward(phases: Sequence[Phase], cuts: Sequence[Cut], state: State,
                exchange: Exchange) -> State:
    """The phases with their exchanges, under ``no_grad``."""
    _check(phases, cuts)
    with torch.no_grad():
        for k, phase in enumerate(phases):
            state = phase(dict(state))
            if k < len(cuts):
                c = cuts[k]
                state = {**state, c.key: exchange(c.name, state[c.key])}
    return state


def _leaf(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.requires_grad_() if t.is_floating_point() else t


def phased_grads(phases: Sequence[Phase], cuts: Sequence[Cut], state: State,
                 exchange: Exchange, params: Sequence[torch.Tensor],
                 seeds: dict[str, torch.Tensor | None],
                 wanted: Sequence[str] = ()
                 ) -> tuple[dict[str, torch.Tensor | None],
                            list[torch.Tensor | None], State]:
    """Differentiate ``phases`` from ``state``: returns (the gradients of
    the ``wanted`` entries of ``state``, the gradients of ``params`` (None
    where no phase reaches one), the last phase's output state).

    ``seeds`` maps entries of the last output state to their gradients
    (None: ones, for a scalar objective).  Collectives are called only
    here, on the caller's thread, between the ``autograd.grad`` calls."""
    _check(phases, cuts)
    params = tuple(params)
    records: list[tuple[State, State] | None] = []
    for k, phase in enumerate(phases):
        leaves = {n: _leaf(t) for n, t in state.items()}
        with torch.enable_grad():
            out = phase(dict(leaves))
        records.append((leaves, out))
        if k < len(cuts):
            c = cuts[k]
            with torch.no_grad():
                state = {**{n: t.detach() for n, t in out.items()},
                         c.key: exchange(c.name, out[c.key].detach())}
    final = records[-1][1]
    grads: dict[str, torch.Tensor | None] = {
        n: torch.ones_like(final[n]) if g is None else g
        for n, g in seeds.items()}
    d_params: list[torch.Tensor | None] = [None] * len(params)
    for k in reversed(range(len(phases))):
        leaves, out = records[k]  # type: ignore[misc]
        outs, g_outs = [], []
        through: dict[str, torch.Tensor] = {}  # entries passed unchanged
        for n, g in grads.items():
            if g is None:
                continue
            t = out[n]
            if leaves.get(n) is t:
                through[n] = g
            elif t.requires_grad:
                outs.append(t)
                g_outs.append(g)
        names = [n for n, t in leaves.items() if t.requires_grad
                 and (k > 0 or n in wanted)]
        got: list = [None] * (len(names) + len(params))
        if outs and (names or params):
            got = list(torch.autograd.grad(
                outs, [leaves[n] for n in names] + list(params), g_outs,
                allow_unused=True))
        grads = dict(zip(names, got[:len(names)]))
        records[k] = None  # this phase's buffers are no longer needed
        for n, g in through.items():
            grads[n] = g if grads.get(n) is None else grads[n] + g
        for j, g in enumerate(got[len(names):]):
            if g is not None:
                d_params[j] = g if d_params[j] is None else d_params[j] + g
        if k > 0:
            c = cuts[k - 1]
            g = grads.get(c.key)
            if g is None:
                g = torch.zeros_like(leaves[c.key])
            grads[c.key] = exchange(TRANSPOSE[c.name], g)
    return {n: grads.get(n) for n in wanted}, d_params, final
