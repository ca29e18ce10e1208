"""Port of ``repro.serve.faults``: deterministic fault injection for the
serving stack (host-side numpy, so the port keeps its own copy).

:class:`FaultInjector` holds a typed, seeded schedule of faults and exposes
the hook protocol the continuous-batching engine threads through its hot
path:

========================  ==================================================
injection point           hook
========================  ==================================================
block-allocator failure   ``on_alloc()`` — consulted by
                          :class:`repro_torch.serve.kv_pool.BlockAllocator`
                          via its ``fail_hook``; ``True`` forces that
                          ``alloc`` call to return ``None`` (exhaustion
                          semantics: no state change)
forced preemption         ``preempt_uids(step)`` — requests to preempt at
                          the start of engine step ``step`` (chunk
                          boundary), by uid or youngest-live
poisoned logits           ``poison_rel_step(uid, ngen, length)`` — the
                          relative step inside the coming decode chunk
                          whose logits should be made non-finite for that
                          request, or ``None``
delayed arrival           ``arrival_delay(uid)`` — added to the request's
                          arrival time at ``submit``
========================  ==================================================

Every hook is a pure lookup into the schedule plus a fired-fault counter
(``injected``), so the same schedule replays identically, and
:meth:`FaultInjector.random` draws upstream's schedule for the same
arguments (both use ``np.random.default_rng``).  With no injector the
engine skips the hooks entirely; with one, logit poisoning touches only
the decode chunk a poison lands in, so every other chunk launches exactly
the fault-free kernels.

Faults target requests by ``uid`` and streams by *generation index*, not
by slot or wall time: (uid, gen) names the same point in a request's
deterministic stream under any admission order.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class AllocFailure:
    """Force the ``index``-th ``BlockAllocator.alloc`` call (0-based over
    the engine's lifetime, warm-up included) to fail as if the pool were
    exhausted.  The scheduler's wait/preempt recovery path must absorb it
    with no stream change."""

    index: int


@dataclasses.dataclass(frozen=True)
class ForcePreempt:
    """Preempt a live request at the start of engine step ``step`` (a
    chunk boundary — the only place real preemption happens).  ``uid``
    picks the victim; ``None`` preempts the youngest live request, the
    same victim policy the pool-pressure path uses.  A no-op if nothing
    matching is live at that step."""

    step: int
    uid: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PoisonLogits:
    """Make every logit non-finite at the decode step that would sample
    request ``uid``'s ``gen_index``-th generated token (0-based; index 0
    is the prefill-sampled token, so the smallest injectable index is 1).
    The quarantine contract: the request finishes with
    ``finish_reason="error"`` carrying its first ``gen_index`` tokens,
    and no other stream moves by a bit."""

    uid: int
    gen_index: int


@dataclasses.dataclass(frozen=True)
class DelayArrival:
    """Add ``delay`` clock units to request ``uid``'s arrival time at
    ``submit`` — late arrivals reshuffle admission order without touching
    any stream's content."""

    uid: int
    delay: float


Fault = Union[AllocFailure, ForcePreempt, PoisonLogits, DelayArrival]


class FaultInjector:
    """A replayable schedule of typed faults (see module docstring).

    ``injected`` counts faults that actually fired, per kind — a chaos
    trace that schedules a poison past the stream's natural end simply
    never fires it, and the counter lets tests tell the difference.
    """

    def __init__(self, faults: tuple[Fault, ...] | list[Fault] = ()):
        self.faults = tuple(faults)
        self.injected: collections.Counter = collections.Counter()
        #: Optional ``(kind, info_dict)`` callback invoked for every fired
        #: fault — the tracing seam (see
        #: ``repro_torch.serve.tracing.fault_hook``) that lands injected
        #: faults on the request timeline.
        self.on_fire = None
        self._alloc_calls = 0
        self._alloc_fail_at = {
            f.index for f in self.faults if isinstance(f, AllocFailure)
        }
        self._preempts: dict[int, list[ForcePreempt]] = {}
        self._delays: dict[int, float] = {}
        # uid -> ascending pending gen indices (consumed as they fire)
        self._poisons: dict[int, list[int]] = {}
        for f in self.faults:
            if isinstance(f, ForcePreempt):
                self._preempts.setdefault(f.step, []).append(f)
            elif isinstance(f, DelayArrival):
                self._delays[f.uid] = self._delays.get(f.uid, 0.0) + f.delay
            elif isinstance(f, PoisonLogits):
                if f.gen_index < 1:
                    raise ValueError(
                        "gen_index 0 is the prefill-sampled token; logit "
                        "poisoning targets decode steps (gen_index >= 1)"
                    )
                self._poisons.setdefault(f.uid, []).append(f.gen_index)
        for g in self._poisons.values():
            g.sort()

    def fire(self, kind: str, **info) -> None:
        """Record that a fault of ``kind`` actually fired: bump the replay
        counter and notify ``on_fire`` (if set) with the fault's context.
        Every fired-fault site — here and in the scheduler's forced-preempt
        path — funnels through this one chokepoint."""
        self.injected[kind] += 1
        if self.on_fire is not None:
            self.on_fire(kind, info)

    # -- hook protocol ------------------------------------------------------

    def on_alloc(self) -> bool:
        """Consulted once per ``BlockAllocator.alloc`` call; ``True``
        forces that call to fail."""
        i = self._alloc_calls
        self._alloc_calls += 1
        if i in self._alloc_fail_at:
            self.fire("alloc_failure", index=i)
            return True
        return False

    def preempt_uids(self, step: int) -> list[Optional[int]]:
        """Victim uids to preempt at engine step ``step`` (``None`` =
        youngest live)."""
        return [f.uid for f in self._preempts.get(step, [])]

    def arrival_delay(self, uid: int) -> float:
        d = self._delays.get(uid, 0.0)
        if d:
            self.fire("delay_arrival", uid=uid, delay=d)
        return d

    @property
    def has_poison(self) -> bool:
        """Whether any logit-poison fault is (still) scheduled — gates the
        poisoning chunk variant."""
        return any(self._poisons.values())

    def poison_rel_step(
        self, uid: int, ngen: int, length: int
    ) -> Optional[int]:
        """If request ``uid`` (currently at ``ngen`` generated tokens) has
        a poison scheduled inside the coming ``length``-step decode chunk,
        consume it and return its relative scan step; else ``None``.

        A preempted request restarts from scratch, so an unfired poison
        stays scheduled and fires on the re-run — (uid, gen) identity."""
        pend = self._poisons.get(uid)
        if not pend:
            return None
        g = pend[0]
        if ngen <= g < ngen + length:
            pend.pop(0)
            self.fire("poison_logits", uid=uid, gen_index=g)
            return g - ngen
        return None

    # -- schedule generation ------------------------------------------------

    #: Fault kinds :meth:`random` can draw, in draw order (the default
    #: tuple reproduces the historical 0..3 integer mapping bit for bit).
    KINDS = ("alloc", "preempt", "poison", "delay")

    @classmethod
    def random(
        cls,
        seed: int,
        uids,
        *,
        n_faults: int = 6,
        max_step: int = 24,
        max_alloc: int = 48,
        max_gen: int = 8,
        max_delay: float = 4.0,
        kinds=KINDS,
    ) -> "FaultInjector":
        """A seeded random schedule over ``uids`` — the chaos suite's
        entry point.  Same (seed, uids, knobs) -> same schedule, bit for
        bit, with every requested fault kind represented in expectation.

        ``kinds`` restricts (and weights, by repetition) which fault
        kinds are drawn — e.g. ``kinds=("alloc", "preempt")`` produces
        the allocation-failure + forced-preemption schedules the
        prefix-sharing chaos suite hammers shared blocks with: every
        admission walk can be denied blocks and every live request can be
        preempted *while other slots still hold references to its
        blocks*, without poison/delay faults diluting the schedule."""
        bad = set(kinds) - set(cls.KINDS)
        if bad:
            raise ValueError(f"unknown fault kinds {sorted(bad)!r}")
        if not kinds:
            raise ValueError("kinds must name at least one fault kind")
        rng = np.random.default_rng(seed)
        uids = list(uids)
        faults: list[Fault] = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            if kind == "alloc":
                faults.append(AllocFailure(int(rng.integers(0, max_alloc))))
            elif kind == "preempt":
                uid = (
                    int(rng.choice(uids)) if uids and rng.integers(0, 2)
                    else None
                )
                faults.append(
                    ForcePreempt(int(rng.integers(0, max_step)), uid)
                )
            elif kind == "poison" and uids:
                faults.append(
                    PoisonLogits(
                        int(rng.choice(uids)), int(rng.integers(1, max_gen))
                    )
                )
            elif kind == "delay" and uids:
                faults.append(
                    DelayArrival(
                        int(rng.choice(uids)),
                        float(rng.uniform(0.0, max_delay)),
                    )
                )
        return cls(faults)
