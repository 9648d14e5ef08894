"""Deterministic fault injection (`mxnet_tpu_torch.resilience.chaos`).

Counterpart of ``mxnet_tpu/resilience/chaos.py``: the same plans,
selectors, spec grammar and seeded draws, so one ``MXNET_CHAOS_SPEC``
and seed fire at the same calls in both packages.  A *site* in
first-party code calls ``chaos.check("<kind>")`` behind the
module-level ``_ACTIVE`` flag, and a test installs a *plan* saying which
call at that site fails, and how.  The disabled path is one attribute
read:

    if _chaos._ACTIVE:
        _chaos.check("serving.execute")

Kinds wired into the port:

    serving.artifact    artifact import error in serving/repository.py
    serving.execute     executor error in _ModelEntry.execute

The JAX package's dataloader, dist, kvstore and trainer sites (and the
``preempt`` action's preemption hook, which raises here) come with the
collectives' resilience (ROADMAP queue A item 10); its mxblackbox
journal of every fire waits for mxblackbox.

Plans are installed via the :func:`inject` context manager (scoped,
exception-safe) or — for subprocess experiments like the nightly chaos
stage — via the ``MXNET_CHAOS``/``MXNET_CHAOS_SPEC`` env knobs parsed
at first import of the resilience package.  Spec grammar, comma
separated:  ``kind@N`` (fail the Nth call, 1-based), ``kind@xN`` (fail
the next N calls), ``kind@pF`` (each call fails with prob. F, seeded by
``MXNET_CHAOS_SEED``), each optionally ``:action`` where action is one
of ``error`` (raise :class:`FaultInjected` — the default), ``die``
(worker death), ``hang`` (sleep ``duration`` inside the site so real
timeout machinery fires; ``hang=SECONDS`` sets the duration in a
spec), ``preempt`` (the preemption flag; not ported); and optionally
``:rank=R``.

``rank=`` is the multi-process selector: a plan carrying it fires only
in the process whose job rank is R, so one spec shipped identically
into every worker's environment (the elastic supervisor does exactly
this) can still kill or hang ONE deterministic rank.  The process rank
is stamped by :func:`set_rank` or resolved lazily
from the launcher env (``MXNET_ELASTIC_RANK``, ``DMLC_WORKER_ID``,
``PROCESS_ID``); a rank-selected plan in a process with no resolvable
rank never fires.

Every fire bumps ``mx_fault_injected_total{kind}`` and the per-kind
:func:`stats`, which persist after a scope exits so tests can assert
exactly how many faults landed.
"""
from __future__ import annotations

import random as _random
import threading
import time
from typing import Dict, List, Optional

from ..base import MXNetError

__all__ = ["FaultInjected", "inject", "check", "stats", "reset_stats",
           "export_plans", "install_plans", "active", "set_rank"]


class FaultInjected(MXNetError):
    """The error a chaos plan raises at an injection site.  ``transient``
    is True: retry policies treat an injected fault exactly like a
    transient infrastructure error (that equivalence is the point)."""

    transient = True

    def __init__(self, kind: str, nth: int):
        super().__init__(
            f"[chaos] injected fault at site '{kind}' (call #{nth})")
        self.kind = kind
        self.nth = nth

    def __reduce__(self):
        # picklable with its real constructor args: a fault injected
        # inside a process-pool worker must cross the result pipe as
        # itself, not kill the parent's result handler with a
        # TypeError during unpickling
        return (FaultInjected, (self.kind, self.nth))


#: Fast-path flag: False means no plan is installed anywhere in this
#: process and every `if _chaos._ACTIVE:` site is a single falsy check.
_ACTIVE = False

_LOCK = threading.Lock()
_PLANS: List["_Plan"] = []
_CALLS: Dict[str, int] = {}     # per-kind site call counter
_INJECTED: Dict[str, int] = {}  # per-kind fires
_ENV_DONE = False

_DEFAULT_ACTION = {"trainer.preempt": "preempt",
                   "dataloader.worker": "die",
                   "trainer.numerics": "corrupt",
                   "comm.quant": "corrupt",
                   "dist.divergence": "corrupt",
                   "elastic.worker": "die"}

#: This process's job rank for `rank=`-selected plans.  Stamped by
#: set_rank(); None = not yet known (resolved lazily
#: from the launcher env when a rank-selected plan is consulted).
_RANK: Optional[int] = None


def set_rank(rank: Optional[int]) -> None:
    """Stamp the process's job rank — what a
    ``rank=``-selected plan matches against."""
    global _RANK
    with _LOCK:
        _RANK = None if rank is None else int(rank)


def _current_rank_locked() -> Optional[int]:
    """The stamped rank, else the launcher env contract (the
    launchers export the rank before the framework is imported, so env
    resolution is race-free)."""
    if _RANK is not None:
        return _RANK
    import os as _os

    for name in ("MXNET_ELASTIC_RANK", "DMLC_WORKER_ID", "PROCESS_ID"):
        v = _os.environ.get(name)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                continue
    return None


class _Plan:
    __slots__ = ("kind", "at", "times", "p", "action", "duration",
                 "rank", "_rng", "_fired")

    def __init__(self, kind: str, at: Optional[int] = None,
                 times: Optional[int] = None, p: Optional[float] = None,
                 action: Optional[str] = None, duration: float = 0.0,
                 rank: Optional[int] = None, seed: int = 0):
        if action is None:
            # the natural action per kind: a preemption site preempts,
            # a worker site kills the worker, everything else errors
            action = _DEFAULT_ACTION.get(kind, "error")
        if action not in ("error", "die", "hang", "preempt", "corrupt"):
            raise MXNetError(f"chaos action {action!r} unknown; expected "
                             "error/die/hang/preempt/corrupt")
        if sum(x is not None for x in (at, times, p)) != 1:
            raise MXNetError(
                "chaos plan needs exactly one selector: at=N (the Nth "
                "call), times=N (the next N calls), or p=F (probability)")
        self.kind, self.at, self.times, self.p = kind, at, times, p
        self.action, self.duration = action, float(duration)
        self.rank = None if rank is None else int(rank)
        self._rng = _random.Random(seed)
        self._fired = 0

    def rank_matches(self) -> bool:
        if self.rank is None:
            return True
        cur = _current_rank_locked()
        return cur is not None and cur == self.rank

    def wants(self, nth: int) -> bool:
        if self.at is not None:
            return nth == self.at
        if self.times is not None:
            return self._fired < self.times
        return self._rng.random() < self.p

    def to_spec(self) -> dict:
        """Picklable form for shipping into spawn children."""
        return {"kind": self.kind, "at": self.at, "times": self.times,
                "p": self.p, "action": self.action,
                "duration": self.duration, "rank": self.rank}


def active() -> bool:
    return _ACTIVE


def _recompute_active_locked() -> None:
    global _ACTIVE
    _ACTIVE = bool(_PLANS)


def check(kind: str) -> Optional[str]:
    """One injection-site probe.  Counts the call; if a plan fires,
    bumps telemetry + stats and performs the action:

      * ``error``   — raises :class:`FaultInjected` here;
      * ``hang``    — sleeps ``duration`` seconds here (so the caller's
                      real timeout/watchdog machinery trips), then
                      returns ``"hang"``;
      * ``preempt`` — raises MXNetError: the preemption hook is not
                      ported;
      * ``die``     — returns ``"die"``: the CALLER performs the death
                      (a thread exits silently, a worker process
                      ``os._exit``\\ s) because only it knows how;
      * ``corrupt`` — returns ``"corrupt"``: the CALLER poisons its
                      own data (the trainer.numerics site NaNs one
                      gradient bucket) because only it owns it.

    Returns None when nothing fired."""
    with _LOCK:
        nth = _CALLS.get(kind, 0) + 1
        _CALLS[kind] = nth
        plan = next((pl for pl in _PLANS
                     if pl.kind == kind and pl.rank_matches()
                     and pl.wants(nth)), None)
        if plan is None:
            return None
        plan._fired += 1
        _INJECTED[kind] = _INJECTED.get(kind, 0) + 1
        action, duration = plan.action, plan.duration
    from ..telemetry import instruments as _ins

    _ins.fault_injected_total(kind).inc()
    if action == "error":
        raise FaultInjected(kind, nth)
    if action == "hang":
        time.sleep(duration)
        return "hang"
    if action == "preempt":
        raise MXNetError(
            f"[chaos] site '{kind}' call #{nth} fired a 'preempt' plan: "
            "resilience.preemption is not ported (ROADMAP queue A item "
            "10)")
    return action  # "die" / "corrupt": the caller performs it


class inject:
    """Scoped plan installation::

        with chaos.inject("serving.execute", at=2):      # fail call #2
        with chaos.inject("dist.collective", times=3):   # next 3 calls
        with chaos.inject("dataloader.worker", at=1, action="die"):
        with chaos.inject("dist.collective", at=1, action="hang",
                          duration=5.0):
        with chaos.inject("trainer.preempt", at=4, action="preempt"):
        with chaos.inject("elastic.worker", at=4, rank=1):  # only rank 1

    ``rank=`` makes a plan fire only in the process whose job rank
    matches (multi-process chaos: one deterministic rank dies, the
    siblings run clean even though they installed the same plan).

    Exiting the scope removes the plan (stats persist; see
    :func:`stats`/:func:`reset_stats`).  Scopes nest."""

    def __init__(self, kind: str, at: Optional[int] = None,
                 times: Optional[int] = None, p: Optional[float] = None,
                 action: Optional[str] = None, duration: float = 0.0,
                 rank: Optional[int] = None, seed: int = 0):
        self._plan = _Plan(kind, at=at, times=times, p=p, action=action,
                           duration=duration, rank=rank, seed=seed)

    def __enter__(self):
        with _LOCK:
            _PLANS.append(self._plan)
            # a fresh scope restarts the site's call numbering so at=N
            # means "the Nth call inside this scope", independent of
            # whatever ran earlier in the process
            _CALLS[self._plan.kind] = 0
            _recompute_active_locked()
        return self

    def __exit__(self, *exc):
        with _LOCK:
            try:
                _PLANS.remove(self._plan)
            except ValueError:
                pass  # mxlint: disable=MX007 — double-exit of the scope
            _recompute_active_locked()
        return False

    @property
    def fired(self) -> int:
        with _LOCK:
            return self._plan._fired


def stats() -> Dict[str, dict]:
    """Per-kind ``{"calls": n, "injected": m}`` — persists after scopes
    exit so a test can assert exactly what landed."""
    with _LOCK:
        kinds = set(_CALLS) | set(_INJECTED)
        return {k: {"calls": _CALLS.get(k, 0),
                    "injected": _INJECTED.get(k, 0)} for k in kinds}


def reset_stats() -> None:
    with _LOCK:
        _CALLS.clear()
        _INJECTED.clear()


# ---------------------------------------------------------------------------
# spawn-child transport: a process pool ships its plans to its children
# (each child runs its own counters).  The JAX DataLoader pool does so
# for dataloader.worker; the port's site comes with ROADMAP item 10.
# ---------------------------------------------------------------------------

def export_plans(kind: Optional[str] = None) -> List[dict]:
    with _LOCK:
        return [pl.to_spec() for pl in _PLANS
                if kind is None or pl.kind == kind]


def install_plans(specs: List[dict]) -> None:
    """Install exported plans (used inside spawn children at init)."""
    if not specs:
        return
    with _LOCK:
        for s in specs:
            _PLANS.append(_Plan(**s))
        _recompute_active_locked()


# ---------------------------------------------------------------------------
# env activation (subprocess experiments: nightly chaos stage, bench)
# ---------------------------------------------------------------------------

def _parse_spec(spec: str, seed: int) -> List[_Plan]:
    plans = []
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        if "@" not in part:
            raise MXNetError(
                f"MXNET_CHAOS_SPEC entry {part!r}: expected kind@selector"
                "[:action][:rank=R] (e.g. 'trainer.preempt@4:preempt' "
                "or 'elastic.worker@4:die:rank=1')")
        kind, rest = part.split("@", 1)
        sel, *mods = rest.split(":")
        action, duration, rank = None, 0.0, None
        for mod in mods:
            if not mod:
                continue
            if mod.startswith("rank="):
                rank = int(mod[len("rank="):])
            elif mod.startswith("hang="):
                action, duration = "hang", float(mod[len("hang="):])
            elif "=" in mod:
                # a typo'd key= modifier must die HERE with the real
                # diagnosis, not fall through as a bogus action name
                raise MXNetError(
                    f"MXNET_CHAOS_SPEC entry {part!r}: unknown "
                    f"modifier {mod!r} (expected rank=R or "
                    f"hang=SECONDS)")
            else:
                action = mod
        at = times = p = None
        if sel.startswith("x"):
            times = int(sel[1:])
        elif sel.startswith("p"):
            p = float(sel[1:])
        else:
            at = int(sel)
        plans.append(_Plan(kind, at=at, times=times, p=p, action=action,
                           duration=duration, rank=rank, seed=seed))
    return plans


def _init_from_env() -> None:
    """Install plans from MXNET_CHAOS/MXNET_CHAOS_SPEC once (called by
    the package __init__; idempotent)."""
    global _ENV_DONE
    with _LOCK:
        if _ENV_DONE:
            return
        _ENV_DONE = True
    from ..util import env

    if not env.get_bool("MXNET_CHAOS"):
        return
    spec = env.get_str("MXNET_CHAOS_SPEC") or ""
    plans = _parse_spec(spec, env.get_int("MXNET_CHAOS_SEED"))
    with _LOCK:
        _PLANS.extend(plans)
        _recompute_active_locked()
