"""The registry of ``MXNET_*`` environment knobs.

Counterpart of ``mxnet_tpu/util/env.py``: every knob the port reads is
declared here once (name, type, default, documentation) and read
through the typed accessors (:func:`get_int`, :func:`get_bool`,
:func:`get_str`, :func:`get_float`); reading an undeclared name raises.
The machinery is the JAX package's: the tuned-config overlay
(:func:`apply_overlay`; an explicit setting in the environment always
wins), :func:`resolved` and :func:`fingerprint` over the declared
table, :func:`generate_docs`, and a once-only warning about an
``MXNET_*`` variable that names no knob.

A knob is declared by the slice that ports its reader.  The JAX
package's other knobs are listed in :data:`QUEUED_KNOBS` under the
ROADMAP queue A item that ports their readers, as ``ops/registry.py``
lists op names.
"""
from __future__ import annotations

import os as _os
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from ..base import MXNetError
from ..base import convert_env as _convert_env
from ..base import get_env as _raw_get_env

__all__ = ["Knob", "Tunable", "declare", "knobs", "is_declared",
           "tunables", "get_int", "get_bool", "get_str", "get_float",
           "apply_overlay", "overlay_info", "clear_overlay", "resolved",
           "fingerprint", "generate_docs", "trace_knobs", "QUEUED_KNOBS"]


class Tunable(NamedTuple):
    """Search-space metadata a knob declares about itself: a numeric
    range (``lo``/``hi``, ``scale`` 'linear' or 'log') or ``choices``."""
    lo: Optional[float] = None
    hi: Optional[float] = None
    scale: str = "linear"
    choices: Optional[Tuple[Any, ...]] = None


class Knob(NamedTuple):
    name: str
    typ: type
    default: Any
    doc: str
    tunable: Optional[Tunable] = None


_KNOBS: Dict[str, Knob] = {}
_LOCK = threading.Lock()
_UNSET = object()

# tuned-config overlay: name -> the raw string the environment would
# carry, consulted only when the environment leaves the knob unset
_OVERLAY: Dict[str, str] = {}
_OVERLAY_META: Optional[Dict[str, Any]] = None


def declare(name: str, typ: type, default: Any, doc: str,
            tunable: Optional[Tunable] = None) -> Knob:
    """Register a knob; a second declaration of a name raises."""
    if not name.startswith("MXNET_"):
        raise MXNetError(
            f"env knob {name!r} must use the MXNET_ prefix; other "
            "process env vars are not framework knobs")
    if tunable is not None and typ is bool and tunable.choices is None:
        tunable = tunable._replace(choices=(False, True))
    k = Knob(name, typ, default, doc, tunable)
    with _LOCK:
        if name in _KNOBS:
            prev = _KNOBS[name]
            raise MXNetError(
                f"env knob {name} already registered "
                f"({prev.typ.__name__}, default {prev.default!r}) — "
                "duplicate declaration; every knob is declared exactly "
                "once in mxnet_tpu_torch/util/env.py")
        _KNOBS[name] = k
    return k


def is_declared(name: str) -> bool:
    return name in _KNOBS


def knobs() -> List[Knob]:
    """All declared knobs, sorted by name."""
    with _LOCK:
        return sorted(_KNOBS.values(), key=lambda k: k.name)


def tunables() -> List[Knob]:
    """The knobs that declared :class:`Tunable` metadata."""
    return [k for k in knobs() if k.tunable is not None]


def _get(name: str, typ: type, default: Any) -> Any:
    knob = _KNOBS.get(name)
    if knob is None:
        raise MXNetError(
            f"unregistered env knob {name!r} — declare it in "
            f"mxnet_tpu_torch/util/env.py (known: {sorted(_KNOBS)})")
    if knob.typ is not typ:
        raise MXNetError(f"env knob {name} is declared as "
                         f"{knob.typ.__name__}, read as {typ.__name__}")
    dflt = knob.default if default is _UNSET else default
    raw = _os.environ.get(name)
    if (raw is None or raw == "") and name in _OVERLAY:
        # precedence: explicit env (non-empty) > tuned overlay > default
        return _convert_env(name, _OVERLAY[name], typ)
    return _raw_get_env(name, dflt, typ)


def get_int(name: str, default: Any = _UNSET) -> Optional[int]:
    return _get(name, int, default)


def get_bool(name: str, default: Any = _UNSET) -> Optional[bool]:
    return _get(name, bool, default)


def get_str(name: str, default: Any = _UNSET) -> Optional[str]:
    return _get(name, str, default)


def get_float(name: str, default: Any = _UNSET) -> Optional[float]:
    return _get(name, float, default)


def apply_overlay(config: Dict[str, Any], fingerprint: str = "",
                  source: str = "") -> Dict[str, Any]:
    """Install a tuned-config overlay: each declared knob of ``config``
    that the environment leaves unset reads its value from here; a knob
    the environment sets is recorded as ``shadowed``, an undeclared
    name as ``ignored``.  Returns the record :func:`overlay_info`
    gives."""
    global _OVERLAY_META
    applied, shadowed, ignored = [], [], []
    with _LOCK:
        for name in sorted(config):
            if name not in _KNOBS:
                ignored.append(name)
                continue
            raw = _os.environ.get(name)
            if raw is not None and raw != "":
                shadowed.append(name)
                continue
            value = config[name]
            _OVERLAY[name] = ("1" if value else "0") \
                if isinstance(value, bool) else str(value)
            applied.append(name)
        _OVERLAY_META = {"fingerprint": fingerprint, "source": source,
                         "applied": applied, "shadowed": shadowed,
                         "ignored": ignored}
        return dict(_OVERLAY_META)


def overlay_info() -> Optional[Dict[str, Any]]:
    """The record of the last :func:`apply_overlay`, or None."""
    with _LOCK:
        return dict(_OVERLAY_META) if _OVERLAY_META is not None else None


def clear_overlay() -> None:
    global _OVERLAY_META
    with _LOCK:
        _OVERLAY.clear()
        _OVERLAY_META = None


# control variables that use the MXNET_ prefix without being knobs
_NON_KNOB_ENV = {"MXNET_NIGHTLY", "MXNET_TEST_SEED", "MXNET_TEST_PLATFORM"}
_warned_unknown_env = False


def _warn_unknown_env_once() -> None:
    """Warn, once a process, about each MXNET_* variable that names no
    declared knob (nor a queued one) — a misspelt knob is otherwise
    ignored for ever."""
    global _warned_unknown_env
    with _LOCK:
        if _warned_unknown_env:
            return
        _warned_unknown_env = True
        known = sorted(_KNOBS)
    import difflib
    import warnings

    for name in sorted(_os.environ):
        if (not name.startswith("MXNET_") or name in _KNOBS
                or name in _NON_KNOB_ENV):
            continue
        item = QUEUED_KNOBS.get(name)
        if item is not None:
            warnings.warn(
                f"env var {name} has no effect in mxnet_tpu_torch yet: "
                f"ROADMAP queue A item {item} ports its reader",
                RuntimeWarning, stacklevel=3)
            continue
        close = difflib.get_close_matches(name, known, n=1)
        hint = f" — did you mean {close[0]}?" if close else ""
        warnings.warn(f"env var {name} is not a registered MXNET_ knob "
                      f"and has no effect{hint}", RuntimeWarning,
                      stacklevel=3)


def resolved() -> Dict[str, Any]:
    """Every declared knob's resolved value (environment, overlay or
    declared default; a dynamic default resolves to None)."""
    _warn_unknown_env_once()
    getters = {int: get_int, bool: get_bool, str: get_str,
               float: get_float}
    out = {}
    for k in knobs():
        try:
            out[k.name] = getters[k.typ](k.name)
        except Exception:  # noqa: BLE001 — one bad value must not hide the rest
            out[k.name] = "<unreadable>"
    return out


def fingerprint() -> str:
    """sha256 over the sorted resolved knob table."""
    import hashlib

    h = hashlib.sha256()
    for name, value in sorted(resolved().items()):
        h.update(f"{name}={value!r}\x1f".encode())
    return h.hexdigest()


def generate_docs() -> str:
    """Markdown reference for every declared knob."""
    lines = ["# Environment variables of mxnet_tpu_torch", "",
             "Generated from the knob registry "
             "(`mxnet_tpu_torch/util/env.py`).", "",
             "| Variable | Type | Default | Description |",
             "|---|---|---|---|"]
    for k in knobs():
        dflt = "*(dynamic)*" if k.default is None else f"`{k.default!r}`"
        doc = " ".join(k.doc.split())
        lines.append(f"| `{k.name}` | {k.typ.__name__} | {dflt} | {doc} |")
    lines.append("")
    return "\n".join(lines)


# the knobs a forward reads while it runs (which path a block takes): a
# captured forward or step keeps the values it was captured under, as a
# jitted JAX program keeps those it was traced under, so they are part
# of its signature
_TRACE_KNOBS = ("MXNET_FUSED_CONVBN", "MXNET_FUSED_CONVBN_BWD",
                "MXNET_BN_EXACT_VAR")


def trace_knobs() -> tuple:
    return tuple(get_bool(k) for k in _TRACE_KNOBS)


# The JAX package's knobs whose readers the port does not have yet,
# under the ROADMAP queue A item that ports them.
_QUEUED_KNOBS_BY_ITEM = {
    "2": ("MXNET_FUSED_OPTIMIZER",),
    # production layers: the kernel-choice and compile caches, autotune,
    # resilience and observability
    "10": ("MXNET_PALLAS_INTERPRET", "MXNET_PALLAS_PROBE_BUDGET",
           "MXNET_USE_PALLAS", "MXNET_COMPILE_CACHE_BYTES",
           "MXNET_COMPILE_CACHE_DIR", "MXNET_COMPILE_CACHE_DISABLE",
           "MXNET_COMPILE_CACHE_OPS", "MXNET_OP_CACHE_MAX", "MXNET_AUTOTUNE",
           "MXNET_AUTOTUNE_DIR", "MXNET_AUTOTUNE_SCENARIO",
           "MXNET_AUTOTUNE_TRIAL_TIMEOUT_S", "MXNET_CKPT_EVERY",
           "MXNET_CKPT_KEEP", "MXNET_ELASTIC", "MXNET_ELASTIC_DIR",
           "MXNET_ELASTIC_RANK", "MXNET_ELASTIC_WORLD",
           "MXNET_ELASTIC_HEARTBEAT_S", "MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S",
           "MXNET_ELASTIC_MAX_RESTARTS", "MXNET_ELASTIC_GRACE_S",
           "MXNET_RANKCHECK", "MXNET_RANKCHECK_WINDOW",
           "MXNET_RANKCHECK_WAIT_S", "MXNET_BLACKBOX", "MXNET_BLACKBOX_DIR",
           "MXNET_BLACKBOX_GEN", "MXNET_BLACKBOX_HISTORY",
           "MXNET_BLACKBOX_RING", "MXNET_BLACKBOX_SPILL_MB",
           "MXNET_BLACKBOX_STDERR_TAIL_KB", "MXNET_BLACKBOX_TAIL",
           "MXNET_GOODPUT", "MXNET_GOODPUT_MIN",
           "MXNET_GOODPUT_UNATTRIBUTED_MAX", "MXNET_HEALTH",
           "MXNET_HEALTH_ALERT_TICK_MS", "MXNET_HEALTH_EVERY",
           "MXNET_HEALTH_POLICY",
           "MXNET_HEALTH_RATIO_MAX", "MXNET_HEALTH_RING",
           "MXNET_HEALTH_SPIKE_K", "MXNET_HEALTH_WINDOW", "MXNET_IR_AUDIT",
           "MXNET_IR_OUT", "MXNET_IR_REPL_BYTES", "MXNET_IR_WIRE_TOL",
           "MXNET_SAN", "MXNET_SAN_OUT", "MXNET_SAN_SUPPRESS", "MXNET_MXPROF",
           "MXNET_MXPROF_RING", "MXNET_MXPROF_HBM_EVERY", "MXNET_MXPROF_DUMP",
           "MXNET_TRIAGE_DIR", "MXNET_TRIAGE_SECONDS",
           "MXNET_TRIAGE_ALERT_INTERVAL_S", "MXNET_TRIAGE_STEP_TIMEOUT_S",
           "MXNET_TRIAGE_HISTORY", "MXNET_PEAK_FLOPS"),
}
QUEUED_KNOBS: Dict[str, str] = {n: item for item, names in
                                _QUEUED_KNOBS_BY_ITEM.items()
                                for n in names}


# ---------------------------------------------------------------------------
# The knob catalogue: one declaration per knob the port reads.
# ---------------------------------------------------------------------------

# -- engine / dispatch ------------------------------------------------------
declare("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
        "Execution engine. 'ThreadedEnginePerDevice' (default) is "
        "PyTorch's asynchronous dispatch; 'NaiveEngine' makes the "
        "imperative invoke path synchronise the op's stream after each "
        "op (at bulk-scope exit inside engine.bulk), for debugging. Read "
        "once, at import.")
declare("MXNET_CPU_WORKER_NTHREADS", int, None,
        "Worker threads of the native dependency engine "
        "(lib.NativeEngine). Default is computed: max(2, os.cpu_count()).")
declare("MXNET_USE_NATIVE", bool, True,
        "Build and load the native C++ modules (engine, RecordIO, image "
        "pipeline) from mxnet_tpu_torch/native. 0 makes every caller take "
        "its Python path (ImageRecordIter decodes in Python). Read at "
        "each use.")

# -- contexts / memory ------------------------------------------------------
declare("MXNET_DEFAULT_CONTEXT", str, None,
        "Force the default device context ('cpu' or 'gpu'). Default is "
        "computed: gpu(0) when CUDA is present; without CUDA there is no "
        "default and current_context() raises.")
declare("MXNET_GPU_MEM_POOL_RESERVE", int, None,
        "Percent of each card's memory kept out of the caching "
        "allocator (reference spelling): storage sets "
        "torch.cuda.set_per_process_memory_fraction((100 - r) / 100) at "
        "the process's first CUDA use. Unset = no limit.")

# -- library init, profiling, tests -----------------------------------------
declare("MXNET_USE_SIGNAL_HANDLER", bool, True,
        "Install faulthandler crash signal handlers at import (ref: "
        "src/initialize.cc).")
declare("MXNET_PROFILER_AUTOSTART", bool, False,
        "Start the chrome-trace profiler at import (ref: "
        "MXNET_PROFILER_AUTOSTART).")
declare("MXNET_TEST_DEFAULT_CONTEXT", str, "",
        "Test-suite context override: 'gpu' or 'cpu' "
        "(ref: test_utils.default_context).")

# -- training ---------------------------------------------------------------
declare("MXNET_BACKWARD_DO_MIRROR", bool, False,
        "Gradient mirroring: a hybridized block's backward recomputes the "
        "activations of each sub-block that owns parameters "
        "(torch.utils.checkpoint segments) instead of keeping them in "
        "device memory — trades FLOPs for memory.  hybridize(mirror=...) "
        "overrides it per block.")

declare("MXNET_ZERO_STATES", bool, True,
        "SPMDTrainer under dp > 1, and gluon.Trainer(spmd=True)'s "
        "SpmdUpdater over several replicas or ranks: split the optimizer "
        "state of each large trained tensor over them (ZeRO-1 / "
        "arXiv:2004.13336): reduce-scatter its gradient, update this "
        "shard's block, all-gather the weight. 0 keeps every state "
        "replicated (the gradient sum is then a plain all-reduce).")
declare("MXNET_ZERO_MIN_SIZE", int, 2048,
        "Smallest trained tensor (elements) whose optimizer state "
        "MXNET_ZERO_STATES splits; smaller ones stay replicated.")
declare("MXNET_FUSED_BUCKET_BYTES", int, 4 << 20,
        "Bucket size of KVStore.pushpull_fused (gluon.Trainer's gradient "
        "sum over replicas or ranks): one sum, and one collective on a "
        "dist store, per this many bytes of dtype-homogeneous dense "
        "gradients.")
declare("MXNET_KVSTORE_TIMEOUT", float, None,
        "Seconds a distributed collective may block before it fails, "
        "instead of hanging on a dead peer: the process group's timeout "
        "(parallel.dist.init). Unset/0 = the backend's default.")
declare("MXNET_SPMD", bool, False,
        "Route gluon.Trainer.step through SpmdUpdater: one update over "
        "every replica or rank (gradient reduce-scatter, shard-local "
        "update, weight all-gather) instead of one update per replica. "
        "Trainer(spmd=...) overrides per trainer. Falls back to the "
        "per-replica path, states handed off, for sparse gradients, "
        "ragged layouts or optimizers without a fused form.")
declare("MXNET_SPMD_BUCKET_BYTES", int, 0,
        "Bucket size of SpmdUpdater's ZeRO buckets. 0 = inherit "
        "MXNET_FUSED_BUCKET_BYTES.")
declare("MXNET_COMM_QUANT", str, "none",
        "Wire encoding of SpmdUpdater's bucket collectives (the gradient "
        "reduce and the weight gather): 'int8' (symmetric linear) or "
        "'fp8' (e4m3), 1 byte/elem with one fp32 scale per 512-element "
        "block and error-feedback residuals; 'none' keeps full-precision "
        "collectives.")
declare("MXNET_COMM_QUANT_EF", bool, True,
        "Carry error-feedback residuals for MXNET_COMM_QUANT (the "
        "quantization remainder re-enters the next step's payload "
        "before encoding). Disable only for A/B experiments.")
declare("MXNET_COMM_QUANT_MIN_SIZE", int, 2048,
        "Smallest bucket (padded elements) MXNET_COMM_QUANT encodes; "
        "smaller buckets stay full precision.")
declare("MXNET_COMM_OVERLAP", bool, False,
        "SpmdUpdater issues each bucket's gradient collective on its own "
        "(async_op), in reverse bucket order, and waits for them all "
        "before the updates: the same bits as the one-pass step.")

# -- data -------------------------------------------------------------------
declare("MXNET_PREFETCH_DEPTH", int, None,
        "DataLoader prefetch depth: batches each iterator keeps in "
        "flight ahead of the consumer, in both the process and thread "
        "worker pools. Default is computed: 2 * num_workers. The "
        "DataLoader(prefetch=) argument overrides per loader.")

# -- ops / kernels ----------------------------------------------------------
declare("MXNET_BN_EXACT_VAR", bool, False,
        "BatchNorm uses the exact two-pass variance instead of the "
        "single-pass shifted estimator; also disables the fused Conv+BN "
        "path (whose statistics are inherently single-pass).")
declare("MXNET_FUSED_CONVBN", bool, False,
        "Route ResNet V1 residual blocks through the fused Conv+BN+ReLU "
        "CUDA kernel when running hybridized in NHWC layout.")
declare("MXNET_FUSED_CONVBN_BWD", bool, False,
        "Run the backward of the fused Conv+BN units through the fused "
        "backward CUDA kernel (stride-1 units; strided units keep the "
        "dgrad/wgrad convolution backward).")

# -- compile cache ----------------------------------------------------------
declare("MXNET_FUSED_CACHE_MAX", int, 256,
        "Entry cap of each in-process cache of captured CUDA graphs "
        "(_graphs: the fused update, the SPMD step, the "
        "hybridized forward); LRU eviction past it.")

# -- resilience -------------------------------------------------------------
declare("MXNET_DRAIN_TIMEOUT_MS", float, 30000.0,
        "Hard deadline for InferenceServer.shutdown(drain=True): past "
        "it, still-queued requests fail with ServerClosed instead of "
        "the shutdown hanging forever on a wedged batch.")

# -- telemetry, resilience (serving's production layer) ----------------------
declare("MXNET_TELEMETRY", bool, False,
        "Enable telemetry span tracing at import (metrics are always "
        "on; this turns on trace-event emission — see "
        "docs/observability.md).")
declare("MXNET_BREAKER_THRESHOLD", int, 5,
        "Serving circuit breaker: consecutive executor failures that "
        "open the breaker (that model answers 503 until a probe "
        "succeeds; the process never dies).")
declare("MXNET_BREAKER_COOLDOWN_MS", float, 1000.0,
        "Serving circuit breaker: milliseconds an OPEN breaker waits "
        "before letting one half-open probe request through.",
        tunable=Tunable(lo=100.0, hi=5000.0, scale="log"))
declare("MXNET_CHAOS", bool, False,
        "Master switch for the fault-injection harness "
        "(resilience.chaos). Off = every injection site is a single "
        "falsy flag check with zero behavior change.")
declare("MXNET_CHAOS_SEED", int, 0,
        "Seed for probabilistic chaos plans (kind@pF in "
        "MXNET_CHAOS_SPEC) — schedules replay deterministically.")
declare("MXNET_CHAOS_SPEC", str, "",
        "Comma-separated chaos plans installed at import when "
        "MXNET_CHAOS=1: 'kind@N' (fail Nth call), 'kind@xN' (next N), "
        "'kind@pF' (probability F), optional ':action' "
        "(error/die/hang/preempt). See docs/resilience.md.")
declare("MXNET_RETRY_BASE_MS", float, 50.0,
        "Retry policy: first backoff delay in milliseconds (doubles "
        "per attempt, jittered ±50%, capped at MXNET_RETRY_MAX_MS).",
        tunable=Tunable(lo=10.0, hi=500.0, scale="log"))
declare("MXNET_RETRY_BUDGET_MS", float, 10000.0,
        "Retry policy: hard wall-clock budget across all attempts of "
        "one call, including backoff sleeps.")
declare("MXNET_RETRY_MAX_ATTEMPTS", int, 3,
        "Retry policy: total attempts per retryable call site "
        "(1 = no retry). Only transient errors retry.")
declare("MXNET_RETRY_MAX_MS", float, 2000.0,
        "Retry policy: backoff delay ceiling in milliseconds.",
        tunable=Tunable(lo=500.0, hi=10000.0, scale="log"))
