"""The port's knob registry (``util/env.py``), ``engine`` and ``resource``
against the JAX package's on the CPU.

* Knobs: the machinery (declaration rules, typed reads, the overlay and
  its precedence, ``resolved``/``fingerprint``/``generate_docs``, the
  once-only warning about an unknown ``MXNET_*`` variable); every JAX
  knob is declared in the port (with the JAX type and default) or
  listed in ``QUEUED_KNOBS`` under its ROADMAP item, never both.
* Engine: ``bulk``, ``set_bulk_size``, the engine type, and under
  ``NaiveEngine`` the invoke path's synchronisation after each op
  outside ``bulk`` and at the scope's exit inside it (here the calls are
  counted; on the card ``chip_smoke.py`` phase 16 (e) holds the stream
  idle).
* Resource: the properties of ``tests/test_resource.py`` (streams per
  device, deterministic and independent; one device reseeded alone;
  ``mx.random.seed(s, ctx)`` routed through the manager; parallel
  streams distinct; grow-only temp space per device; the front door and
  its refusals), plus ``rng_state``/``set_rng_state``.  The streams are
  Philox and Mersenne Twister, not threefry, so draws are compared
  within the port only.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from mxnet_tpu.util import env as jenv

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.resource import ResourceManager, resource_manager
from mxnet_tpu_torch.util import env

CPU = mt.cpu()


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def test_every_jax_knob_is_declared_or_queued():
    jax_names = {k.name for k in jenv.knobs()}
    port_names = {k.name for k in env.knobs()}
    queued = set(env.QUEUED_KNOBS)
    assert port_names <= jax_names, sorted(port_names - jax_names)
    assert not port_names & queued, sorted(port_names & queued)
    assert port_names | queued == jax_names, \
        sorted(jax_names - port_names - queued)
    assert set(env.QUEUED_KNOBS.values()) <= {"2", "7", "9", "10"}
    assert {"MXNET_ZERO_STATES", "MXNET_ZERO_MIN_SIZE",
            "MXNET_PREFETCH_DEPTH"} <= port_names
    assert {"MXNET_DEFAULT_CONTEXT", "MXNET_ENGINE_TYPE",
            "MXNET_CPU_WORKER_NTHREADS", "MXNET_USE_NATIVE"} <= port_names


@pytest.mark.parametrize("name", sorted(k.name for k in env.knobs()))
def test_declared_knob_has_the_jax_type_and_default(name):
    t, j = next(k for k in env.knobs() if k.name == name), \
        next(k for k in jenv.knobs() if k.name == name)
    assert (t.typ, t.default) == (j.typ, j.default)


def test_declare_and_read_rules(monkeypatch):
    with pytest.raises(MXNetError, match="MXNET_ prefix"):
        env.declare("OTHER_KNOB", int, 0, "x")
    with pytest.raises(MXNetError, match="already registered"):
        env.declare("MXNET_ENGINE_TYPE", str, "x", "x")
    with pytest.raises(MXNetError, match="unregistered env knob"):
        env.get_int("MXNET_NO_SUCH_KNOB")
    with pytest.raises(MXNetError, match="declared as str"):
        env.get_int("MXNET_ENGINE_TYPE")
    assert env.is_declared("MXNET_FUSED_CACHE_MAX")
    assert not env.is_declared("MXNET_SPMD")
    monkeypatch.setenv("MXNET_FUSED_CACHE_MAX", "7")
    assert env.get_int("MXNET_FUSED_CACHE_MAX") == 7
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "true")
    assert env.get_bool("MXNET_FUSED_CONVBN") is True
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "maybe")
    with pytest.raises(MXNetError, match="not a boolean"):
        env.get_bool("MXNET_FUSED_CONVBN")
    monkeypatch.delenv("MXNET_DRAIN_TIMEOUT_MS", raising=False)
    assert env.get_float("MXNET_DRAIN_TIMEOUT_MS") == 30000.0
    assert env.get_float("MXNET_DRAIN_TIMEOUT_MS", default=5.0) == 5.0


def test_overlay_precedence_resolved_and_fingerprint(monkeypatch):
    monkeypatch.delenv("MXNET_FUSED_CACHE_MAX", raising=False)
    monkeypatch.setenv("MXNET_BN_EXACT_VAR", "0")
    before = env.fingerprint()
    try:
        rec = env.apply_overlay({"MXNET_FUSED_CACHE_MAX": 9,
                                 "MXNET_BN_EXACT_VAR": True,
                                 "MXNET_GONE": 1}, fingerprint="f",
                                source="s")
        assert rec["applied"] == ["MXNET_FUSED_CACHE_MAX"]
        assert rec["shadowed"] == ["MXNET_BN_EXACT_VAR"]
        assert rec["ignored"] == ["MXNET_GONE"]
        assert env.overlay_info() == rec
        assert env.get_int("MXNET_FUSED_CACHE_MAX") == 9
        assert env.get_bool("MXNET_BN_EXACT_VAR") is False
        res = env.resolved()
        assert res["MXNET_FUSED_CACHE_MAX"] == 9
        assert set(res) == {k.name for k in env.knobs()}
        assert env.fingerprint() != before
    finally:
        env.clear_overlay()
    assert env.overlay_info() is None
    assert env.fingerprint() == before
    assert env.tunables() == []


def test_generate_docs_lists_every_knob():
    doc = env.generate_docs()
    for k in env.knobs():
        assert f"`{k.name}`" in doc


def test_unknown_variable_warns_once(monkeypatch):
    monkeypatch.setattr(env, "_warned_unknown_env", False)
    monkeypatch.setenv("MXNET_ENGINE_TYP", "NaiveEngine")
    monkeypatch.setenv("MXNET_SPMD", "1")
    monkeypatch.setenv("MXNET_TEST_SEED", "3")
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        env.resolved()
        env.resolved()
    msgs = [str(w.message) for w in got]
    assert sum("MXNET_ENGINE_TYP " in m and "MXNET_ENGINE_TYPE" in m
               for m in msgs) == 1
    assert sum("MXNET_SPMD" in m and "queue A item 7" in m
               for m in msgs) == 1
    assert not any("MXNET_TEST_SEED" in m for m in msgs)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_bulk_scope_and_bulk_size():
    assert engine.current_engine_type() in ("ThreadedEnginePerDevice",
                                            "NaiveEngine")
    assert not engine.in_bulk()
    with engine.bulk(4):
        assert engine.in_bulk()
        with engine.bulk():
            assert engine._bulk_depth() == 2
        assert engine._bulk_depth() == 1
    assert not engine.in_bulk()
    prev = engine.set_bulk_size(30)
    assert engine.set_bulk_size(prev) == 30


def test_naive_engine_synchronises_after_each_op(monkeypatch):
    """Outside ``bulk`` every op call synchronises; inside it the calls
    are tracked and the synchronisation waits for the scope's exit."""
    calls = []
    monkeypatch.setattr(treg, "_NAIVE", True)
    monkeypatch.setattr(engine, "_synchronize",
                        lambda devs: calls.append(set(devs)))
    monkeypatch.setattr(engine, "current_engine_type", lambda: "NaiveEngine")
    tracked = []
    real_track = engine._track
    monkeypatch.setattr(engine, "_track",
                        lambda ts: (tracked.append(len(ts)), real_track(ts)))
    x = mt.nd.ones((3,), ctx=CPU)
    y = x + 1
    z = mt.nd.relu(y)
    assert len(calls) == 2 and not tracked
    with engine.bulk(15):
        for _ in range(4):
            z = z * 2
        assert len(calls) == 2 and len(tracked) == 4
    # host tensors leave no stream to wait for at the exit
    assert len(calls) == 2
    np.testing.assert_array_equal(z.asnumpy(), np.full(3, 32.0))


def test_engine_type_is_read_at_import():
    code = ("import mxnet_tpu_torch as mt; "
            "from mxnet_tpu_torch.ops import registry as r; "
            "from mxnet_tpu_torch import engine as e; "
            "x = mt.nd.ones((2,), ctx=mt.cpu()) * 3; "
            "print(r._NAIVE, e.current_engine_type(), x.asnumpy().sum())")
    for value, want in (("NaiveEngine", "True NaiveEngine 6.0"),
                        ("", "False ThreadedEnginePerDevice 6.0")):
        res = subprocess.run([sys.executable, "-c", code], text=True,
                             capture_output=True, timeout=120,
                             env=dict(os.environ,
                                      MXNET_ENGINE_TYPE=value))
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip() == want


# ---------------------------------------------------------------------------
# resource
# ---------------------------------------------------------------------------

def _draw(g, n=4):
    return torch.rand(n, generator=g).numpy()


def test_per_device_streams_deterministic_and_independent():
    rm = ResourceManager()
    rm.seed(7)
    a0, a1 = _draw(rm.random(mt.cpu(0))), _draw(rm.random(mt.cpu(1)))
    assert not np.array_equal(a0, a1)
    rm.seed(7)
    assert np.array_equal(_draw(rm.random(mt.cpu(0))), a0)
    assert np.array_equal(_draw(rm.random(mt.cpu(1))), a1)
    rm.seed(8)
    assert not np.array_equal(_draw(rm.random(mt.cpu(0))), a0)
    # the generator of gpu(0) is made on the card; its seed folds "gpu"
    assert rm._derive(("gpu", 0)) != rm._derive(("cpu", 0))


def test_seed_single_context_only():
    rm = ResourceManager()
    rm.seed(7)
    g0, g1 = rm.random(mt.cpu(0)), rm.random(mt.cpu(1))
    k0, k1 = _draw(g0), _draw(g1)
    rm.seed(99, ctx=mt.cpu(0))
    n0, n1 = _draw(rm.random(mt.cpu(0))), _draw(rm.random(mt.cpu(1)))
    assert not np.array_equal(n0, k0) and not np.array_equal(n1, k1)
    rm.seed(7)
    _draw(rm.random(mt.cpu(1)))
    assert np.array_equal(_draw(rm.random(mt.cpu(1))), n1)
    # reseeding resets in place: the handed-out generators follow
    assert rm.random(mt.cpu(0)) is g0 and rm.random(mt.cpu(1)) is g1


def test_mx_random_seed_ctx_routes_to_manager():
    mt.random.seed(5, ctx=mt.cpu(2))
    a = _draw(resource_manager().random(mt.cpu(2)))
    mt.random.seed(5, ctx=mt.cpu(2))
    b = _draw(resource_manager().random(mt.cpu(2)))
    assert np.array_equal(a, b)
    assert mt.random.generator(mt.cpu(2)) is resource_manager().random(
        mt.cpu(2))
    mt.random.seed(11)
    assert resource_manager().root_seed == 11


def test_parallel_random_distinct_lanes():
    gens = resource_manager().parallel_random(8, mt.cpu(0))
    assert len(gens) == 8
    draws = {tuple(_draw(g)) for g in gens}
    assert len(draws) == 8


def test_rng_state_round_trip_is_json():
    rm = ResourceManager(root_seed=3)
    g = rm.random(mt.cpu(0))
    _draw(g)
    state = json.loads(json.dumps(rm.rng_state()))
    want = _draw(g)
    rm.seed(123)
    rm.set_rng_state(state)
    assert rm.root_seed == 3 and rm.random(mt.cpu(0)) is g
    assert np.array_equal(_draw(g), want)
    fresh = ResourceManager()
    fresh.set_rng_state(state)
    assert np.array_equal(_draw(fresh.random(mt.cpu(0))), want)


def test_temp_space_grow_only_reuse():
    rm = ResourceManager()
    a = rm.temp_space(128, mt.cpu(0))
    assert a.nbytes == 128 and a.dtype == np.uint8
    b = rm.temp_space(64, mt.cpu(0))
    assert b.base is a.base
    c = rm.temp_space(1024, mt.cpu(0))
    assert c.nbytes == 1024
    d = rm.temp_space(1024, mt.cpu(1))
    assert d.ctypes.data != c.ctypes.data


def test_request_front_door_and_refusals():
    rm = ResourceManager()
    with mt.cpu():
        assert rm.request("temp_space", nbytes=16).nbytes == 16
        assert isinstance(rm.request("random"), torch.Generator)
        assert len(rm.request("parallel_random", n=3)) == 3
    with pytest.raises(MXNetError, match="descriptor"):
        rm.request("cudnn_dropout_desc")
    with pytest.raises(MXNetError, match="unknown resource kind"):
        rm.request("warp_drive")
