"""mxnet_tpu_torch's tap-accumulation unit and probe against the JAX package.

The port's ``candidate_tap`` on CPU tensors runs its plain PyTorch
version; it is held against the JAX ``candidate_tap``
(``tools/scratch_convbn_probe.py``, loaded by file path: ``tools/`` is no
package) with ``pallas_call`` in interpret mode, on the same numpy
inputs.  The CUDA kernel itself runs only on a card: ``chip_smoke.py``
phase 7 holds it against the plain version there.

Tolerances: fp32 y and s1/s2 within 1e-5 of the largest magnitude (the
same arithmetic in another summation order); bf16 y within 1 bf16 ulp
of the JAX y plus 4·√K·2⁻²⁴·Σ|u·w|, the spread of two fp32 summation
orders over the K products (an output that cancels to near zero would
otherwise be held to an ulp of itself), plus Σ|Δu|·|w| for the u that
round differently: in interpret mode XLA contracts x·scale+bias into
one fused multiply-add on the CPU, where the port rounds after the
multiply and after the add (as kernel 1 does), so at the probe's inputs
2-4 of 131072-262144 u differ by one bf16 ulp; s1/s2 within 1e-4 of
Σ|.|; without want_stats s1/s2 are exact zeros in both packages.
"""
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_convbn as pcb

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import convbn_tap as tap
from mxnet_tpu_torch.tools import convbn_probe

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def jprobe(monkeypatch):
    """The JAX probe module with pallas_call in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "scratch_convbn_probe", REPO / "tools" / "scratch_convbn_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    return mod


def _inputs(seed, shape, co, kernel, dtype, bias_shift=0.0):
    """numpy inputs, x and w_taps already rounded to `dtype` (so both
    packages get the same bits)."""
    rs = np.random.RandomState(seed)
    ci = shape[-1]
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(*kernel, ci, co) / np.sqrt(ci * kernel[0] * kernel[1])) \
        .astype(np.float32)
    x, w = (torch.from_numpy(a).to(dtype).float().numpy() for a in (x, w))
    sc = (rs.rand(ci) + 0.5).astype(np.float32)
    bi = (rs.randn(ci) * 0.5 + bias_shift).astype(np.float32)
    sh = (rs.randn(co) * 0.1).astype(np.float32)
    return x, w, sc, bi, sh


def _jax(fn, x, w, sc, bi, sh, dtype, **kw):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = fn(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
             jnp.asarray(sc), jnp.asarray(bi), jnp.asarray(sh), **kw)
    return [np.asarray(jnp.asarray(o).astype(jnp.float32)) for o in out]


def _port(x, w, sc, bi, sh, dtype, **kw):
    y, s1, s2 = tap.candidate_tap(
        torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
        torch.from_numpy(sc), torch.from_numpy(bi), torch.from_numpy(sh),
        **kw)
    assert y.dtype == dtype and s1.shape == s2.shape == (1, w.shape[-1])
    return [t.float().numpy() for t in (y, s1, s2)]


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _slack(x, w, sc, bi, act_in, stride, pad):
    """What bf16 y may differ by besides its last bit, per output (NHWC):
    4·√K·2⁻²⁴·Σ|u·w|, the spread of two fp32 summation orders over the K
    products, plus Σ|Δu|·|w|, where Δu is u rounded from one fused
    multiply-add (as XLA contracts x·scale+bias on the CPU) minus u from a
    multiply and an add (the port, its kernel and kernel 1)."""
    tx, tw = (torch.from_numpy(np.asarray(a, np.float32)).double()
              for a in (x, w))
    if act_in:
        sc, bi = torch.from_numpy(sc).double(), torch.from_numpy(bi).double()
        u = (tx.float() * sc.float() + bi.float()).clamp_min(0.0)
        u_fma = (tx * sc + bi).float().clamp_min(0.0)
        u, u_fma = (t.bfloat16().double() for t in (u, u_fma))
    else:
        u = u_fma = tx

    def conv(a, b):
        return torch.nn.functional.conv2d(
            a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1), stride=stride,
            padding=pad).permute(0, 2, 3, 1)
    k = w.shape[0] * w.shape[1] * w.shape[2]
    mag = conv(u.abs(), tw.abs())
    return (4.0 * np.sqrt(k) * 2.0 ** -24 * mag
            + conv((u - u_fma).abs(), tw.abs())).numpy()


def _hold(port, ref, dtype, want_stats, shift, slack=0.0):
    y, s1, s2 = port
    yr, s1r, s2r = ref
    assert y.shape == yr.shape
    if dtype == torch.float32:
        assert np.abs(y - yr).max() <= 1e-5 * np.abs(yr).max()
        for s, r in ((s1, s1r), (s2, s2r)):
            assert np.abs(s - r).max() <= 1e-5 * np.abs(r).max()
    else:
        assert np.all(np.abs(y - yr) <= _bf16_ulp(yr) + slack)
        if want_stats:
            co = y.shape[-1]
            abs1 = np.abs(yr).reshape(-1, co).sum(axis=0)
            abs2 = ((yr - shift) ** 2).reshape(-1, co).sum(axis=0)
            assert np.all(np.abs(s1 - s1r) <= 1e-4 * abs1)
            assert np.all(np.abs(s2 - s2r) <= 1e-4 * abs2)
    if not want_stats:
        assert not s1.any() and not s2.any()
        assert not s1r.any() and not s2r.any()


# (shape NHWC, Co, kernel, stride, pad, act_in, want_stats, nb, dtype,
#  in_bias shift)
F32, BF16 = torch.float32, torch.bfloat16
CASES = [
    ((2, 8, 8, 16), 24, (1, 1), (1, 1), (0, 0), True, True, 1, F32, 0.0),
    ((4, 9, 9, 8), 16, (3, 3), (2, 2), (1, 1), True, True, 2, F32, 0.0),
    ((4, 7, 7, 16), 8, (3, 3), (1, 1), (1, 1), False, True, 4, F32, 0.0),
    ((2, 8, 8, 8), 16, (1, 1), (2, 2), (0, 0), True, False, 2, F32, 0.0),
    ((4, 8, 8, 32), 32, (3, 3), (1, 1), (1, 1), True, True, 2, BF16, 0.0),
    ((4, 16, 16, 16), 32, (1, 1), (1, 1), (0, 0), True, True, 4, BF16, 0.0),
    ((2, 9, 9, 16), 8, (3, 3), (2, 2), (1, 1), False, True, 1, BF16, 0.0),
    ((4, 8, 8, 16), 16, (1, 1), (2, 2), (0, 0), True, False, 1, BF16, 0.0),
    # border taps must read exact zeros after the affine, never relu(bias)
    ((4, 6, 6, 8), 8, (3, 3), (1, 1), (1, 1), True, True, 2, BF16, 1.5),
]


def _ids(c):
    return (f"{'bf16' if c[8] == BF16 else 'fp32'}-{c[2][0]}x{c[2][1]}"
            f"s{c[3][0]}p{c[4][0]}{'-act' if c[5] else ''}"
            f"{'-stats' if c[6] else ''}-nb{c[7]}"
            f"{'-bias%+g' % c[9] if c[9] else ''}")


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_port_matches_jax_candidate_tap_interpret(case, jprobe):
    shape, co, kernel, stride, pad, act_in, want_stats, nb, dtype, bs = case
    x, w, sc, bi, sh = _inputs(21, shape, co, kernel, dtype, bs)
    kw = dict(kernel=kernel, stride=stride, pad=pad, act_in=act_in,
              want_stats=want_stats, nb=nb)
    ref = _jax(jprobe.candidate_tap, x, w, sc, bi, sh, dtype, **kw)
    port = _port(x, w, sc, bi, sh, dtype, **kw)
    _hold(port, ref, dtype, want_stats, sh,
          _slack(x, w, sc, bi, act_in, stride, pad))


def test_weight_taps_matches_jax():
    w = np.random.RandomState(3).randn(8, 6, 3, 2).astype(np.float32)
    got = tap.weight_taps(torch.from_numpy(w))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(pcb._weight_taps(jnp.asarray(w))))


def _run_jax_probe(jprobe, monkeypatch):
    """Run the JAX probe's main() eagerly (its jax.jit made the identity)
    with candidate_tap in interpret mode; returns each call's inputs and
    outputs as numpy arrays."""
    calls = []
    real = jprobe.candidate_tap

    def recorder(*args, **kw):
        out = real(*args, **kw)
        calls.append(([np.asarray(a) for a in args],
                      [np.asarray(o) for o in out]))
        return out

    class EagerJax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **_):
            return fn

    monkeypatch.setattr(jprobe, "candidate_tap", recorder)
    monkeypatch.setattr(jprobe, "jax", EagerJax())
    monkeypatch.setattr(sys, "argv", ["scratch_convbn_probe.py"])
    assert jprobe.main() == 0
    return calls


def test_probe_check_mode_reproduces_the_jax_probe(jprobe, monkeypatch):
    jax_calls = _run_jax_probe(jprobe, monkeypatch)
    records, calls = convbn_probe.run_check(torch.device("cpu"))
    assert len(jax_calls) == len(records) == len(convbn_probe.CASES)
    assert calls["candidate_tap"] == len(records)
    for (jin, jout), rec, case in zip(jax_calls, records, convbn_probe.CASES):
        assert rec["ok"], rec["case"]
        for a, t in zip(jin, rec["inputs"]):   # bit for bit
            assert a.shape == tuple(t.shape)
            if t.dtype == torch.bfloat16:
                assert np.array_equal(a.view(np.uint16),
                                      t.view(torch.int16).numpy()
                                      .view(np.uint16))
            else:
                assert np.array_equal(a, t.numpy())
        port = [t.float().numpy() for t in rec["out"]]
        ref = [np.asarray(o, np.float32) for o in jout]
        x, w, sc, bi, sh = (t.float().numpy() for t in rec["inputs"])
        _hold(port, ref, torch.bfloat16, True, sh,
              _slack(x, w, sc, bi, True, case[3], case[4]))
    report = {}
    assert convbn_probe.main(["--device", "cpu"], report) == 0
    assert report["calls"] == {"candidate_tap": 4}


def test_probe_exits_nonzero_when_a_case_fails(monkeypatch):
    real = convbn_probe.oracle
    monkeypatch.setattr(convbn_probe, "oracle",
                        lambda *a: real(*a) + 0.5)
    report = {}
    assert convbn_probe.main(["--device", "cpu"], report) == 1
    assert not any(r["ok"] for r in report["records"])


def test_probe_refuses_what_it_cannot_run():
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            convbn_probe.main([])
    with pytest.raises(SystemExit):
        convbn_probe.main(["--time", "--device", "cpu"])


def test_indivisible_batch_raises_where_jax_leaves_a_tail(jprobe):
    """n=3, nb=2: the JAX grid of n // nb tiles leaves the third image out
    of y and of s1; the port refuses the call."""
    shape, co, kernel = (3, 8, 8, 16), 8, (1, 1)
    x, w, sc, bi, sh = _inputs(5, shape, co, kernel, F32)
    kw = dict(kernel=kernel, stride=(1, 1), pad=(0, 0), act_in=True,
              want_stats=True)
    with pytest.raises(MXNetError, match="nb=2 must divide N=3"):
        _port(x, w, sc, bi, sh, F32, nb=2, **kw)
    _, s1j, _ = _jax(jprobe.candidate_tap, x, w, sc, bi, sh, F32, nb=2, **kw)
    _, s1, _ = _port(x, w, sc, bi, sh, F32, nb=1, **kw)
    assert np.abs(s1j - s1).max() > 1e-2 * np.abs(s1).max()
    for nb in (0, -1):
        with pytest.raises(MXNetError):
            _port(x, w, sc, bi, sh, F32, nb=nb, **kw)


def test_cpu_tensors_never_launch_the_kernel():
    x, w, sc, bi, sh = _inputs(6, (2, 4, 4, 8), 8, (3, 3), F32)
    before = tap.launch_count()
    _port(x, w, sc, bi, sh, F32, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
          act_in=True, want_stats=True, nb=2)
    assert tap.launch_count() == before


@pytest.mark.parametrize("bad", ["float16", "w_dtype", "w_shape", "devices",
                                 "shift", "empty", "stride"])
def test_candidate_tap_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(2, 4, 4, 8)
    w = torch.zeros(1, 1, 8, 8)
    sh = torch.zeros(8)
    kw = dict(kernel=(1, 1), stride=(1, 1), pad=(0, 0), act_in=True,
              want_stats=True, nb=1)
    if bad == "float16":
        x, w = x.half(), w.half()
    elif bad == "w_dtype":
        w = w.bfloat16()
    elif bad == "w_shape":
        w = torch.zeros(1, 1, 4, 8)
    elif bad == "devices":
        w = torch.zeros(1, 1, 8, 8, device="meta")
    elif bad == "shift":
        sh = torch.zeros(4)
    elif bad == "empty":
        kw.update(kernel=(5, 5))
        w = torch.zeros(5, 5, 8, 8)
    elif bad == "stride":
        kw.update(stride=(0, 1))
    with pytest.raises(MXNetError):
        tap.candidate_tap(x, w, torch.ones(8), torch.zeros(8), sh, **kw)


def test_kernel_source_is_built_with_the_others():
    from mxnet_tpu_torch import _kernels

    assert "convbn_tap.cu" in _kernels._SOURCES
    assert (_kernels._SRC_DIR / "convbn_tap.cu").exists()


def test_new_modules_import_no_jax():
    code = ("import mxnet_tpu_torch.tools.convbn_probe, "
            "mxnet_tpu_torch.ops.convbn_tap, sys; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mxnet_tpu.')) or m == 'mxnet_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
