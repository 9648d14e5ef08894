"""Testing utilities, the framework's numeric-verification backbone
(counterpart of ``mxnet_tpu/test_utils.py``; ref:
python/mxnet/test_utils.py): ``assert_almost_equal``,
``check_numeric_gradient`` (finite differences against autograd),
``check_consistency`` (the reference's cpu-against-gpu check, here
``[gpu(0), cpu(0)]``: the card's kernels against their plain versions,
SURVEY.md §4), ``rand_ndarray``, ``default_context``.

Functions accept either a python callable over NDArrays or a
``symbol.Symbol`` (duck-typed), mirroring the reference where these helpers
operate on Symbols.  A Symbol's executor runs outside autograd, so the
gradients these helpers read from a Symbol's inputs are zeros, as in the
JAX package; write ``f`` over NDArrays to check gradients.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import ndarray as nd
from .context import Context, cpu, current_context, gpu
from .ndarray import NDArray

__all__ = [
    "list_gpus",
    "default_context", "set_default_context", "assert_almost_equal",
    "almost_equal", "same", "rand_ndarray", "rand_shape_2d", "rand_shape_3d",
    "rand_shape_nd", "check_numeric_gradient", "check_symbolic_forward",
    "check_symbolic_backward", "check_consistency", "simple_forward",
    "default_rtol_atol",
]

_DEFAULT_CTX: Optional[Context] = None


def list_gpus():
    """ref: test_utils.list_gpus, the CUDA device ordinals this process
    sees (empty without a card), so `if mx.test_utils.list_gpus():`
    gates work."""
    return list(range(torch.cuda.device_count()))


def default_context() -> Context:
    """Test context; override with MXNET_TEST_DEFAULT_CONTEXT=gpu|cpu
    (ref: test_utils.default_context)."""
    if _DEFAULT_CTX is not None:
        return _DEFAULT_CTX
    from .util import env

    name = env.get_str("MXNET_TEST_DEFAULT_CONTEXT")
    if name.startswith("gpu"):
        return gpu()
    if name.startswith("cpu"):
        return cpu()
    return current_context()


def set_default_context(ctx: Context):
    global _DEFAULT_CTX
    _DEFAULT_CTX = ctx


def default_rtol_atol(dtype) -> tuple:
    dt = np.dtype(str(dtype)) if str(dtype) != "bfloat16" else None
    if dt is None or str(dtype) == "bfloat16":
        return 1e-1, 1e-1
    if dt == np.float16:
        return 1e-2, 1e-2
    if dt == np.float32:
        return 1e-4, 1e-5
    return 1e-6, 1e-7


def _as_numpy(x):
    if isinstance(x, NDArray):
        x = x.asnumpy()
    x = np.asarray(x)
    if x.dtype.kind == "V" or "bfloat16" in str(x.dtype):  # ml_dtypes bfloat16
        x = x.astype(np.float32)
    return x


def same(a, b) -> bool:
    return np.array_equal(_as_numpy(a), _as_numpy(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    a, b = _as_numpy(a), _as_numpy(b)
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    return np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """ref: test_utils.assert_almost_equal — with max-violation reporting."""
    a_np, b_np = _as_numpy(a), _as_numpy(b)
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    if a_np.shape != b_np.shape:
        raise AssertionError(
            f"shape mismatch: {names[0]}{a_np.shape} vs {names[1]}{b_np.shape}")
    if np.allclose(a_np, b_np, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    diff = np.abs(a_np.astype(np.float64) - b_np.astype(np.float64))
    denom = np.abs(b_np.astype(np.float64)) + atol / max(rtol, 1e-300)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = diff / np.maximum(denom, 1e-300)
    idx = np.unravel_index(np.nanargmax(rel), rel.shape)
    raise AssertionError(
        f"{names[0]} and {names[1]} differ beyond rtol={rtol} atol={atol}: "
        f"max rel err {rel[idx]:.3e} at {idx}: "
        f"{names[0]}={a_np[idx]!r} {names[1]}={b_np[idx]!r}")


# --------------------------------------------------------------------------
# random data helpers (ref: rand_ndarray / rand_shape_*)
# --------------------------------------------------------------------------

def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, ctx=None, dtype="float32", scale=1.0) -> NDArray:
    data = np.random.uniform(-scale, scale, size=shape)
    return nd.array(data, ctx=ctx or default_context(), dtype=dtype)


# --------------------------------------------------------------------------
# forward/backward runners — accept callable or Symbol
# --------------------------------------------------------------------------

def _is_symbol(f) -> bool:
    return hasattr(f, "list_arguments") and hasattr(f, "bind")


def _normalize_location(f, location):
    """location: list of arrays or dict name->array (Symbol only)."""
    if isinstance(location, dict):
        if not _is_symbol(f):
            raise ValueError("dict locations require a Symbol")
        names = f.list_arguments()
        missing = [n for n in names if n not in location]
        if missing:
            raise KeyError(f"location is missing arguments {missing} "
                           f"required by symbol (has {sorted(location)})")
        return [location[n] for n in names], names
    return list(location), None


def _to_ndarrays(arrays, ctx, dtype=None):
    out = []
    for a in arrays:
        if isinstance(a, NDArray):
            out.append(a.as_in_context(ctx))
        else:
            out.append(nd.array(a, ctx=ctx, dtype=dtype or "float32"))
    return out


def _run_forward(f, args: List[NDArray], train: bool = False):
    """Returns list of output NDArrays."""
    if _is_symbol(f):
        ex = f.bind(args[0].ctx, args)
        outs = ex.forward(is_train=train)
        return list(outs), ex
    out = f(*args)
    if isinstance(out, (tuple, list)):
        return list(out), None
    return [out], None


def simple_forward(f, *inputs, ctx=None):
    """Run ``f`` on numpy/NDArray inputs, return numpy output(s)."""
    ctx = ctx or default_context()
    args = _to_ndarrays(list(inputs), ctx)
    outs, _ = _run_forward(f, args)
    res = [o.asnumpy() for o in outs]
    return res[0] if len(res) == 1 else res


def check_symbolic_forward(f, location, expected, rtol=1e-5, atol=None,
                           ctx=None, dtype="float32"):
    """Forward result vs numpy oracle (ref: check_symbolic_forward)."""
    ctx = ctx or default_context()
    loc, _ = _normalize_location(f, location)
    args = _to_ndarrays(loc, ctx, dtype)
    outs, _ = _run_forward(f, args)
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    for o, e in zip(outs, expected):
        assert_almost_equal(o, e, rtol=rtol, atol=atol,
                            names=("forward", "expected"))


def check_symbolic_backward(f, location, out_grads, expected_grads,
                            rtol=1e-5, atol=None, ctx=None, dtype="float32"):
    """Autograd grads vs analytic expectation (ref: check_symbolic_backward)."""
    from . import autograd

    ctx = ctx or default_context()
    loc, _ = _normalize_location(f, location)
    args = _to_ndarrays(loc, ctx, dtype)
    for a in args:
        a.attach_grad()
    with autograd.record():
        outs, _ = _run_forward(f, args, train=True)
        head = outs[0]
    og = out_grads[0] if isinstance(out_grads, (list, tuple)) else out_grads
    og = og if isinstance(og, NDArray) else nd.array(og, ctx=ctx, dtype=dtype)
    head.backward(og)
    if not isinstance(expected_grads, (list, tuple)):
        expected_grads = [expected_grads]
    for a, e in zip(args, expected_grads):
        if e is None:
            continue
        assert_almost_equal(a.grad, e, rtol=rtol, atol=atol,
                            names=("grad", "expected_grad"))


def check_numeric_gradient(f, location, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, ctx=None, dtype="float32",
                           grad_nodes: Optional[Sequence[int]] = None):
    """Finite-difference gradient check vs the autograd tape.

    ref: test_utils.check_numeric_gradient — central differences on a random
    scalar projection of the output; the single most important correctness
    tool in the reference's test suite (SURVEY.md §4).

    Note: runs in ``dtype`` (default float32; float64 is cast to float32,
    as in the JAX package), so default eps is looser than the
    reference's 1e-4.
    """
    from . import autograd

    ctx = ctx or default_context()
    if str(dtype) == "float64":
        dtype = "float32"  # the JAX package's rule
    loc, _ = _normalize_location(f, location)
    args_np = [np.asarray(a.asnumpy() if isinstance(a, NDArray) else a,
                          dtype=np.float64) for a in loc]
    argnums = list(grad_nodes) if grad_nodes is not None else list(range(len(args_np)))

    # random projection makes the output scalar: L = sum(out * proj)
    args = _to_ndarrays(args_np, ctx, dtype)
    for i in argnums:
        args[i].attach_grad()
    head_outs, _ = _run_forward(f, args)  # un-recorded: only shape is needed
    proj_np = np.random.normal(0, 1.0, size=head_outs[0].shape).astype(dtype)
    proj = nd.array(proj_np, ctx=ctx)
    with autograd.record():
        outs, _ = _run_forward(f, args, train=True)
        loss = (outs[0] * proj).sum()
    loss.backward()
    sym_grads = {i: args[i].grad.asnumpy().astype(np.float64) for i in argnums}

    def _loss_at(vals: List[np.ndarray]) -> float:
        a = _to_ndarrays(vals, ctx, dtype)
        outs, _ = _run_forward(f, a)
        return float((_as_numpy(outs[0]).astype(np.float64) *
                      proj_np.astype(np.float64)).sum())

    for i in argnums:
        num_grad = np.zeros_like(args_np[i])
        flat = args_np[i].reshape(-1)
        num_flat = num_grad.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + numeric_eps
            fp = _loss_at(args_np)
            flat[j] = orig - numeric_eps
            fm = _loss_at(args_np)
            flat[j] = orig
            num_flat[j] = (fp - fm) / (2 * numeric_eps)
        assert_almost_equal(sym_grads[i], num_grad, rtol=rtol,
                            atol=atol if atol is not None else 1e-2,
                            names=(f"autograd_grad[{i}]", f"numeric_grad[{i}]"))


def check_consistency(f, ctx_list: Sequence[Context], location,
                      rtol=1e-4, atol=1e-5, grad: bool = True):
    """Run the same computation on several contexts and compare: the
    reference's cpu-vs-gpu `check_consistency` (ref:
    tests/python/gpu/test_operator_gpu.py pattern).  float64 locations
    run as float32; with ``grad`` the gradients of ``outs[0].sum()``
    in training mode are compared too; the first mismatch raises."""
    from . import autograd

    loc_np = [np.asarray(a.asnumpy() if isinstance(a, NDArray) else a)
              for a in location]
    loc_np = [a.astype(np.float32) if a.dtype == np.float64 else a
              for a in loc_np]
    results, grads = [], []
    for ctx in ctx_list:
        args = [nd.array(a, ctx=ctx) for a in loc_np]
        if grad:
            for a in args:
                if np.issubdtype(a.dtype, np.floating):
                    a.attach_grad()
            with autograd.record():
                outs, _ = _run_forward(f, args, train=True)
                loss = outs[0].sum()
            loss.backward()
            grads.append([a.grad.asnumpy() if a.grad is not None else None
                          for a in args])
        else:
            outs, _ = _run_forward(f, args)
        results.append([_as_numpy(o) for o in outs])
    ref_out, ref_grad = results[0], grads[0] if grad else None
    for k in range(1, len(ctx_list)):
        for a, b in zip(ref_out, results[k]):
            assert_almost_equal(a, b, rtol=rtol, atol=atol,
                                names=(str(ctx_list[0]), str(ctx_list[k])))
        if grad:
            for a, b in zip(ref_grad, grads[k]):
                if a is None or b is None:
                    continue
                assert_almost_equal(a, b, rtol=rtol, atol=atol,
                                    names=(f"{ctx_list[0]}_grad",
                                           f"{ctx_list[k]}_grad"))
