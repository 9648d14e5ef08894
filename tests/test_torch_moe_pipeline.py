"""Expert parallelism (``parallel.moe``) and pipeline parallelism
(``parallel.pipeline``) of the port against the JAX package on the CPU.

The port's mesh cases run in gloo rank processes of this file, started
by ``tests/torch_ranks.py``: two ranks (ep = 2, pp = 2) and four (ep = 4,
dp = 2 x ep = 2, pp = 4, dp = 2 x pp = 2).  The JAX side runs the same
functions on the same mesh shapes over the conftest's virtual CPU
devices.  Inputs are fp32, drawn from numpy seeds in both processes.
Forwards are held within 1e-5 and gradients within 1e-4 of each
tensor's largest magnitude; the gradients are ``jax.grad`` of the JAX
function against ``torch.autograd.grad`` on each rank, of the loss
sum(y * c) (+ sum(gate_probs * c_p) for the MoE).

* ``top1_dispatch`` equal to the JAX package's: the one-hot dispatch and
  ``dropped_frac`` bit for bit, the probabilities and the combine
  weights within the forward tolerance (the two libraries' ``exp``
  differ in the last bit).
* ``moe_apply`` (a tanh expert, T = 32 tokens, D = 8, E = 4, capacity
  factor 1.25) with no mesh, at ep = 2, ep = 4 and dp = 2 x ep = 2: y,
  the gate probabilities, ``dropped_frac`` and the gradients of x, the
  gate logits and the stacked parameters.  Under dp = 2 each rank holds
  its 16 rows: its rows of y and of the x and logit gradients are the
  global ones', and the stacked parameters' gradient summed over the dp
  ranks is the global one.  Both runs also match the JAX test's numpy
  oracle (``tests/test_parallel.py``'s ``_moe_oracle``), and both
  refusals (expert dim against gate width; E over ``ep``) raise the JAX
  package's messages.
* ``pipeline_apply`` (S stages of tanh(x w + b), width 32, batch 16, M
  = 4 microbatches) at pp = 2, pp = 4 and dp = 2 x pp = 2: the forward
  and the gradients of the stacked parameters and of x (under dp = 2,
  per rank rows, the parameters summed over the dp ranks); the pp = 1
  path and the three refusals, with the JAX package's messages.
* ``HeteroPipeline`` on the JAX test's 16 -> 32 -> 8 -> 4 stages, on
  three CPU devices, at M = 1 and M = 4: the forward, the loss and
  every stage's gradients against the JAX package's ``HeteroPipeline``;
  with ``devices=None`` and no CUDA device it raises.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import Groups, jax_free, rank_setup  # noqa: E402

T, D, E, CF = 32, 8, 4, 1.25
S4, B, W, M = 4, 16, 32, 4
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# (name, world, mesh axes): the meshes of the rank processes
MOE_MESHES = [("ep2", 2, dict(ep=2)), ("ep4", 4, dict(ep=4)),
              ("dp2ep2", 4, dict(dp=2, ep=2))]
PIPE_MESHES = [("pp2", 2, dict(pp=2)), ("pp4", 4, dict(pp=4)),
               ("dp2pp2", 4, dict(dp=2, pp=2))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moe_data(e=E):
    rng = np.random.RandomState(5)
    x = rng.randn(T, D).astype(np.float32)
    gl = rng.randn(T, e).astype(np.float32)
    ws = (rng.randn(e, D, D) * 0.3).astype(np.float32)
    cy = rng.randn(T, D).astype(np.float32)
    cp = rng.randn(T, e).astype(np.float32)
    return x, gl, ws, cy, cp


def _pipe_data(s):
    rng = np.random.RandomState(2)
    w = (rng.randn(s, W, W) * 0.1).astype(np.float32)
    b = (rng.randn(s, W) * 0.1).astype(np.float32)
    x = rng.randn(B, W).astype(np.float32)
    c = rng.randn(B, W).astype(np.float32)
    return w, b, x, c


# ---------------------------------------------------------------------------
# the port (ranks and the pytest process)
# ---------------------------------------------------------------------------

def _port_moe(x, gl, ws, cy, cp, mesh=None):
    """y, gate probs, dropped_frac and the gradients of x, the logits and
    the stacked weight, of sum(y * cy) + sum(probs * cp)."""
    from mxnet_tpu_torch.parallel import moe

    x, gl, w = (torch.from_numpy(a).requires_grad_() for a in (x, gl, ws))
    y, aux = moe.moe_apply(lambda p, tok: torch.tanh(tok @ p["w"]),
                           {"w": w}, x, gl, capacity_factor=CF, mesh=mesh)
    loss = (y * torch.from_numpy(cy)).sum() + (
        aux["gate_probs"] * torch.from_numpy(cp)).sum()
    gx, ggl, gw = torch.autograd.grad(loss, (x, gl, w))
    return {"y": y.detach().numpy(),
            "probs": aux["gate_probs"].detach().numpy(),
            "dropped": np.array(float(aux["dropped_frac"])),
            "gx": gx.numpy(), "ggl": ggl.numpy(), "gw": gw.numpy()}


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _port_pipe(w, b, x, c, mesh):
    from mxnet_tpu_torch.parallel import pipeline

    w, b, x = (torch.from_numpy(a).requires_grad_() for a in (w, b, x))
    y = pipeline.pipeline_apply(_stage, {"w": w, "b": b}, x, M, mesh=mesh)
    gw, gb, gx = torch.autograd.grad((y * torch.from_numpy(c)).sum(),
                                     (w, b, x))
    return {"y": y.detach().numpy(), "gw": gw.numpy(), "gb": gb.numpy(),
            "gx": gx.numpy()}


def _message(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is the check
        return str(e)
    return ""


def _rows(a, mesh):
    from mxnet_tpu_torch.parallel import shard_batch

    return shard_batch(torch.from_numpy(a), mesh).numpy().copy()


def _rank_main():
    rank, out_dir = rank_setup()
    from mxnet_tpu_torch import cpu, parallel

    world = parallel.dist.num_workers()
    res = {}
    for name, n, axes in MOE_MESHES:
        if n != world:
            continue
        mesh = parallel.make_mesh(axes, devices=[cpu()] * n)
        x, gl, ws, cy, cp = _moe_data()
        x, gl, cy, cp = (_rows(a, mesh) for a in (x, gl, cy, cp))
        res.update({f"{name}/{k}": v for k, v in
                    _port_moe(x, gl, ws, cy, cp, mesh).items()})
        if name == "ep4":
            res["refuse/ep"] = np.array(_message(
                lambda: _port_moe(*_moe_data(6), mesh=mesh)))
    for name, n, axes in PIPE_MESHES:
        if n != world:
            continue
        mesh = parallel.make_mesh(axes, devices=[cpu()] * n)
        w, b, x, c = _pipe_data(mesh.size("pp"))
        res.update({f"{name}/{k}": v for k, v in _port_pipe(
            w, b, _rows(x, mesh), _rows(c, mesh), mesh).items()})
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the JAX package in the pytest process
# ---------------------------------------------------------------------------

def _jax_moe(x, gl, ws, cy, cp, axes=None):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel import moe

    def f(x, gl, w):
        y, aux = moe.moe_apply(lambda p, tok: jnp.tanh(tok @ p["w"]),
                               {"w": w}, x, gl, capacity_factor=CF)
        return (y * cy).sum() + (aux["gate_probs"] * cp).sum(), (y, aux)

    args = tuple(jnp.asarray(a) for a in (x, gl, ws))
    if axes is None:
        (_, (y, aux)), g = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
            *args)
    else:
        with jpar.make_mesh(**axes):
            (_, (y, aux)), g = jax.value_and_grad(
                f, (0, 1, 2), has_aux=True)(*args)
    return {"y": np.asarray(y), "probs": np.asarray(aux["gate_probs"]),
            "dropped": np.asarray(aux["dropped_frac"]),
            "gx": np.asarray(g[0]), "ggl": np.asarray(g[1]),
            "gw": np.asarray(g[2])}


def _jax_pipe(w, b, x, c, axes):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel import pipeline

    def stage(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    def f(w, b, x):
        y = pipeline.pipeline_apply(stage, {"w": w, "b": b}, x, M)
        return (y * c).sum(), y

    with jpar.make_mesh(**axes):
        (_, y), g = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (w, b, x)))
    return {"y": np.asarray(y), "gw": np.asarray(g[0]),
            "gb": np.asarray(g[1]), "gx": np.asarray(g[2])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: Launched}, each group started when a test first asks for
    it (the two-rank group is done by then: the groups never overlap)."""
    groups = Groups(__file__, tmp_path_factory.mktemp("moe_pipeline"))
    yield groups
    groups.stop()


def _close(got, want, what, grad_keys):
    for k, v in want.items():
        tol = GRAD_TOL if k in grad_keys else FWD_TOL
        assert got[k].shape == v.shape, (what, k)
        np.testing.assert_allclose(
            got[k], v, rtol=0, atol=tol * max(float(np.abs(v).max()), 1e-30),
            err_msg=f"{what}: {k}")


def _ranks_of(group, name):
    out = []
    for res in group.results():
        assert bool(res["jax_free"])
        out.append({k.split("/", 1)[1]: v for k, v in res.items()
                    if k.startswith(name + "/")})
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_top1_dispatch_matches_jax():
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe as jmoe
    from mxnet_tpu_torch.parallel import moe as tmoe

    gl = _moe_data()[1]
    gl[3] = gl[3, 0]  # a tie: the first expert wins in both
    cap = max(1, math.ceil(T / E * CF))
    for c in (cap, 3):  # 3: most tokens over capacity
        want = [np.asarray(a) for a in jmoe.top1_dispatch(jnp.asarray(gl),
                                                           c)]
        got = [a.numpy() for a in tmoe.top1_dispatch(torch.from_numpy(gl),
                                                     c)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        for i in (1, 3):
            np.testing.assert_allclose(got[i], want[i], rtol=0,
                                       atol=FWD_TOL)
        assert got[0][3, 0].sum() == 1.0


def test_moe_without_mesh_matches_jax_and_the_oracle():
    from test_parallel import _moe_oracle

    data = _moe_data()
    got = _port_moe(*data)
    _close(got, _jax_moe(*data), "moe, no mesh", ("gx", "ggl", "gw"))
    x, gl, ws = data[:3]
    ref = _moe_oracle(list(ws), x, gl, max(1, math.ceil(T / E * CF)))
    np.testing.assert_allclose(got["y"], ref, rtol=2e-5, atol=2e-5)
    assert 0.0 < float(got["dropped"]) < 1.0


@pytest.mark.parametrize("name,world,axes", MOE_MESHES)
def test_moe_on_meshes_matches_jax(name, world, axes, ranks):
    group = ranks[world]  # started before the JAX run
    data = _moe_data()
    want = _jax_moe(*data, axes=axes)
    got = _ranks_of(group, name)
    if "dp" not in axes:
        for r, res in enumerate(got):
            _close(res, want, f"{name} rank {r}", ("gx", "ggl", "gw"))
        return
    # dp = 2 x ep = 2: rank r is dp r // 2; its rows, the weight's share
    half = T // 2
    for r, res in enumerate(got):
        rows = slice((r // 2) * half, (r // 2 + 1) * half)
        _close({k: res[k] for k in ("y", "probs", "gx", "ggl")},
               {k: want[k][rows] for k in ("y", "probs", "gx", "ggl")},
               f"{name} rank {r}", ("gx", "ggl"))
        np.testing.assert_array_equal(res["dropped"], want["dropped"])
    for e in range(2):
        _close({"gw": got[e]["gw"] + got[2 + e]["gw"]}, {"gw": want["gw"]},
               f"{name}: the weight's gradient summed over dp", ("gw",))


def test_moe_refusals_match_jax(ranks):
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel import moe as jmoe
    from mxnet_tpu_torch.parallel import moe as tmoe

    x, gl, ws = _moe_data()[:3]
    msgs = []
    for mod, arr in ((jmoe, jnp.asarray), (tmoe, torch.from_numpy)):
        msgs.append(_message(lambda: mod.moe_apply(
            lambda p, t: t, {"w": arr(ws[:3])}, arr(x), arr(gl))))
    assert msgs[0] == msgs[1] == "stacked expert dim 3 != gate width 4"
    x6, gl6, ws6 = _moe_data(6)[:3]
    with jpar.make_mesh(ep=4):
        want = _message(lambda: jmoe.moe_apply(
            lambda p, t: jnp.tanh(t @ p["w"]), {"w": jnp.asarray(ws6)},
            jnp.asarray(x6), jnp.asarray(gl6)))
    assert want == "experts (6) must divide over 'ep' (4)"
    for res in ranks[4].results():
        assert str(res["refuse/ep"]) == want


@pytest.mark.parametrize("name,world,axes", PIPE_MESHES)
def test_pipeline_on_meshes_matches_jax(name, world, axes, ranks):
    group = ranks[world]
    data = _pipe_data(axes["pp"])
    want = _jax_pipe(*data, axes)
    got = _ranks_of(group, name)
    if "dp" not in axes:
        for r, res in enumerate(got):
            _close(res, want, f"{name} rank {r}", ("gw", "gb", "gx"))
        return
    half = B // 2
    for r, res in enumerate(got):
        rows = slice((r // 2) * half, (r // 2 + 1) * half)
        _close({k: res[k] for k in ("y", "gx")},
               {k: want[k][rows] for k in ("y", "gx")},
               f"{name} rank {r}", ("gx",))
    for i in range(2):
        _close({k: got[i][k] + got[2 + i][k] for k in ("gw", "gb")},
               {k: want[k] for k in ("gw", "gb")},
               f"{name}: the stages' gradients summed over dp", ("gw", "gb"))


def test_pipeline_pp1_path_and_refusals_match_jax():
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel import pipeline as jpipe
    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch import parallel as tpar

    w, b, x, c = _pipe_data(1)
    one = tpar.make_mesh(pp=1, devices=[cpu()])
    got = _port_pipe(w, b, x, c, one)
    _close(got, _jax_pipe(w, b, x, c, dict(pp=1)), "pp=1",
           ("gw", "gb", "gx"))
    w2 = _pipe_data(2)[0]

    def calls(mod, arr, mesh):
        p = {"w": arr(w), "b": arr(b)}
        return [lambda: mod.pipeline_apply(_stage, p, arr(x), M, mesh=mesh),
                lambda: mod.pipeline_apply(_stage, {"w": arr(w2)}, arr(x), M,
                                           mesh=mesh),
                lambda: mod.pipeline_apply(_stage, p, arr(x), 3, mesh=mesh)]

    want = [_message(f) for f in calls(jpipe, jnp.asarray, None)[:1]]
    with jpar.make_mesh(pp=1) as jm:
        want += [_message(f) for f in calls(jpipe, jnp.asarray, jm)[1:]]
    got = [_message(calls(tpar.pipeline, torch.from_numpy, None)[0])] + [
        _message(f) for f in calls(tpar.pipeline, torch.from_numpy, one)[1:]]
    assert got == want == [
        "pipeline_apply requires an active mesh",
        "stacked stage dim 2 != mesh 'pp' size 1",
        f"batch {B} not divisible by n_microbatch 3"]


def _hetero_stages(np_mod, nn):
    """The JAX test's three stages over ``np_mod`` (jnp or torch)."""
    rng = np.random.RandomState(0)
    arr = np_mod.asarray if np_mod is not torch else torch.from_numpy
    p0 = {"w": arr((rng.randn(16, 32) * 0.1).astype("float32"))}
    p1 = {"w": arr((rng.randn(32, 8) * 0.1).astype("float32")),
          "b": arr(np.zeros((8,), np.float32))}
    p2 = {"w": arr((rng.randn(8, 4) * 0.1).astype("float32"))}
    fns = [lambda p, a: np_mod.tanh(a @ p["w"]),
           lambda p, a: nn(a @ p["w"] + p["b"]),
           lambda p, a: a @ p["w"]]
    x = rng.randn(8, 16).astype("float32")
    t = rng.randn(8, 4).astype("float32")
    return fns, [p0, p1, p2], x, t


@pytest.mark.parametrize("n_micro", [1, 4])
def test_hetero_pipeline_matches_jax(n_micro):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel.pipeline import HeteroPipeline as JPipe
    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch.parallel import HeteroPipeline

    fns, params, x, t = _hetero_stages(jnp, jax.nn.relu)
    jp = JPipe(fns, params)
    want_y = np.asarray(jp(x, n_microbatch=n_micro))
    want_l, want_g = jp.value_and_grad(
        lambda y, tt: jnp.mean((y - tt) ** 2), x, t, n_microbatch=n_micro)
    fns, params, x, t = _hetero_stages(torch, torch.relu)
    tp = HeteroPipeline(fns, params, devices=[cpu()] * 3)
    got_y = tp(x, n_microbatch=n_micro)
    got_l, got_g = tp.value_and_grad(
        lambda y, tt: torch.mean((y - tt) ** 2), x, t, n_microbatch=n_micro)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=0,
                               atol=FWD_TOL * np.abs(want_y).max())
    np.testing.assert_allclose(got_l, float(want_l), rtol=FWD_TOL)
    for i, (g, wg) in enumerate(zip(got_g, want_g)):
        assert sorted(g) == sorted(wg)
        for k in wg:
            v = np.asarray(wg[k])
            np.testing.assert_allclose(
                g[k].numpy(), v, rtol=0, atol=GRAD_TOL * np.abs(v).max(),
                err_msg=f"stage {i} grad {k}")
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="no silent|there is none"):
            HeteroPipeline(fns, params)


if __name__ == "__main__":
    _rank_main()
