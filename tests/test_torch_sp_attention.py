"""Ring and Ulysses sequence-parallel attention of the port at sp = 2,
against the JAX package's on the same mesh.

The port's side runs in two gloo rank processes of this file, started
once by ``tests/torch_ranks.py`` (each rank holds the whole q, k and v,
as the port's ``sp`` ranks hold the same activations outside attention);
the JAX side runs ``ring_attention_sharded`` and
``ulysses_attention_sharded`` under ``make_mesh(sp=2)`` on two of the
conftest's virtual CPU devices, differentiated by ``jax.vjp``.  Inputs
and the cotangent come from numpy seeds.

* Forward and the q/k/v gradients of sum(out * cot), causal and not, by
  ring and by Ulysses: the forward within 1e-5 and each gradient within
  1e-4 of the tensor's largest magnitude (fp32).  A gradient summed over
  the ``sp`` ranks (n-fold) is off by its whole size.
* Ulysses refuses 3 heads at sp = 2 with the JAX package's message.
* The fallback: with no ``sp`` axis (one process, dp = 1) both entries
  are ``local_attention``, which matches the JAX function's at 1e-5.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import WORLD, Launched, jax_free, rank_setup  # noqa: E402

B, H, L, D = 2, 4, 16, 8
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
CASES = [(m, c) for m in ("ring", "ulysses") for c in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, heads=H):
    rs = np.random.RandomState(seed)
    q, k, v, cot = (rs.randn(B, heads, L, D).astype(np.float32)
                    for _ in range(4))
    return q, k, v, cot


# ---------------------------------------------------------------------------
# the rank processes (port only)
# ---------------------------------------------------------------------------

def _rank_main():
    rank, out_dir = rank_setup()
    from mxnet_tpu_torch import cpu, parallel
    from mxnet_tpu_torch.base import MXNetError

    mesh = parallel.make_mesh(sp=WORLD, devices=[cpu()] * WORLD)
    res = {"coord": np.array(mesh.coord("sp")),
           "group": np.array(mesh.group_ranks("sp"))}
    q0, k0, v0, cot = _inputs()
    fns = {"ring": parallel.ring.ring_attention_sharded,
           "ulysses": parallel.ulysses.ulysses_attention_sharded}
    for method, causal in CASES:
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q0, k0, v0))
        with mesh:
            out = fns[method](q, k, v, causal=causal)
        (out * torch.from_numpy(cot)).sum().backward()
        tag = f"{method}/{int(causal)}"
        res[f"{tag}/out"] = out.detach().numpy()
        for n, t in (("dq", q), ("dk", k), ("dv", v)):
            res[f"{tag}/{n}"] = t.grad.numpy()
    q3 = torch.from_numpy(_inputs(heads=3)[0])
    try:
        with mesh:
            parallel.ulysses.ulysses_attention_sharded(q3, q3, q3)
        res["refusal"] = np.array("")
    except MXNetError as e:
        res["refusal"] = np.array(str(e))
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = Launched(__file__, tmp_path_factory.mktemp("sp_attention"))
    yield group
    group.stop()


def _jax_case(method, causal):
    """(out, (dq, dk, dv)) of the JAX entry under make_mesh(sp=2)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar

    q, k, v, cot = (jnp.asarray(a) for a in _inputs())
    fn = (jpar.ring.ring_attention_sharded if method == "ring"
          else jpar.ulysses.ulysses_attention_sharded)
    @jax.jit
    def run(a, b, c, t):
        # the gradient of sum(out * cot) is the vjp of cot: one program
        out, vjp = jax.vjp(lambda x, y, z: fn(x, y, z, causal=causal),
                           a, b, c)
        return out, vjp(t)

    with jpar.make_mesh(sp=WORLD):
        out, grads = run(q, k, v, cot)
    return np.asarray(out), tuple(np.asarray(g) for g in grads)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("method,causal", CASES)
def test_sp2_forward_and_grads_match_jax(method, causal, ranks):
    out, grads = _jax_case(method, causal)
    tag = f"{method}/{int(causal)}"
    for r, res in enumerate(ranks.results()):
        _close(res[f"{tag}/out"], out, FWD_TOL, f"rank {r} {tag} out")
        for n, g in zip(("dq", "dk", "dv"), grads):
            _close(res[f"{tag}/{n}"], g, GRAD_TOL, f"rank {r} {tag} {n}")


def test_sp2_mesh_and_ulysses_refusal(ranks):
    import jax
    from mxnet_tpu import parallel as jpar

    grid = jpar.make_mesh(sp=WORLD).mesh.devices
    devs = jax.devices()
    for r, res in enumerate(ranks.results()):
        assert int(res["coord"]) == int(np.argwhere(grid == devs[r])[0][0])
        assert list(res["group"]) == list(range(WORLD))
        assert str(res["refusal"]) == (
            "ulysses_attention needs heads (3) divisible by the 'sp' axis "
            f"size ({WORLD}); use parallel.ring for few-head models")
        assert bool(res["jax_free"])


def test_without_sp_both_are_local_attention():
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu_torch import cpu, parallel

    q, k, v, _ = _inputs(1)
    with parallel.make_mesh(dp=1, devices=[cpu()]):
        outs = [f(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
                for f in (parallel.ring.ring_attention_sharded,
                          parallel.ulysses.ulysses_attention_sharded)]
    want = np.asarray(jpar.ring.local_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True))
    for o in outs:
        _close(o.numpy(), want, FWD_TOL, "fallback")


if __name__ == "__main__":
    _rank_main()
