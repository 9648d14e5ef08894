"""Meshes over every axis and SPMDTrainer with sharded parameters, in the
port, against the JAX package on the CPU.

The port's side runs in two gloo rank processes of this file, started
once by ``tests/torch_ranks.py``; the JAX side uses two of the conftest's
virtual CPU devices on the same mesh shapes.  The net is
``bench_all.py``'s config-3 BERT step at its ``--cpu-smoke`` size (2
layers, 64 units, 4 heads, vocab 1000, batch 2 x 32 tokens; the JAX
``Step`` from ``test_torch_bert_train``), dropout 0, Adam (lr 1e-3, wd
1e-2), from the JAX block's ``Normal(0.02)`` weights carried across by
structural name.

* Mesh positions: rank r of ``make_mesh(dp=2)``, ``fsdp=2``, ``tp=2`` and
  ``sp=2`` sits where the JAX mesh puts device r, and its group holds the
  ranks the JAX mesh lines up along the axis.
* ``spec_for`` of every parameter of the BERT step and of the
  long-context LM, matched by each parameter's MXNet name
  (``gluon.block.mx_param_names``), equals the JAX package's for its
  counterpart on ``fsdp=2`` (DEFAULT_RULES, and the fsdp fallback at
  ``fsdp_min_size=64``) and on ``tp=2``; the trainer splits exactly the
  tensors the JAX trainer shards.
* Three steps at fsdp = 2 (the fallback at 64: nearly every tensor
  split) and at tp = 2 (DEFAULT_RULES: q/k/v and the embeddings split):
  losses within 1e-5 relative, each parameter within 1e-4 of its largest
  magnitude plus 2e-2 * lr, each Adam moment within 1e-4 of the largest
  moment of its kind over all tensors (the attention key biases'
  gradients are 0 but for rounding, and Adam turns that noise into
  steps of about 1e-2 * lr), against the JAX trainer on the same
  mesh and against the port's dp = 1 run.  A gradient summed over the tp
  ranks (n-fold) moves the Adam moments by their whole size.
* ``forward`` at dp = 2 returns the global batch, within 1e-5 of the
  largest magnitude of the dp = 1 forward.
* A checkpoint written at fsdp = 2 after step 2 resumes at dp = 2 (the
  ranks) and at dp = 1 (this process) to the uninterrupted run's step 3,
  at the training tolerances.
* ``sync_to_block`` puts the global tensors back in the block and the
  next step cuts them again; ``named_sharding(...).block``/``gather``
  cut and rebuild a rank's block, ``replicated`` splits nothing and
  ``constraint`` returns its value; ``parallel.moe`` and ``pipeline``
  export the JAX modules' names (``moe_apply``, ``pipeline_apply``,
  ``stack_stage_params``, ``HeteroPipeline`` among them, also on
  ``parallel``), and ``stack_stage_params`` stacks as the JAX one does.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import WORLD, Launched, jax_free, rank_setup  # noqa: E402

SIZE = "cpu_smoke"
OPT = {"learning_rate": 1e-3, "wd": 1e-2}
STEPS, CKPT_AT = 3, 2
LM_W = dict(units=16, heads=4, vocab=64, layers=2)
AXES = ("dp", "fsdp", "tp", "sp")
# (mesh axis, fsdp_min_size of the rules; None: DEFAULT_RULES)
SPEC_CASES = [("fsdp", None), ("fsdp", 64), ("tp", None)]
TRAIN_CASES = [("fsdp", 64), ("tp", None)]
LOSS_RTOL, FWD_TOL, W_TOL, STATE_TOL = 1e-5, 1e-5, 1e-4, 1e-4
TIED = "bert.mlm_decoder.embed_weight"  # trained as bert.word_embed.weight
# the attention key biases' gradients are 0 but for rounding (|g| about
# 1e-10, under Adam's eps of 1e-8), so each step moves them by about
# lr * g / eps, a different 1e-5 in each reduction order: a parameter is
# held within W_TOL of its largest magnitude plus LR_NOISE * lr
LR_NOISE = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rules(sharding, min_size):
    base = sharding.DEFAULT_RULES
    if min_size is None:
        return base
    return sharding.ShardingRules([(p.pattern, s) for p, s in base.rules],
                                  fsdp_min_size=min_size)


def _spec_key(spec):
    return repr(tuple(tuple(e) if isinstance(e, list) else e for e in spec))


# ---------------------------------------------------------------------------
# the rank processes (port only)
# ---------------------------------------------------------------------------

def _port_step(w0, mesh, rules):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs
    from mxnet_tpu_torch.gluon import load_numpy_params

    step = bs.bert_step(SIZE, dropout=0.0)
    step.initialize(ctx=mt.cpu())
    load_numpy_params(step, w0)
    return parallel.SPMDTrainer(step, bs.Identity(), "adam", dict(OPT),
                                mesh=mesh, rules=rules, n_labels=0)


def _record(tr, losses):
    """Losses, parameters and Adam moments as global tensors (a
    collective: every rank calls it)."""
    out = {"losses": np.array(losses)}
    for n, t in tr.block.state_dict(keep_vars=True).items():
        out[f"w/{n}"] = tr.value_full(t).numpy().copy()
    for n in tr.opt_state:
        for i, s in enumerate(tr.state_full(n)):
            out[f"s{i}/{n}"] = s.numpy().copy()
    return out


def _steps(tr, n, batch, save=None):
    losses = []
    for i in range(n):
        losses.append(float(tr.step(*batch)))
        if save is not None and i + 1 == CKPT_AT:
            tr.save_checkpoint(save)
    return losses


def _rank_main():
    rank, out_dir = rank_setup()
    from mxnet_tpu_torch import cpu, parallel
    from mxnet_tpu_torch.examples import bench_steps as bs
    from mxnet_tpu_torch.examples import long_context_lm as lm
    from mxnet_tpu_torch.gluon.block import mx_param_names
    from mxnet_tpu_torch.parallel import sharding as tsh

    devs = [cpu()] * WORLD
    w = np.load(os.path.join(out_dir, "weights.npz"))
    w0 = {k: w[k] for k in w.files}
    res = {}

    def put(tag, rec):
        res.update({f"{tag}/{k}": v for k, v in rec.items()})

    for ax in AXES:
        m = parallel.make_mesh({ax: WORLD}, devices=devs)
        res[f"coord/{ax}"] = np.array(m.coord(ax))
        res[f"group/{ax}"] = np.array(m.group_ranks(ax))
    for ax, size in SPEC_CASES:
        mesh = parallel.make_mesh({ax: WORLD}, devices=devs)
        rules = _rules(tsh, size)
        for model, net in (("bert", bs.bert_step(SIZE, dropout=0.0)),
                           ("lm", lm.LM("ring", **LM_W))):
            names = mx_param_names(net)
            for n, p in net.state_dict(keep_vars=True).items():
                res[f"spec/{ax}{size}/{model}/{n}"] = np.array(_spec_key(
                    rules.spec_for(names[n], tuple(p.shape), mesh)))
    batch = bs.bert_batch(SIZE, ctx=cpu())
    ckpt = os.path.join(out_dir, "ckpt_fsdp2")
    for ax, size in TRAIN_CASES:
        mesh = parallel.make_mesh({ax: WORLD}, devices=devs)
        tr = _port_step(w0, mesh, _rules(tsh, size))
        res[f"split/{ax}"] = np.array(sorted(tr._specs))
        res[f"block_numel/{ax}"] = np.array(
            [tr.params[n].numel() * WORLD == np.prod(tr._shapes[n])
             for n in sorted(tr._specs)])
        put(f"train/{ax}", _record(tr, _steps(
            tr, STEPS, batch, ckpt if ax == "fsdp" else None)))
    # sync_to_block puts the global tensors back; the next step cuts them
    tr.sync_to_block()
    res["synced_whole"] = np.array(all(
        tuple(tr.params[n].shape) == tr._shapes[n] for n in tr._specs))
    tr.step(*batch)
    res["cut_again"] = np.array(all(
        tr.params[n].numel() * WORLD == np.prod(tr._shapes[n])
        for n in tr._specs))
    # a sharding is the descriptor of this rank's block
    x = torch.arange(24.0).reshape(4, 6)
    sh = tsh.named_sharding(tsh.P(ax, None), mesh)
    res["sharding"] = np.array([
        torch.equal(sh.block(x), x[2 * rank:2 * rank + 2]),
        torch.equal(sh.gather(sh.block(x)), x),
        not sh.is_fully_replicated,
        tsh.replicated(mesh).is_fully_replicated,
        tsh.constraint(x, tsh.P(ax)) is x])
    dp2 = parallel.make_mesh(dp=WORLD, devices=devs)
    tr = _port_step(w0, dp2, tsh.DEFAULT_RULES)
    tr.load_checkpoint(ckpt)
    put("resume/dp2", _record(tr, _steps(tr, STEPS - CKPT_AT, batch)))
    bert = _port_step(w0, parallel.make_mesh(dp=1, devices=[cpu()]),
                      tsh.DEFAULT_RULES).block.bert
    tr = parallel.SPMDTrainer(bert, bs.Identity(), "adam", dict(OPT),
                              mesh=dp2, n_labels=0)
    seq, pooled = tr.forward(*batch[:3])
    res["forward/seq"], res["forward/pooled"] = seq.numpy(), pooled.numpy()
    res["jax_free"] = np.array(jax_free())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the JAX package and the port's dp = 1 in the pytest process
# ---------------------------------------------------------------------------

def _jax_step():
    """The JAX config-3 step, initialised and warmed (its structural
    parameter names are the port's)."""
    import mxnet_tpu as mx
    from mxnet_tpu_torch.examples import bench_steps as bs
    from test_torch_bert_train import JaxBertStep

    cfg = bs.BERT_SIZES[SIZE]
    np.random.seed(0)
    mx.random.seed(0)
    net = JaxBertStep(cfg["vocab"], dropout=0.0, **cfg["model"])
    net.initialize(mx.initializer.Normal(0.02), ctx=mx.cpu())
    with mx.autograd.pause():
        seq, pooled = net.bert(*(mx.nd.array(a, ctx=mx.cpu())
                                 for a in bs.bert_batch(SIZE)[:3]))
        net.bert.decode_mlm(seq)
        net.bert.classify_nsp(pooled)
    return net


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_trainer")
    net = _jax_step()
    w0 = {k: p.data().asnumpy().copy()
          for k, p in net._collect_params_with_prefix().items()}
    np.savez(d / "weights.npz", **w0)
    group = Launched(__file__, d)
    yield d, w0, net, group
    group.stop()


@pytest.fixture(scope="module")
def jax_runs(setup):
    """{axis: (record, names of the sharded parameters)} of three JAX
    SPMDTrainer steps on make_mesh({axis: 2})."""
    import mxnet_tpu as mx
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel import sharding as jsh
    from mxnet_tpu_torch.examples import bench_steps as bs

    _, w0, net, _ = setup
    params = net._collect_params_with_prefix()
    batch = bs.bert_batch(SIZE)
    out = {}
    for ax, size in TRAIN_CASES:
        for k, p in params.items():
            p.set_data(mx.nd.array(w0[k]))
        with jpar.make_mesh({ax: WORLD}):
            tr = jpar.SPMDTrainer(net, bs.Identity(), "adam", dict(OPT),
                                  rules=_rules(jsh, size), n_labels=0)
            losses = [float(tr.step(*batch).asnumpy())
                      for _ in range(STEPS)]
        rec = {"losses": np.array(losses)}
        for k, p in params.items():
            rec[f"w/{k}"] = np.asarray(tr.params[p.name])
            if p.name in tr.opt_state and k != TIED:
                for i, s in enumerate(tr.opt_state[p.name]):
                    rec[f"s{i}/{k}"] = np.asarray(s)
        split = sorted(k for k, p in params.items()
                       if not tr._shardings[p.name].is_fully_replicated)
        out[ax] = (rec, split)
    return out


@pytest.fixture(scope="module")
def port_dp1(setup):
    """The port's dp = 1 run (3 steps) and its resume of the fsdp = 2
    checkpoint."""
    from mxnet_tpu_torch import cpu, parallel
    from mxnet_tpu_torch.examples import bench_steps as bs
    from mxnet_tpu_torch.parallel import sharding as tsh

    d, w0, _, group = setup
    one = parallel.make_mesh(dp=1, devices=[cpu()])
    batch = bs.bert_batch(SIZE, ctx=cpu())
    tr = _port_step(w0, one, tsh.DEFAULT_RULES)
    run = _record(tr, _steps(tr, STEPS, batch))
    group.results()  # the checkpoint is written
    tr = _port_step(w0, one, tsh.DEFAULT_RULES)
    tr.load_checkpoint(str(d / "ckpt_fsdp2"))
    resumed = _record(tr, _steps(tr, STEPS - CKPT_AT, batch))
    return run, resumed


def _sub(res, tag):
    return {k[len(tag) + 1:]: v for k, v in res.items()
            if k.startswith(tag + "/")}


def _close_run(got, want, what, tail=False):
    """The training tolerances of the module docstring; with ``tail``
    only the losses after the checkpoint are held."""
    wl = want["losses"][CKPT_AT:] if tail else want["losses"]
    np.testing.assert_allclose(got["losses"], wl, rtol=LOSS_RTOL,
                               err_msg=what)
    states = [k for k in want if k.startswith("s")]
    assert sorted(k for k in got if k.startswith("w/")) == sorted(
        k for k in want if k.startswith("w/")), what
    assert set(got) >= set(states), what
    scale = {i: max(float(np.abs(want[k]).max()) for k in states
                    if k.startswith(f"s{i}/")) for i in (0, 1)}
    for k, v in want.items():
        if k == "losses":
            continue
        if k.startswith("w/"):
            atol = W_TOL * float(np.abs(v).max()) + LR_NOISE * \
                OPT["learning_rate"]
        else:
            atol = STATE_TOL * scale[int(k[1])]
        np.testing.assert_allclose(got[k], v, rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_mesh_positions_and_groups_match_jax(setup):
    import jax
    from mxnet_tpu import parallel as jpar

    devs = jax.devices()
    for ax in AXES:
        grid = jpar.make_mesh({ax: WORLD}).mesh.devices
        for r, res in enumerate(setup[3].results()):
            assert int(res[f"coord/{ax}"]) == int(
                np.argwhere(grid == devs[r])[0][0]), (ax, r)
            assert list(res[f"group/{ax}"]) == list(range(WORLD))


@pytest.mark.parametrize("ax,size", SPEC_CASES)
@pytest.mark.parametrize("model", ["bert", "lm"])
def test_spec_for_matches_jax(ax, size, model, setup):
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel import sharding as jsh
    from torch_lm_jax import jax_lm

    net = setup[2] if model == "bert" else jax_lm("ring", **LM_W)
    mesh = jpar.make_mesh({ax: WORLD})
    rules = _rules(jsh, size)
    want = {k: _spec_key(rules.spec_for(p.name, p.shape, mesh))
            for k, p in net._collect_params_with_prefix().items()}
    for res in setup[3].results():
        got = {k.split("/", 3)[3]: str(v) for k, v in res.items()
               if k.startswith(f"spec/{ax}{size}/{model}/")}
        assert got == want
    # something is split, but for the narrow LM's tensors, all under the
    # default fsdp_min_size
    assert any("'" in v for v in want.values()) or (
        model, ax, size) == ("lm", "fsdp", None)


@pytest.mark.parametrize("ax,size", TRAIN_CASES)
def test_sharded_steps_match_jax_and_dp1(ax, size, setup, jax_runs,
                                         port_dp1):
    jrec, jsplit = jax_runs[ax]
    results = setup[3].results()
    for r, res in enumerate(results):
        got = _sub(res, f"train/{ax}")
        _close_run(got, jrec, f"rank {r} {ax}=2 vs JAX {ax}=2")
        _close_run(got, port_dp1[0], f"rank {r} {ax}=2 vs port dp=1")
        assert sorted(res[f"split/{ax}"]) == [n for n in jsplit
                                              if n != TIED]
        assert bool(np.all(res[f"block_numel/{ax}"]))
    assert len(jsplit) > 5


def test_forward_dp2_is_the_global_batch_of_dp1(setup):
    from mxnet_tpu_torch import cpu, parallel
    from mxnet_tpu_torch.examples import bench_steps as bs
    from mxnet_tpu_torch.parallel import sharding as tsh

    w0 = setup[1]
    tr = _port_step(w0, parallel.make_mesh(dp=1, devices=[cpu()]),
                    tsh.DEFAULT_RULES)
    one = parallel.SPMDTrainer(tr.block.bert, bs.Identity(), "adam",
                               dict(OPT),
                               mesh=parallel.make_mesh(dp=1, devices=[cpu()]),
                               n_labels=0)
    seq, pooled = one.forward(*bs.bert_batch(SIZE, ctx=cpu())[:3])
    for res in setup[3].results():
        for got, want in ((res["forward/seq"], seq.numpy()),
                          (res["forward/pooled"], pooled.numpy())):
            assert got.shape == want.shape
            np.testing.assert_allclose(
                got, want, rtol=0, atol=FWD_TOL * float(np.abs(want).max()))
        assert bool(res["jax_free"])


def test_sync_to_block_shardings_and_queued_names(setup):
    from mxnet_tpu_torch import parallel

    for res in setup[3].results():
        assert bool(res["synced_whole"]) and bool(res["cut_again"])
        assert bool(np.all(res["sharding"]))
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar

    # the formerly queued names are the JAX package's modules and
    # functions, and stack_stage_params stacks as the JAX one does
    for mod in ("moe", "pipeline"):
        assert getattr(parallel, mod).__all__ == getattr(jpar, mod).__all__
    for mod, name in (("moe", "moe_apply"), ("pipeline", "pipeline_apply"),
                      ("pipeline", "stack_stage_params"),
                      ("pipeline", "HeteroPipeline")):
        assert getattr(parallel, name) is getattr(getattr(parallel, mod),
                                                  name)
    rng = np.random.RandomState(3)
    stages = [{"w": rng.randn(2, 3).astype(np.float32),
               "b": rng.randn(3).astype(np.float32)} for _ in range(4)]
    want = jpar.pipeline.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in s_.items()} for s_ in stages])
    got = parallel.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s_.items()} for s_ in stages])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_checkpoint_fsdp2_resumes_at_dp2_and_dp1(setup, port_dp1):
    run, resumed = port_dp1
    for r, res in enumerate(setup[3].results()):
        uninterrupted = _sub(res, "train/fsdp")
        _close_run(_sub(res, "resume/dp2"), uninterrupted,
                   f"rank {r}: fsdp=2 -> dp=2", tail=True)
        _close_run(resumed, uninterrupted, "fsdp=2 -> dp=1", tail=True)


if __name__ == "__main__":
    _rank_main()
