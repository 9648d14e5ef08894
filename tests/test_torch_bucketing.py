"""mod.BucketingModule of mxnet_tpu_torch against the JAX package's, on
the CPU, and the port of examples/rnn_bucketing.py.

* The JAX ``tests/test_module.py::test_bucketing_module`` case (an
  Embedding, the mean over time, a FullyConnected and SoftmaxOutput,
  SGD with momentum) and a tiny LSTM language model over the fused
  ``RNN`` op (Adam): both packages from the same parameters, one step
  per batch over buckets in the order 8, 16, 8, 12 (the default 16),
  and after each step every parameter and every optimizer state held
  within RNN_BWD of (1 + |want|) (``torch_parity``) and the outputs
  within RNN_FWD.  The port binds one module per bucket over the
  default bucket's parameter and gradient arrays, with one updater for
  all of them; ``save_checkpoint`` writes the default bucket's symbol.
* ``python -m mxnet_tpu_torch.examples.rnn_bucketing --cpu --small
  --epochs 1``, over the fused op and with ``--cells``: each finishes
  and prints ``final perplexity=`` below 3.0 and below the perplexity
  of its first logged batches.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.module import BucketingModule as JBucketing

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import BucketingModule as TBucketing

import torch_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, EMB, CLASSES, BATCH = 20, 8, 3, 4
ORDER = (8, 16, 8, 12)


def _pool_gen(m):
    def sym_gen(seq_len):
        data = m.sym.var("data")
        emb = m.sym.Embedding(data, input_dim=VOCAB, output_dim=EMB,
                              name="embed")
        fc = m.sym.FullyConnected(emb.mean(axis=1), num_hidden=CLASSES,
                                  name="fc")
        return m.sym.SoftmaxOutput(fc, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def _lstm_gen(m):
    def sym_gen(seq_len):
        data = m.sym.var("data")
        label = m.sym.var("softmax_label")
        emb = m.sym.Embedding(data, input_dim=VOCAB, output_dim=EMB,
                              name="embed")
        out = m.sym.RNN(m.sym.transpose(emb, axes=(1, 0, 2)), state_size=EMB,
                        num_layers=1, mode="lstm", state_outputs=False,
                        name="lstm")
        out = m.sym.reshape(m.sym.transpose(out, axes=(1, 0, 2)),
                            shape=(-1, EMB))
        pred = m.sym.FullyConnected(out, num_hidden=VOCAB, name="pred")
        sm = m.sym.SoftmaxOutput(pred, m.sym.reshape(label, shape=(-1,)),
                                 name="softmax")
        return sm, ("data",), ("softmax_label",)
    return sym_gen


CASES = {"pool": (_pool_gen, lambda t: (BATCH,), "sgd",
                  {"learning_rate": 0.1, "momentum": 0.9}),
         "lstm": (_lstm_gen, lambda t: (BATCH, t), "adam",
                  {"learning_rate": 0.05})}


def _batches(label_shape, classes):
    rng = np.random.RandomState(0)
    out = []
    for t in ORDER:
        x = rng.randint(0, VOCAB, (BATCH, t)).astype(np.float32)
        y = rng.randint(0, classes, label_shape(t)).astype(np.float32)
        out.append((t, x, y))
    return out


def _flat_states(states):
    out = []

    def walk(s):
        if s is None:
            return
        if isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
        else:
            out.append(s.asnumpy())
    for i in sorted(states):
        walk(states[i])
    return out


def _train(m, cls, ctx, case, arg_params=None):
    gen, label_shape, opt, opt_params = CASES[case]
    mod = cls(gen(m), default_bucket_key=16, context=ctx)
    mod.bind(data_shapes=[m.io.DataDesc("data", (BATCH, 16))],
             label_shapes=[m.io.DataDesc("softmax_label", label_shape(16))])
    mod.init_params(initializer=m.initializer.Xavier(),
                    arg_params=arg_params)
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.init_optimizer(optimizer=opt, optimizer_params=opt_params)
    hist = []
    classes = CLASSES if case == "pool" else VOCAB
    for t, x, y in _batches(label_shape, classes):
        kw = {"ctx": ctx} if m is mt else {}
        batch = m.io.DataBatch(
            data=[m.nd.array(x, **kw)], label=[m.nd.array(y, **kw)],
            bucket_key=t, provide_data=[m.io.DataDesc("data", (BATCH, t))],
            provide_label=[m.io.DataDesc("softmax_label", label_shape(t))])
        mod.forward_backward(batch)
        mod.update()
        hist.append(([o.asnumpy() for o in mod.get_outputs()],
                     {k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                     _flat_states(mod._curr_module._updater.states)))
    return mod, start, hist


@pytest.mark.parametrize("case", sorted(CASES))
def test_bucketing_module_matches_jax_step_by_step(case, tmp_path):
    # each package's symbols are named under a NameManager of their own,
    # so the process-wide node counters stay where they are
    with mx.name.NameManager():
        jmod, start, jhist = _train(mx, JBucketing, mx.cpu(), case)
    with mt.name.NameManager():
        tmod, _, thist = _train(mt, TBucketing, mt.cpu(), case,
                                arg_params=start)
    assert sorted(jmod._buckets) == sorted(tmod._buckets) == [8, 12, 16]
    for step, ((jo, jp, js), (to, tpar, ts)) in enumerate(zip(jhist,
                                                              thist)):
        for a, b in zip(to, jo):
            tp.hold_close(a, b, tp.RNN_FWD, f"step {step} output")
        assert set(tpar) == set(jp)
        for k in jp:
            tp.hold_close(tpar[k], jp[k], tp.RNN_BWD, f"step {step} {k}")
        assert len(ts) == len(js) > 0
        for i, (a, b) in enumerate(zip(ts, js)):
            tp.hold_close(a, b, tp.RNN_BWD, f"step {step} state {i}")
    # one set of arrays and one updater behind every bucket
    default = tmod._buckets[16]
    for key, mod in tmod._buckets.items():
        ex, dex = mod._exec_group.execs[0], default._exec_group.execs[0]
        for n in default._param_names:
            assert ex.arg_dict[n] is dex.arg_dict[n], (key, n)
            assert ex.grad_dict[n] is dex.grad_dict[n], (key, n)
        assert mod._updater is default._updater
    tmod.save_checkpoint(str(tmp_path / "b"), 1)
    with open(tmp_path / "b-symbol.json") as f:
        assert f.read() == default.symbol.tojson()


def _example(*flags):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.rnn_bucketing",
         "--cpu", "--small", "--epochs", "1", *flags],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout + res.stderr


@pytest.mark.parametrize("flags", [(), ("--cells",)])
def test_the_bucketing_example_trains(flags):
    log = _example(*flags)
    first = float(re.search(r"Batch \[\d+\].*perplexity=([0-9.]+)",
                            log).group(1))
    final = float(re.search(r"final perplexity=([0-9.]+)", log).group(1))
    assert "Train-perplexity=" in log
    assert final < first and final < 3.0, (first, final)
