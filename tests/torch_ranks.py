"""Rank processes of a test file, started by the port's launcher.

``Launched(script, out_dir, world=2)`` runs ``python
mxnet_tpu_torch/tools/launch.py -n <world> --launcher local python
<script> <out_dir> [args]`` (the launcher by its
path, so it imports no torch) in a session of its own: each rank reads
its rank from ``DMLC_WORKER_ID``, joins a gloo group
(``parallel.dist.init(backend="gloo")``) through the ``DMLC_*`` contract
the launcher sets, and writes ``rank<r>.npz`` into ``out_dir``.
``results()`` waits for the launcher (which ends every rank when one
fails), fails the test with the ranks' output when it does not exit 0 in
``timeout`` seconds, and returns each rank's arrays.  ``Groups`` starts
a file's groups of several world sizes, each on first use.  The ranks
import neither jax nor mxnet_tpu; :func:`jax_free` gives them the
check.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


class Launched:
    def __init__(self, script, out_dir, timeout=240.0, world=WORLD,
                 args=()):
        self.dir = str(out_dir)
        self.timeout = timeout
        self.world = world
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        for k in ("DMLC_PS_ROOT_PORT", "DMLC_PS_ROOT_URI", "DMLC_ROLE"):
            env.pop(k, None)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "mxnet_tpu_torch", "tools",
                                          "launch.py"), "-n",
             str(world), "--launcher", "local", sys.executable,
             os.path.abspath(script), self.dir, *args],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self._res = None

    def stop(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()

    def results(self):
        if self._res is not None:
            return self._res
        try:
            out = self.proc.communicate(timeout=self.timeout)[0]
        except subprocess.TimeoutExpired:
            self.stop()
            pytest.fail(f"ranks still running after {self.timeout} s")
        if self.proc.returncode != 0:
            pytest.fail(f"ranks exit {self.proc.returncode}:\n{out[-4000:]}")
        self._res = [dict(np.load(os.path.join(self.dir, f"rank{r}.npz"),
                                  allow_pickle=False))
                     for r in range(self.world)]
        return self._res


class Groups(dict):
    """``Launched`` groups of ``script`` by world size, each started on
    first use (``groups[world]``) into ``base/w<world>``; a test that
    reads one group's results before asking for the next keeps the
    groups from running at once."""

    def __init__(self, script, base):
        super().__init__()
        self.script, self.base = script, base

    def __missing__(self, world):
        d = os.path.join(str(self.base), f"w{world}")
        os.makedirs(d)
        self[world] = Launched(self.script, d, world=world)
        return self[world]

    def stop(self):
        for g in self.values():
            g.stop()


def jax_free() -> bool:
    """Whether this process has loaded neither jax nor mxnet_tpu."""
    return not any(m == "jax" or m.startswith(("jax.", "mxnet_tpu."))
                   or m == "mxnet_tpu" for m in sys.modules)


def rank_setup():
    """(rank, out_dir) of a rank process, its group joined (gloo)."""
    import torch

    torch.set_num_threads(1)
    from mxnet_tpu_torch.parallel import dist

    dist.init(backend="gloo", timeout=120)
    return dist.rank(), sys.argv[1]
