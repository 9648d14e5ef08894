"""The port's launcher (``python -m mxnet_tpu_torch.tools.launch``) and
server role against the JAX package's ``tools/launch.py``.

* ``--launcher local`` with two workers on a tiny script: each worker
  sees the DMLC_* contract (its id, the world size, one root address and
  port), joins a gloo group from it and all-reduces its rank; a worker
  that fails ends the job at once with its exit code, its peer killed.
* ``--dry-run`` for ssh (a hostfile, round-robin), mpi and slurm: the
  same commands as the JAX package's launcher prints.  ``yarn`` raises;
  ``-s`` is accepted and ignored with a note.
* A ``DMLC_ROLE=server`` process parks inside ``import mxnet_tpu_torch``
  instead of running the training script.
"""
import importlib.util
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = '''
import os, sys
import torch
from mxnet_tpu_torch.parallel import dist
out = sys.argv[1]
keys = ("DMLC_ROLE", "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
        "DMLC_NUM_WORKER", "DMLC_WORKER_ID", "DMLC_NUM_SERVER")
env = [os.environ.get(k, "") for k in keys]
if sys.argv[2:] == ["fail"]:
    if env[4] == "1":
        sys.exit(3)
    import time
    time.sleep(120)
dist.init(backend="gloo", timeout=60)
t = torch.tensor([float(dist.rank())])
dist.all_reduce_(t)
with open(os.path.join(out, f"w{env[4]}.txt"), "w") as f:
    f.write(" ".join(env + [str(dist.num_workers()), str(float(t))]))
dist.shutdown()
'''


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in ("DMLC_PS_ROOT_PORT", "DMLC_PS_ROOT_URI", "DMLC_ROLE"):
        env.pop(k, None)
    return env


def _launch(args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"] + args,
        env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=timeout)


def test_local_launch_two_workers(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    r = _launch(["-n", "2", "--launcher", "local", sys.executable,
                 str(script), str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    seen = [(tmp_path / f"w{i}.txt").read_text().split() for i in range(2)]
    ports = {s[2] for s in seen}
    assert len(ports) == 1
    for i, s in enumerate(seen):
        assert s[0] == "worker" and s[1] == "127.0.0.1"
        assert s[3:6] == ["2", str(i), "0"]
        assert s[6] == "2" and float(s[7]) == 1.0


def test_a_failing_worker_ends_the_job(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    t0 = time.monotonic()
    r = _launch(["-n", "2", sys.executable, str(script), str(tmp_path),
                 "fail"], timeout=100)
    assert r.returncode == 3
    assert time.monotonic() - t0 < 90


def _jax_launcher():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_launch", os.path.join(REPO, "tools", "launch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("launcher,extra", [
    ("ssh", ["-H", "HOSTS"]), ("mpi", []), ("slurm", []),
    ("local", ["-s", "2"])])
def test_dry_run_matches_the_jax_launcher(launcher, extra, tmp_path,
                                          monkeypatch, capsys):
    from mxnet_tpu_torch.tools import launch as tlaunch

    hosts = tmp_path / "hosts"
    hosts.write_text("node-a\n# a comment\nnode-b slots=8\n")
    extra = [str(hosts) if a == "HOSTS" else a for a in extra]
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9555")
    monkeypatch.chdir(tmp_path)
    argv = ["-n", "3", "--launcher", launcher] + extra + [
        "--dry-run", "python", "train.py", "--kv-store", "dist_sync"]
    out = []
    for mod in (tlaunch, _jax_launcher()):
        assert mod.main(list(argv)) == 0
        out.append(capsys.readouterr())
    assert out[0].out == out[1].out
    assert out[0].out.count("train.py") == (1 if launcher in ("mpi", "slurm")
                                            else 3)
    if "-s" in extra:
        assert "-s 2 ignored" in out[0].err


def test_yarn_raises(monkeypatch):
    from mxnet_tpu_torch.tools import launch as tlaunch

    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9555")
    with pytest.raises(NotImplementedError, match="yarn"):
        tlaunch.main(["-n", "2", "--launcher", "yarn", "python", "x.py"])


def test_server_role_parks():
    code = (
        "import sys, threading, time\n"
        "def watch():\n"
        "    while 'mxnet_tpu_torch.kvstore_server' not in sys.modules:\n"
        "        time.sleep(0.2)\n"
        "    time.sleep(3)\n"
        "    print('parked', flush=True)\n"
        "threading.Thread(target=watch, daemon=True).start()\n"
        "import mxnet_tpu_torch\n"
        "print('ran the script', flush=True)\n")
    env = dict(_env(), DMLC_ROLE="server")
    p = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        line = p.stdout.readline()
        assert line.strip() == "parked", line
        assert p.poll() is None
    finally:
        p.kill()
        p.communicate()
