"""Distributed job launcher of the port (counterpart of the JAX
package's ``tools/launch.py``; ref: tools/launch.py + dmlc-core tracker).

Starts N worker processes under the reference's DMLC_* environment
contract:

    python -m mxnet_tpu_torch.tools.launch -n 2 python train.py
    python -m mxnet_tpu_torch.tools.launch -n 8 -H hosts --launcher ssh \
        python train.py
    python -m mxnet_tpu_torch.tools.launch -n 8 --launcher mpi python train.py
    python -m mxnet_tpu_torch.tools.launch -n 8 --launcher slurm \
        python train.py

Workers join through ``mxnet_tpu_torch.parallel.dist.init()`` (or
``kvstore.create('dist_sync')``), which maps the DMLC_* variables onto a
``torch.distributed`` process group rendezvousing at worker 0's address
(there is no scheduler process), and sum their gradients with the
group's collectives (there are no parameter-server processes; ``-s`` is
accepted for command-line parity and ignored with a note).

Launchers (the dmlc tracker family):
  local  — N processes on this machine.
  ssh    — one process per hostfile entry over `ssh host env ... cmd`
           (round-robin when n > hosts; worker 0's host serves the
           coordinator address).
  mpi    — delegates process placement to `mpirun`; ranks come from
           OMPI_COMM_WORLD_RANK / PMI_RANK at runtime.
  slurm  — delegates to `srun`; ranks come from SLURM_PROCID.
  yarn   — not supported (raises: start one process per host with the
           DMLC_* contract from your scheduler).

`--dry-run` prints the commands instead of executing (used by tests and
for copy-paste into other schedulers).  A local launch ends the other
workers as soon as one fails, so a dead rank cannot leave its peers
waiting in a collective.
"""
from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import List


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probe_remote_port(host: str, ssh_port: int) -> "str | None":
    """Ask `host` for a free TCP port (the coordinator binds there, not on
    the launch host).  Returns None if the probe fails (no python on the
    remote, ssh restricted, ...) — callers then keep the local guess."""
    try:
        r = subprocess.run(
            ["ssh", "-o", "StrictHostKeyChecking=no", "-o",
             "ConnectTimeout=10", "-p", str(ssh_port), host,
             "python3 -c 'import socket;s=socket.socket();"
             "s.bind((\"\",0));print(s.getsockname()[1])'"],
            capture_output=True, text=True, timeout=30)
        if r.returncode == 0 and r.stdout.strip().isdigit():
            return r.stdout.strip()
    except Exception:
        pass
    print(f"[launch] warning: could not probe a free port on {host}; "
          f"using a port probed locally (set DMLC_PS_ROOT_PORT to pin)",
          file=sys.stderr)
    return None


def _read_hostfile(path: str) -> List[str]:
    hosts = []
    with open(path) as f:
        for line in f:
            h = line.split("#", 1)[0].strip()
            if h:
                hosts.append(h.split()[0])
    if not hosts:
        raise SystemExit(f"hostfile {path} has no hosts")
    return hosts


def _worker_env(i: int, n: int, root_uri: str, port: str,
                num_servers: int) -> dict:
    return {
        "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": root_uri,
        "DMLC_PS_ROOT_PORT": port,
        "DMLC_NUM_WORKER": str(n),
        "DMLC_WORKER_ID": str(i),
        "DMLC_NUM_SERVER": str(num_servers),
    }


def _run_procs(cmds, dry_run: bool) -> int:
    """cmds: list of (argv, extra_env | None).  Runs all and waits; the
    first that fails ends the others, and its code is returned."""
    if dry_run:
        for argv, env in cmds:
            prefix = " ".join(f"{k}={v}" for k, v in (env or {}).items())
            print((prefix + " " if prefix else "") +
                  " ".join(shlex.quote(a) for a in argv))
        return 0
    procs = []
    try:
        for argv, env in cmds:
            full = dict(os.environ)
            full.update(env or {})
            procs.append(subprocess.Popen(argv, env=full))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        return 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Launch a distributed mxnet_tpu_torch job",
        usage="python -m mxnet_tpu_torch.tools.launch [-h] -n NUM_WORKERS [-s NUM_SERVERS] "
              "[--launcher local|ssh|mpi|slurm] [-H HOSTFILE] command ...")
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of worker processes")
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted for reference parity; no server "
                         "processes are spawned (collectives subsume them)")
    ap.add_argument("--launcher", default="local",
                    choices=["local", "ssh", "mpi", "yarn", "slurm"])
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("--ssh-port", type=int, default=22)
    ap.add_argument("--dry-run", action="store_true",
                    help="print the per-worker commands, do not execute")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    if not args.command:
        ap.error("no command given")
    if args.num_servers:
        print("[launch] note: server roles are subsumed by collectives; "
              f"-s {args.num_servers} ignored", file=sys.stderr)
    n = args.num_workers
    port = os.environ.get("DMLC_PS_ROOT_PORT") or str(_free_port())

    if args.launcher == "local":
        cmds = [(list(args.command),
                 _worker_env(i, n, "127.0.0.1", port, args.num_servers))
                for i in range(n)]
        return _run_procs(cmds, args.dry_run)

    if args.launcher == "ssh":
        if not args.hostfile:
            ap.error("--launcher ssh requires -H/--hostfile")
        hosts = _read_hostfile(args.hostfile)
        root = hosts[0]
        if "DMLC_PS_ROOT_PORT" not in os.environ and not args.dry_run:
            # the coordinator binds on hosts[0], not on this launch host,
            # so probe for a free port THERE (the local _free_port()
            # default only checked this machine)
            p = _probe_remote_port(root, args.ssh_port)
            if p is not None:
                port = p
        cwd = os.getcwd()
        cmds = []
        for i in range(n):
            host = hosts[i % len(hosts)]
            env = _worker_env(i, n, root, port, args.num_servers)
            remote = "cd " + shlex.quote(cwd) + " && " + " ".join(
                [f"{k}={shlex.quote(v)}" for k, v in env.items()] +
                [shlex.quote(a) for a in args.command])
            cmds.append((["ssh", "-o", "StrictHostKeyChecking=no",
                          "-p", str(args.ssh_port), host, remote], None))
        return _run_procs(cmds, args.dry_run)

    if args.launcher in ("mpi", "slurm"):
        # one mpirun/srun owns placement; the rank resolves at run time
        # inside the workers (parallel.dist) from OMPI_COMM_WORLD_RANK /
        # PMI_RANK / SLURM_PROCID; the coordinator address is
        # DMLC_PS_ROOT_URI's when the environment gives one (rank 0's
        # node, not this launch host, which may be a login node).
        env = {"DMLC_ROLE": "worker",
               "DMLC_NUM_WORKER": str(n),
               "DMLC_NUM_SERVER": str(args.num_servers)}
        if os.environ.get("DMLC_PS_ROOT_URI"):
            env["DMLC_PS_ROOT_URI"] = os.environ["DMLC_PS_ROOT_URI"]
            if os.environ.get("DMLC_PS_ROOT_PORT"):
                env["DMLC_PS_ROOT_PORT"] = port
            else:
                # `port` was probed on THIS (login) node — meaningless on
                # the coordinator node; let dist.init use its documented
                # default (9091) there instead of a random local guess
                print("[launch] note: DMLC_PS_ROOT_URI set without "
                      "DMLC_PS_ROOT_PORT; workers will use the default "
                      "port 9091 on the coordinator (set "
                      "DMLC_PS_ROOT_PORT to pin)", file=sys.stderr)
        # `env K=V ... cmd` as the launched command: portable across
        # Open MPI and MPICH/Hydra (no -x / -genv flag differences)
        env_prefix = ["env"] + [f"{k}={v}" for k, v in env.items()]
        if args.launcher == "mpi":
            cmds = [(["mpirun", "-n", str(n)] + env_prefix +
                     list(args.command), None)]
        else:
            cmds = [(["srun", f"--ntasks={n}"] + env_prefix +
                     list(args.command), None)]
        return _run_procs(cmds, args.dry_run)

    raise NotImplementedError(
        "launcher 'yarn' is not supported: start one process per host "
        "with DMLC_PS_ROOT_URI/DMLC_PS_ROOT_PORT/DMLC_NUM_WORKER/"
        "DMLC_WORKER_ID set (see mxnet_tpu_torch.parallel.dist)")


if __name__ == "__main__":
    sys.exit(main())
