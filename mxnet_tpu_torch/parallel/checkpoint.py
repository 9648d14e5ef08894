"""Checkpoints of ``SPMDTrainer`` (counterpart of
``mxnet_tpu/parallel/checkpoint.py``).

The JAX package writes each host's shards through orbax/tensorstore,
which the port does not have.  The port's format is its own directory:

  ``params.params``     every parameter and buffer of the block by
                        structural name, as a global tensor (the
                        reference ``.params`` format,
                        ``serialization.py``);
  ``opt_state.params``  every optimizer state tensor as a global tensor,
                        as
                        ``<name>:<i>`` (state i of parameter <name>; the
                        fp32 master weight under ``multi_precision`` is
                        the last);
  ``manifest.json``     the format, the step count, the names, shapes
                        and dtypes, the batch shards (``dp``) and the
                        mesh it was written at.

The semantics are the JAX package's: parameters, optimizer state and
the step count are saved; a load restores them into a trainer on any
mesh (another dp size, or fsdp = 2 to dp = 2 or dp = 1, included), and
a checkpoint whose parameter set differs from the model's raises before
anything is written.  Every rank calls both functions: split parameters
and ZeRO state blocks are gathered to global tensors, rank 0 writes,
and every rank reads the files and keeps its own blocks.  A load copies into the trainer's existing tensors, so a
captured step stays valid and replays on the loaded values.
"""
from __future__ import annotations

import json
import os

from ..base import MXNetError
from ..serialization import load_ndarrays, save_ndarrays
from . import dist

__all__ = ["save_sharded", "load_sharded", "FORMAT"]

FORMAT = "mxnet_tpu_torch.spmd_checkpoint/1"


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def save_sharded(path: str, trainer) -> None:
    """Write the trainer's parameters, buffers, optimizer state and step
    count into the directory ``path`` (created; files overwritten)."""
    path = os.path.abspath(path)
    trainer._ensure_blocks()
    params = {n: trainer.value_full(t).cpu() for n, t in trainer._plist}
    states = {}
    for n in trainer._trainable:  # collective under ZeRO: every rank
        for i, s in enumerate(trainer.state_full(n)):
            states[f"{n}:{i}"] = s.detach().cpu()
    if dist.rank() == 0:
        os.makedirs(path, exist_ok=True)
        save_ndarrays(os.path.join(path, "params.params"), params)
        save_ndarrays(os.path.join(path, "opt_state.params"), states)
        manifest = {
            "format": FORMAT, "step": int(trainer._t),
            "dp": int(trainer._shards),
            "mesh": dict(trainer.mesh.axis_sizes),
            "params": {n: [list(t.shape), _dtype_name(t)]
                       for n, t in params.items()},
            "opt_state": {n: len(trainer.opt_state[n])
                          for n in trainer._trainable}}
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    if trainer._world > 1:
        dist.barrier()


def load_sharded(path: str, trainer) -> None:
    """Restore parameters, buffers, optimizer state and the step count
    into ``trainer``, in place, whatever dp size wrote them."""
    path = os.path.abspath(path)
    trainer._ensure_blocks()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise MXNetError(f"not a {FORMAT} checkpoint: {path}")
    names = {n for n, _ in trainer._plist}
    saved = set(manifest["params"])
    if saved != names:
        raise MXNetError(
            "checkpoint parameter set does not match the model: "
            f"missing from checkpoint {sorted(names - saved)}, "
            f"unexpected in checkpoint {sorted(saved - names)}")
    params = load_ndarrays(os.path.join(path, "params.params"))
    states = load_ndarrays(os.path.join(path, "opt_state.params"))
    for n, t in trainer._plist:
        v = params[n]
        shape = trainer.global_shape(t)
        if tuple(v.shape) != shape or v.dtype != t.dtype:
            raise MXNetError(f"checkpoint {n}: {tuple(v.shape)} {v.dtype} "
                             f"where the model has {shape} {t.dtype}")
    for n in trainer._trainable:
        if manifest["opt_state"].get(n) != len(trainer.opt_state[n]):
            raise MXNetError(f"checkpoint {n}: "
                             f"{manifest['opt_state'].get(n)} optimizer "
                             f"states where the optimizer keeps "
                             f"{len(trainer.opt_state[n])}")
    for n, t in trainer._plist:
        trainer.load_value_full(t, params[n].to(t.device))
    for n in trainer._trainable:
        trainer.load_state_full(n, [states[f"{n}:{i}"] for i in
                                    range(len(trainer.opt_state[n]))])
    trainer._t = int(manifest["step"])
