"""Model export for serving (counterpart of ``mxnet_tpu/contrib/deploy.py``).

Difference from the JAX package: its artifact's program is StableHLO
(``model.stablehlo``), which PyTorch cannot run.  The port's artifact
records the zoo architecture in its place — name, constructor kwargs and
dtype in ``meta.json["arch"]`` — and ``import_model`` rebuilds that
network, loads the weights and runs it hybridized in eval mode.  The
weights ride in ``model.params`` in the reference byte format under the
structural names, and ``meta.json`` keeps the JAX artifact's keys
(``inputs``, ``dynamic_batch``, ``outputs``, ``param_order``,
``n_outputs``).  So an artifact needs the port's model code, where a JAX
artifact does not.

Artifact layout (a directory):
    model.params      the block's parameters, reference .params format
    meta.json         architecture, input shapes/dtypes, param order,
                      output shapes

    from mxnet_tpu_torch.contrib import deploy
    deploy.export_model(net, "deploy_dir", [x])   # x: a torch tensor
    served = deploy.import_model("deploy_dir")    # on gpu(0)
    y = served(x)
"""
from __future__ import annotations

import json
import os
from typing import List, Sequence

import torch

from .. import context as _context
from ..base import MXNetError
from ..gluon.block import dtype_of, load_numpy_params

__all__ = ["export_model", "import_model", "ServedModel", "FORMAT"]

FORMAT = "mxnet_tpu_torch.deploy/1"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _leaves(out) -> List[torch.Tensor]:
    """A forward's outputs as a list: one tensor, or a tuple/list of them."""
    leaves = [out] if isinstance(out, torch.Tensor) else list(out)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise MXNetError("export_model: outputs must be tensors or a "
                         "tuple of tensors")
    return leaves


def export_model(block, path: str, example_inputs: Sequence,
                 dynamic_batch: bool = False) -> str:
    """Write the artifact directory of a zoo network and return ``path``.

    ``example_inputs`` fix the input shapes and dtypes (dim 0 becomes the
    free batch dim when ``dynamic_batch``); one eval-mode forward on them
    records the output shapes."""
    arch = getattr(block, "_arch", None)
    if arch is None:
        raise MXNetError("export_model: the port exports model-zoo networks "
                         "only (the block carries no architecture record)")
    params = block.collect_params()
    if not params:
        raise MXNetError("export_model: block has no parameters")
    xs = [_as_tensor(x) for x in example_inputs]
    if any(x.dim() == 0 for x in xs):
        raise MXNetError("export_model: every input needs a batch dim")
    dev = next(iter(params.values())).device
    was_training = block.training
    block.eval()
    try:
        with torch.inference_mode():
            out = block(*[x.to(dev) for x in xs])
    finally:
        block.train(was_training)
    leaves = _leaves(out)
    weight_dtype = next(t.dtype for k, t in params.items()
                        if k.endswith("weight"))
    os.makedirs(path, exist_ok=True)
    from ..serialization import save_ndarrays

    save_ndarrays(os.path.join(path, "model.params"),
                  {k: v.detach().cpu() for k, v in params.items()})
    meta = {
        "format": FORMAT,
        "arch": {"name": arch["name"], "kwargs": arch["kwargs"],
                 "dtype": _dtype_name(weight_dtype)},
        "param_order": list(params),
        "param_shapes": {k: list(v.shape) for k, v in params.items()},
        "param_dtypes": {k: _dtype_name(v.dtype) for k, v in params.items()},
        "inputs": [{"shape": ([None] + list(x.shape[1:]))
                    if dynamic_batch else list(x.shape),
                    "dtype": _dtype_name(x.dtype)} for x in xs],
        "dynamic_batch": bool(dynamic_batch),
        "n_outputs": len(leaves),
        "outputs": [{"shape": (["b"] + list(o.shape[1:]))
                     if dynamic_batch else list(o.shape),
                     "dtype": _dtype_name(o.dtype)} for o in leaves],
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


class ServedModel:
    """A reloaded artifact: the rebuilt network, hybridized, in eval mode,
    on one device.  Tensors in, tensors out."""

    def __init__(self, net, meta: dict, device: torch.device):
        self.net = net
        self._meta = meta
        self.device = device

    @property
    def meta(self) -> dict:
        return dict(self._meta)

    def decode_outputs(self, leaves):
        """The forward's output structure: one tensor, or a tuple."""
        return leaves[0] if len(leaves) == 1 else tuple(leaves)

    def check_inputs(self, inputs) -> List[torch.Tensor]:
        want = self._meta["inputs"]
        if len(inputs) != len(want):
            raise MXNetError(f"artifact takes {len(want)} inputs, got "
                             f"{len(inputs)}")
        xs = []
        for x, w in zip(inputs, want):
            v = _as_tensor(x)
            got_s, want_s = list(v.shape), w["shape"]
            if len(got_s) != len(want_s) or any(
                    ws is not None and gs != ws
                    for gs, ws in zip(got_s, want_s)):
                raise MXNetError(f"input shape {got_s} != exported {want_s} "
                                 "(None = free batch dim)")
            if _dtype_name(v.dtype) != w["dtype"]:
                raise MXNetError(f"input dtype {_dtype_name(v.dtype)} != "
                                 f"exported {w['dtype']}")
            xs.append(v)
        return xs

    def run(self, xs) -> list:
        """Flat output leaves for already-checked inputs."""
        with torch.inference_mode():
            out = self.net(*[x.to(self.device, non_blocking=True)
                             for x in xs])
        return _leaves(out)

    def __call__(self, *inputs):
        return self.decode_outputs(self.run(self.check_inputs(inputs)))


def import_model(path: str, ctx=None) -> ServedModel:
    """Rebuild an artifact directory's network on ``ctx`` (default
    gpu(0); raises without CUDA unless cpu() is passed)."""
    from ..gluon.model_zoo import vision
    from ..serialization import load_ndarrays

    device = _context.resolve(ctx)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise MXNetError(f"not a {FORMAT} artifact: {path}")
    arch = meta["arch"]
    net = vision.build(arch)
    net.cast(dtype_of(arch["dtype"]))
    values = load_ndarrays(os.path.join(path, "model.params"))
    load_numpy_params(net, values)
    net.to(device)
    net.hybridize()
    net.eval()
    return ServedModel(net, meta, device)
