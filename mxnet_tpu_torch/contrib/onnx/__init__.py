"""ONNX export and import of the port's Symbol graphs (counterpart of
``mxnet_tpu/contrib/onnx/``; ref: python/mxnet/contrib/onnx/, mx2onnx
and onnx2mx).

Files are read and written by the port's own pure-Python protobuf layer
(``proto.py``; no ``onnx`` package), at opset 13, with the JAX package's
op mapping, so both packages write the same bytes for the same graph and
weights and each imports the other's files.  Supported: Conv,
Gemm(+Flatten), BatchNormalization, Relu/Sigmoid/Tanh/Softplus,
MaxPool/AveragePool/Global*Pool, Softmax, Add/Sub/Mul/Div, Concat,
Reshape, Transpose, Flatten, Dropout, Identity.  An operator outside it
raises with its name.

``import_model`` returns ``arg_params`` and ``aux_params`` on ``cpu()``
whatever the current context, as the reference's importer does;
``Module.bind``/``set_params`` copy them to the module's device::

    from mxnet_tpu_torch.contrib import onnx as onnx_mxnet
    onnx_mxnet.export_model(sym, params, [(1, 3, 224, 224)], "net.onnx")
    sym, arg_params, aux_params = onnx_mxnet.import_model("net.onnx")
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ...base import MXNetError
from . import proto

__all__ = ["export_model", "import_model", "get_model_metadata"]


# ---------------------------------------------------------------------------
# export: Symbol -> ONNX
# ---------------------------------------------------------------------------

def _pool_onnx(node, mk):
    a = node.attrs
    kernel = list(a.get("kernel", ()))
    if a.get("global_pool", False):
        op = ("GlobalMaxPool" if a.get("pool_type", "max") == "max"
              else "GlobalAveragePool")
        return mk(op, {})
    pads = list(a.get("pad", ())) or [0] * len(kernel)
    attrs = {"kernel_shape": kernel,
             "strides": list(a.get("stride", ())) or [1] * len(kernel),
             "pads": pads + pads}
    if a.get("pool_type", "max") == "max":
        return mk("MaxPool", attrs)
    attrs["count_include_pad"] = int(a.get("count_include_pad", True))
    return mk("AveragePool", attrs)


def export_model(sym, params, input_shapes: Sequence[Tuple[int, ...]],
                 onnx_file: str = "model.onnx",
                 input_dtype=np.float32, verbose: bool = False) -> str:
    """Export a Symbol + params to an ONNX file
    (ref: contrib/onnx/mx2onnx/export_model.py).  `params` maps names to
    NDArrays, tensors or numpy arrays; 'arg:'/'aux:' prefixes (checkpoint
    convention) are accepted."""
    import torch

    from ...ndarray.ndarray import NDArray
    from ...symbol.symbol import Symbol

    def host(v):
        if isinstance(v, NDArray):
            return v.asnumpy()
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return v

    if not isinstance(sym, Symbol):
        from ...symbol import load as sym_load

        sym = sym_load(sym)
    weights: Dict[str, np.ndarray] = {}
    for k, v in dict(params).items():
        name = k.split(":", 1)[1] if ":" in k else k
        weights[name] = np.asarray(host(v))

    g = proto.Graph(name=sym.name or "mxnet_tpu")
    topo = sym._topo()
    out_name: Dict[Tuple[int, int], str] = {}
    data_inputs = [n for n in topo
                   if n.op is None and n.name not in weights]
    if len(data_inputs) != len(input_shapes):
        raise MXNetError(
            f"export_model got {len(input_shapes)} input_shapes for "
            f"{len(data_inputs)} graph inputs "
            f"({[n.name for n in data_inputs]})")
    for n, shp in zip(data_inputs, input_shapes):
        g.inputs.append(proto.ValueInfo(
            n.name, proto.NP_TO_DT[np.dtype(input_dtype)], list(shp)))
        out_name[(id(n), 0)] = n.name
    for n in topo:
        if n.op is None and n.name in weights:
            g.initializers.append(
                proto.Tensor.from_numpy(n.name, weights[n.name]))
            out_name[(id(n), 0)] = n.name

    def conv_node(node, ins, outs):
        a = node.attrs
        kernel = list(a.get("kernel", ()))
        pads = list(a.get("pad", ())) or [0] * len(kernel)
        return [proto.Node(
            op_type="Conv", inputs=ins, outputs=outs, name=node.name,
            attrs={"kernel_shape": kernel,
                   "strides": list(a.get("stride", ())) or [1] * len(kernel),
                   "pads": pads + pads,
                   "dilations": list(a.get("dilate", ())) or [1] * len(kernel),
                   "group": int(a.get("num_group", 1))})]

    def fc_node(node, ins, outs):
        a = node.attrs
        nodes = []
        data = ins[0]
        if a.get("flatten", True):
            flat = node.name + "_flat"
            nodes.append(proto.Node(op_type="Flatten", inputs=[data],
                                    outputs=[flat], name=flat,
                                    attrs={"axis": 1}))
            data = flat
        nodes.append(proto.Node(
            op_type="Gemm", inputs=[data] + ins[1:], outputs=outs,
            name=node.name,
            attrs={"alpha": 1.0, "beta": 1.0, "transB": 1}))
        return nodes

    def bn_node(node, ins, outs):
        a = node.attrs
        return [proto.Node(
            op_type="BatchNormalization", inputs=ins, outputs=outs,
            name=node.name,
            attrs={"epsilon": float(a.get("eps", 1e-5)),
                   "momentum": float(a.get("momentum", 0.9))})]

    def act_node(node, ins, outs):
        mapping = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
                   "softrelu": "Softplus"}
        t = node.attrs.get("act_type", "relu")
        if t not in mapping:
            raise MXNetError(f"onnx export: unsupported act_type {t!r}")
        return [proto.Node(op_type=mapping[t], inputs=ins, outputs=outs,
                           name=node.name)]

    def reshape_node(node, ins, outs):
        shape = np.asarray(node.attrs.get("shape", ()), np.int64)
        sname = node.name + "_shape"
        g.initializers.append(proto.Tensor.from_numpy(sname, shape))
        return [proto.Node(op_type="Reshape", inputs=ins + [sname],
                           outputs=outs, name=node.name)]

    simple = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
              "elemwise_add": "Add", "broadcast_add": "Add",
              "elemwise_sub": "Sub", "broadcast_sub": "Sub",
              "elemwise_mul": "Mul", "broadcast_mul": "Mul",
              "elemwise_div": "Div", "broadcast_div": "Div",
              "flatten": "Flatten", "Flatten": "Flatten",
              "identity": "Identity", "_copy": "Identity"}

    for node in topo:
        if node.op is None:
            if (id(node), 0) not in out_name:
                raise MXNetError(
                    f"onnx export: free variable {node.name!r} has no "
                    "shape (pass it in input_shapes) and no weight")
            continue
        ins = []
        for (inp, idx) in node.inputs:
            name = out_name.get((id(inp), idx))
            if name is None:
                raise MXNetError(
                    f"onnx export: {node.op} consumes output {idx} of "
                    f"{inp.op} {inp.name!r}, which has no ONNX "
                    f"equivalent (e.g. BatchNorm mean/var side outputs)")
            ins.append(name)
        outs = [node.name if node.num_outputs == 1
                else f"{node.name}_{i}" for i in range(node.num_outputs)]
        for i in range(node.num_outputs):
            out_name[(id(node), i)] = outs[i]

        def mk(op_type, attrs):
            return [proto.Node(op_type=op_type, inputs=ins, outputs=outs,
                               name=node.name, attrs=attrs)]

        op = node.op
        if op == "Convolution":
            new = conv_node(node, ins, outs)
        elif op == "FullyConnected":
            new = fc_node(node, ins, outs)
        elif op == "BatchNorm":
            new = bn_node(node, ins, outs[:1])
            out_name[(id(node), 0)] = outs[0]
            # ONNX BatchNormalization (inference) has one output; the
            # mean/var side outputs (output_mean_var=1) have no ONNX
            # name -> a consumer of them fails loudly at lookup above
            for i in range(1, node.num_outputs):
                out_name.pop((id(node), i), None)
        elif op == "Activation":
            new = act_node(node, ins, outs)
        elif op == "Pooling":
            new = _pool_onnx(node, mk)
        elif op in ("softmax", "SoftmaxOutput"):
            new = [proto.Node(op_type="Softmax", inputs=ins[:1],
                              outputs=outs, name=node.name,
                              attrs={"axis": -1})]
        elif op == "Dropout":
            new = [proto.Node(op_type="Identity", inputs=ins[:1],
                              outputs=outs, name=node.name)]
        elif op == "reshape":
            new = reshape_node(node, ins, outs)
        elif op == "transpose":
            axes = node.attrs.get("axes")
            new = mk("Transpose", {"perm": list(axes)} if axes else {})
        elif op == "concat" or op == "Concat":
            new = mk("Concat", {"axis": int(node.attrs.get("dim", 1))})
        elif op in simple:
            new = mk(simple[op], {})
        elif op in ("_plus_scalar", "_mul_scalar", "_minus_scalar",
                    "_div_scalar"):
            const = np.asarray(node.attrs.get("scalar", 0.0), np.float32)
            cname = node.name + "_const"
            g.initializers.append(proto.Tensor.from_numpy(cname, const))
            op_map = {"_plus_scalar": "Add", "_mul_scalar": "Mul",
                      "_minus_scalar": "Sub", "_div_scalar": "Div"}
            new = [proto.Node(op_type=op_map[op], inputs=ins + [cname],
                              outputs=outs, name=node.name)]
        else:
            raise MXNetError(
                f"onnx export: operator {op!r} has no ONNX mapping yet "
                "(ref: mx2onnx op coverage is similarly incremental)")
        g.nodes.extend(new)

    try:
        shape_kwargs = {n.name: shp
                        for n, shp in zip(data_inputs, input_shapes)}
        _, out_shapes, _ = sym.infer_shape_partial(**shape_kwargs)
    except Exception:
        out_shapes = [None] * len(sym._heads)
    for (n, i), oshape in zip(sym._heads, out_shapes):
        head = out_name.get((id(n), i))
        if head is None:
            raise MXNetError(
                f"onnx export: graph output {i} of {n.op} {n.name!r} "
                f"has no ONNX equivalent (e.g. BatchNorm mean/var side "
                f"outputs)")
        g.outputs.append(proto.ValueInfo(
            head, proto.DT_FLOAT, list(oshape) if oshape else []))
    model = proto.Model(graph=g)
    proto.save(model, onnx_file)
    return onnx_file


# ---------------------------------------------------------------------------
# import: ONNX -> Symbol
# ---------------------------------------------------------------------------

def import_model(model_file: str):
    """Load an ONNX model -> (sym, arg_params, aux_params), the
    parameters on ``cpu()`` (ref: contrib/onnx/onnx2mx/import_model.py)."""
    from ... import symbol as sym_mod
    from ...context import cpu
    from ...ndarray.ndarray import array

    def nd_array(a):
        return array(a, ctx=cpu())

    m = proto.load(model_file)
    g = m.graph
    inits = {t.name: t.to_numpy() for t in g.initializers}
    sym_of: Dict[str, object] = {}
    arg_params: Dict[str, object] = {}
    aux_params: Dict[str, object] = {}

    for vi in g.inputs:
        if vi.name not in inits:
            sym_of[vi.name] = sym_mod.var(vi.name, shape=[
                d if d else 1 for d in vi.shape] or None)

    def var_for(name: str, aux: bool = False):
        if name in sym_of:
            return sym_of[name]
        if name not in inits:
            raise MXNetError(f"onnx import: undefined input {name!r}")
        v = sym_mod.var(name)
        if aux:
            v._heads[0][0].is_aux = True
            aux_params[name] = nd_array(inits[name])
        else:
            arg_params[name] = nd_array(inits[name])
        sym_of[name] = v
        return v

    def out(node, results):
        res = results if isinstance(results, (list, tuple)) else [results]
        for nm, s in zip(node.outputs, res):
            sym_of[nm] = s

    simple = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
              "Add": "broadcast_add",
              "Sub": "broadcast_sub", "Mul": "broadcast_mul",
              "Div": "broadcast_div", "Identity": "identity",
              "Flatten": "flatten"}

    def _weight_init(inits, node, i):
        name = node.inputs[i]
        if name not in inits:
            raise MXNetError(
                f"onnx import: {node.op_type} weight '{name}' is not a "
                f"graph initializer (it is a graph input or produced by "
                f"another node); only initializer-backed weights are "
                f"supported")
        return inits[name]

    for node in g.nodes:
        a = node.attrs
        op = node.op_type
        if op == "Conv":
            kernel = a.get("kernel_shape")
            pads = a.get("pads", [0] * (2 * len(kernel)))
            if pads[:len(kernel)] != pads[len(kernel):]:
                raise MXNetError("onnx import: asymmetric Conv pads "
                                 "are not supported")
            w = _weight_init(inits, node, 1)
            res = sym_mod.Convolution(
                var_for(node.inputs[0]), var_for(node.inputs[1]),
                *( [var_for(node.inputs[2])] if len(node.inputs) > 2
                   else []),
                kernel=tuple(kernel), num_filter=int(w.shape[0]),
                stride=tuple(a.get("strides", [1] * len(kernel))),
                pad=tuple(pads[:len(kernel)]),
                dilate=tuple(a.get("dilations", [1] * len(kernel))),
                num_group=int(a.get("group", 1)),
                no_bias=len(node.inputs) <= 2, name=node.name or None)
            out(node, res)
        elif op == "Gemm":
            if a.get("transB", 0) != 1 or a.get("transA", 0) != 0 or \
                    a.get("alpha", 1.0) != 1.0 or a.get("beta", 1.0) != 1.0:
                raise MXNetError("onnx import: general Gemm forms beyond "
                                 "Y = X W^T + b are not supported")
            w = _weight_init(inits, node, 1)
            res = sym_mod.FullyConnected(
                var_for(node.inputs[0]), var_for(node.inputs[1]),
                *( [var_for(node.inputs[2])] if len(node.inputs) > 2
                   else []),
                num_hidden=int(w.shape[0]), flatten=False,
                no_bias=len(node.inputs) <= 2, name=node.name or None)
            out(node, res)
        elif op == "BatchNormalization":
            res = sym_mod.BatchNorm(
                var_for(node.inputs[0]), var_for(node.inputs[1]),
                var_for(node.inputs[2]),
                var_for(node.inputs[3], aux=True),
                var_for(node.inputs[4], aux=True),
                eps=float(a.get("epsilon", 1e-5)),
                momentum=float(a.get("momentum", 0.9)),
                name=node.name or None)
            out(node, res)
        elif op in ("MaxPool", "AveragePool"):
            kernel = a.get("kernel_shape")
            pads = a.get("pads", [0] * (2 * len(kernel)))
            res = sym_mod.Pooling(
                var_for(node.inputs[0]), kernel=tuple(kernel),
                stride=tuple(a.get("strides", [1] * len(kernel))),
                pad=tuple(pads[:len(kernel)]),
                pool_type="max" if op == "MaxPool" else "avg",
                count_include_pad=bool(a.get("count_include_pad", 1)),
                name=node.name or None)
            out(node, res)
        elif op in ("GlobalMaxPool", "GlobalAveragePool"):
            res = sym_mod.Pooling(
                var_for(node.inputs[0]), global_pool=True,
                pool_type="max" if "Max" in op else "avg",
                name=node.name or None)
            out(node, res)
        elif op == "Softmax":
            res = sym_mod.softmax(var_for(node.inputs[0]),
                                  axis=int(a.get("axis", -1)))
            out(node, res)
        elif op == "Reshape":
            shape = inits.get(node.inputs[1])
            if shape is None:
                raise MXNetError("onnx import: dynamic Reshape shape "
                                 "inputs are not supported")
            res = sym_mod.reshape(var_for(node.inputs[0]),
                                  shape=tuple(int(s) for s in shape))
            out(node, res)
        elif op == "Transpose":
            perm = a.get("perm")
            res = sym_mod.transpose(var_for(node.inputs[0]),
                                    axes=tuple(perm) if perm else None)
            out(node, res)
        elif op == "Concat":
            res = sym_mod.concat(*[var_for(i) for i in node.inputs],
                                 dim=int(a.get("axis", 1)))
            out(node, res)
        elif op == "Dropout":
            out(node, sym_mod.identity(var_for(node.inputs[0])))
        elif op == "Softplus":
            # the Activation export's inverse (no op is named softrelu)
            out(node, sym_mod.Activation(var_for(node.inputs[0]),
                                         act_type="softrelu"))
        elif op in simple:
            fn = getattr(sym_mod, simple[op])
            res = fn(*[var_for(i) for i in node.inputs])
            out(node, res)
        else:
            raise MXNetError(
                f"onnx import: operator {op!r} has no mapping yet")

    from ...symbol.symbol import Group

    outs = [sym_of[vi.name] for vi in g.outputs]
    sym = outs[0] if len(outs) == 1 else Group(outs)
    return sym, arg_params, aux_params


def get_model_metadata(model_file: str) -> Dict[str, List]:
    """ref: contrib/onnx get_model_metadata — input/output signatures."""
    m = proto.load(model_file)
    inits = {t.name for t in m.graph.initializers}
    return {
        "input_tensor_data": [
            (vi.name, tuple(vi.shape)) for vi in m.graph.inputs
            if vi.name not in inits],
        "output_tensor_data": [
            (vi.name, tuple(vi.shape)) for vi in m.graph.outputs],
    }
