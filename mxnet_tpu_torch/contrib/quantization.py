"""int8 post-training quantization with calibration (counterpart of
``mxnet_tpu/contrib/quantization.py``; ref: python/mxnet/contrib/
quantization.py).

``quantize_model`` turns a trained float32 symbolic model into an int8
inference model, calibrating activation ranges on sample data.  Each
targeted Convolution / FullyConnected becomes

    quantize_v2(x, calibrated range) -> quantized_conv/fc (int8 -> int32)
        -> requantize (calibrated out range) -> dequantize -> fp32 [+bias]

with its weight quantized offline into ``<name>_quantized`` int8 plus
``<name>_min`` / ``<name>_max`` ranges.  On the card the int8
contraction is the hand-written kernel of ``csrc/int8_conv.cu``; the
float32 gaps between int8 ops are PyTorch's elementwise ops.

Calibration modes: ``none`` (ranges computed per batch at run time),
``naive`` (min/max over the calibration set), ``entropy`` (the
KL-optimal thresholds of ``_get_optimal_threshold``).  The histogram
search and the weight quantization are the JAX package's numpy code,
unchanged; the calibration forward runs where the data lives, and only
each tensor's min and max (naive) or its strided subsample (entropy)
come to the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["quantize_model", "calib_thresholds",
           "_get_optimal_threshold"]

_QUANTIZABLE = ("Convolution", "FullyConnected")
_MAX_CALIB_SAMPLES = 200_000  # per-tensor subsample cap for entropy mode


def _get_optimal_threshold(samples: np.ndarray, num_bins: int = 2001,
                           num_quantized_bins: int = 255) -> float:
    """KL-optimal |x| clipping threshold (ref: contrib/quantization.py
    _get_optimal_threshold; the TensorRT calibration method).

    Builds a histogram of |samples|, then for each candidate threshold
    computes KL(reference-distribution || quantized-distribution) and
    returns the threshold minimizing it."""
    arr = np.abs(np.asarray(samples, np.float64).ravel())
    amax = float(arr.max()) if arr.size else 0.0
    if amax == 0.0:
        return 0.0
    hist, edges = np.histogram(arr, bins=num_bins, range=(0.0, amax))
    hist = hist.astype(np.float64)
    best_kl, best_th = np.inf, amax
    # candidate thresholds sweep from num_quantized_bins//2 bins upward
    def _smooth(d, eps=1e-4):
        """Move eps mass onto zero bins so KL is finite (ref:
        _smooth_distribution)."""
        is_zero = d == 0
        n_zero = is_zero.sum()
        if n_zero == 0 or n_zero == d.size:
            return d
        eps1 = eps * n_zero / (d.size - n_zero)
        return np.where(is_zero, eps, d - eps1)

    for i in range(num_quantized_bins, num_bins + 1, 2):
        th = edges[i]
        # reference dist: the slice, with ALL outlier mass clipped into
        # its last bin — this is what clipping at `th` really does
        p = hist[:i].copy()
        p[-1] += hist[i:].sum()
        if p.sum() == 0:
            continue
        # candidate dist: the UNCLIPPED slice quantized to
        # num_quantized_bins and expanded back over occupied bins; the
        # mismatch against p's outlier-loaded last bin is the clipping
        # cost the KL score must see.  Vectorized: contiguous partition
        # of the i source bins, per-chunk sums/nonzero-counts via
        # reduceat, expansion via the per-bin chunk index.
        sliced = hist[:i]
        factor = i / num_quantized_bins
        starts = np.floor(np.arange(num_quantized_bins)
                          * factor).astype(np.int64)
        chunk_of = np.searchsorted(starts, np.arange(i),
                                   side="right") - 1
        sums = np.add.reduceat(sliced, starts)
        nz = np.add.reduceat((sliced > 0).astype(np.float64), starts)
        fill = np.divide(sums, nz, out=np.zeros_like(sums),
                         where=nz > 0)
        q = np.where(sliced > 0, fill[chunk_of], 0.0)
        if q.sum() == 0:
            continue
        # smooth the RAW counts (every nonzero count is >= 1, so the
        # eps transfer cannot go negative), then normalize
        ps = _smooth(p)
        qs = _smooth(q)
        ps = ps / ps.sum()
        qs = qs / qs.sum()
        kl = float(np.sum(ps * np.log(ps / qs)))
        if kl < best_kl:
            best_kl, best_th = kl, th
    return float(best_th)


def _iter_batches(calib_data, data_names: Sequence[str],
                  num_calib_examples: Optional[int], ctx=None):
    """Yield {name: NDArray} dicts from a DataIter, an NDArray, or an
    iterable of NDArrays (other arrays go to ``ctx``); stop after
    num_calib_examples rows."""
    from ..ndarray import NDArray

    seen = 0

    def _spent(n):
        """Yield the batch that crosses the example budget, then stop
        (reference semantics: num_calib_examples is a lower bound)."""
        nonlocal seen
        already_done = (num_calib_examples is not None
                        and seen >= num_calib_examples)
        seen += n
        return already_done

    if hasattr(calib_data, "reset") and hasattr(calib_data, "provide_data"):
        calib_data.reset()
        for batch in calib_data:
            if _spent(batch.data[0].shape[0]):
                return
            yield dict(zip(data_names, batch.data))
        return
    if isinstance(calib_data, NDArray):
        calib_data = [calib_data]
    for arr in calib_data:
        if not isinstance(arr, NDArray):
            from .. import nd

            arr = nd.array(arr, ctx=ctx)
        if _spent(arr.shape[0]):
            return
        yield {data_names[0]: arr}


def calib_thresholds(sym, arg_params, aux_params, tensor_names,
                     calib_data, data_names=("data",), calib_mode="naive",
                     num_calib_examples=None, ctx=None,
                     samples_out=None) -> Dict[str, Tuple[float, float]]:
    """Run calibration forwards and return {tensor_name: (min, max)} for
    each requested internal tensor (ref: _collect_layer_statistics).
    In entropy mode a dict ``samples_out`` receives each tensor's
    subsample, the histogram's input."""
    from .. import symbol as sym_mod

    internals = sym.get_internals()
    out_names = internals.list_outputs()
    want = [n for n in out_names if n in set(tensor_names)]
    missing = set(tensor_names) - set(want)
    if missing:
        raise MXNetError(f"calibration tensors not found: {sorted(missing)}")
    group = sym_mod.Group([internals[n] for n in want])

    stats: Dict[str, List] = {n: [] for n in want}
    minmax: Dict[str, Tuple[float, float]] = {}
    exe = None
    for feed in _iter_batches(calib_data, data_names, num_calib_examples,
                              ctx):
        if exe is None:
            # run calibration where the data lives unless the caller
            # pinned a context
            ctx = ctx or next(iter(feed.values())).ctx
            args = dict(arg_params)
            # the executor's own input buffers: later batches are copied
            # into them, never into the caller's first batch
            args.update({k: v.copy() for k, v in feed.items()})
            exe = group.bind(ctx, args=args, args_grad=None,
                             grad_req="null", aux_states=dict(aux_params))
        else:
            exe.copy_params_from(feed)
        outs = exe.forward(is_train=False)
        for name, out in zip(want, outs):
            a = out._data
            if calib_mode == "naive":
                lo, hi = minmax.get(name, (np.inf, -np.inf))
                minmax[name] = (min(lo, float(a.min())),
                                max(hi, float(a.max())))
            else:  # entropy: bounded subsample for the histogram
                flat = a.reshape(-1)
                if flat.numel() > _MAX_CALIB_SAMPLES:
                    flat = flat[:: flat.numel() // _MAX_CALIB_SAMPLES + 1]
                stats[name].append(
                    flat.cpu().numpy().astype(np.float32))
    if exe is None:
        raise MXNetError("calibration produced no batches "
                         "(empty calib_data?)")
    if calib_mode == "naive":
        return minmax
    out = {}
    for name, chunks in stats.items():
        samples = np.concatenate(chunks)
        if samples_out is not None:
            samples_out[name] = samples
        th = _get_optimal_threshold(samples)
        out[name] = (-th, th)
    return out


def quantize_model(sym, arg_params, aux_params=None, data_names=("data",),
                   excluded_sym_names=(), calib_mode="entropy",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", ctx=None, logger=None):
    """Convert an fp32 symbolic model to an int8 inference model
    (ref: contrib.quantization.quantize_model).

    Returns ``(qsym, qarg_params, aux_params)``.  Weights of quantized
    layers are replaced by ``<w>_quantized`` int8 params (+ range
    params), made on the float weight's device; the quantized
    contractions run through ``ops.quantized_conv``."""
    from ..symbol.symbol import Symbol, _Node, _apply
    from ..symbol import symbol as _ssym
    from .. import nd

    if quantized_dtype != "int8":
        raise MXNetError("the int8 path supports quantized_dtype='int8' "
                         f"(got {quantized_dtype!r})")
    if calib_mode not in ("none", "naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    aux_params = aux_params or {}
    excluded = set(excluded_sym_names)

    topo = sym._topo()
    targets = [n for n in topo
               if n.op in _QUANTIZABLE and n.name not in excluded]
    if not targets:
        raise MXNetError("no quantizable layers found "
                         "(Convolution/FullyConnected all excluded?)")

    def _out_name(node: _Node, idx: int) -> str:
        return (f"{node.name}_output" if node.num_outputs == 1
                else f"{node.name}_output{idx}")

    # -- calibration: ranges of every quantized layer's INPUT tensor and
    # OUTPUT tensor ------------------------------------------------------
    th_dict: Dict[str, Tuple[float, float]] = {}
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} needs calib_data")
        wanted = set()
        for node in targets:
            d_node, d_idx = node.inputs[0]
            if d_node.op is not None:  # data input is an internal tensor
                wanted.add(_out_name(d_node, d_idx))
            wanted.add(_out_name(node, 0))
        th_dict = calib_thresholds(
            sym, arg_params, aux_params, sorted(wanted), calib_data,
            data_names=data_names, calib_mode=calib_mode,
            num_calib_examples=num_calib_examples, ctx=ctx)

    # -- offline weight quantization -------------------------------------
    # a weight var may be shared by several layers (tied weights):
    # quantize it once, and keep the fp32 original whenever any
    # NON-target node still consumes it
    target_ids = {id(n) for n in targets}
    fp32_consumed = set()
    for node in topo:
        if node.op is None or id(node) in target_ids:
            continue
        for (inp, _) in node.inputs:
            if inp.op is None:
                fp32_consumed.add(inp.name)
    qarg_params = dict(arg_params)
    for node in targets:
        wname = node.inputs[1][0].name
        if f"{wname}_quantized" in qarg_params:
            continue  # tied weight already quantized
        w = arg_params[wname].asnumpy()
        dev = arg_params[wname].ctx
        absmax = float(np.abs(w).max()) or 1e-20
        wq = np.clip(np.round(w * (127.0 / absmax)), -127, 127)
        qarg_params[f"{wname}_quantized"] = nd.array(wq.astype(np.int8),
                                                     ctx=dev)
        qarg_params[f"{wname}_min"] = nd.array(
            np.array([-absmax], np.float32), ctx=dev)
        qarg_params[f"{wname}_max"] = nd.array(
            np.array([absmax], np.float32), ctx=dev)
        if wname not in fp32_consumed:
            del qarg_params[wname]

    # -- graph rewrite ----------------------------------------------------
    new_of: Dict[int, Symbol] = {}

    def _sym_of(node: _Node, idx: int) -> Symbol:
        s = new_of[id(node)]
        return s[idx] if len(s) > 1 else s

    replaced_weight_ids = {id(t.inputs[1][0]) for t in targets}
    for node in topo:
        if node.op is None:
            if (id(node) in replaced_weight_ids
                    and node.name not in fp32_consumed):
                continue  # fully-replaced weight var: int8 vars below
            new_of[id(node)] = Symbol([(node, 0)])
            continue
        if id(node) not in target_ids:
            ins = [_sym_of(i, idx) for (i, idx) in node.inputs]
            new_of[id(node)] = _apply(node.op, ins, dict(node.attrs),
                                      name=node.name)
            continue

        # quantized rewrite of one Convolution / FullyConnected
        d_node, d_idx = node.inputs[0]
        x = _sym_of(d_node, d_idx)
        wname = node.inputs[1][0].name
        wq = _ssym.var(f"{wname}_quantized", dtype="int8")
        wmin = _ssym.var(f"{wname}_min")
        wmax = _ssym.var(f"{wname}_max")
        in_key = (_out_name(d_node, d_idx) if d_node.op is not None
                  else None)
        q_attrs = {"out_type": "int8"}
        if in_key is not None and in_key in th_dict:
            lo, hi = th_dict[in_key]
            q_attrs["min_calib_range"] = float(lo)
            q_attrs["max_calib_range"] = float(hi)
        xq = _apply("_contrib_quantize_v2", [x], q_attrs,
                    name=f"{node.name}_quantize")
        conv_attrs = {k: v for k, v in node.attrs.items()
                      if not k.startswith("__")}
        conv_attrs["no_bias"] = True
        qop = ("_contrib_quantized_conv" if node.op == "Convolution"
               else "_contrib_quantized_fully_connected")
        y32 = _apply(qop, [xq[0], wq, xq[1], xq[2], wmin, wmax],
                     conv_attrs, name=f"{node.name}_int8")
        out_key = _out_name(node, 0)
        if out_key in th_dict:
            lo, hi = th_dict[out_key]
            y8 = _apply("_contrib_requantize",
                        [y32[0], y32[1], y32[2]],
                        {"out_type": "int8",
                         "min_calib_range": float(lo),
                         "max_calib_range": float(hi)},
                        name=f"{node.name}_requantize")
            deq = _apply("_contrib_dequantize", [y8[0], y8[1], y8[2]], {},
                         name=f"{node.name}_dequantize")
        else:  # dynamic mode: dequantize the int32 accumulator directly
            deq = _apply("_contrib_dequantize", [y32[0], y32[1], y32[2]],
                         {}, name=f"{node.name}_dequantize")
        # bias rides in fp32 after dequantize
        has_bias = (not node.attrs.get("no_bias", False)
                    and len(node.inputs) > 2)
        if has_bias:
            bias = _sym_of(*node.inputs[2])
            if node.op == "Convolution":
                lay = node.attrs.get("layout") or "NCHW"
                ndim = len(node.attrs.get("kernel", ())) or 2
                shape = ((1, -1) + (1,) * ndim if lay[-1] != "C"
                         else (1,) * (ndim + 1) + (-1,))
                bias = _apply("reshape", [bias],
                              {"shape": shape},
                              name=f"{node.name}_bias_reshape")
                out = _apply("broadcast_add", [deq, bias], {},
                             name=node.name)
            else:
                bias = _apply("reshape", [bias], {"shape": (1, -1)},
                              name=f"{node.name}_bias_reshape")
                out = _apply("broadcast_add", [deq, bias], {},
                             name=node.name)
        else:
            out = _apply("identity", [deq], {}, name=node.name)
        new_of[id(node)] = out

    heads = []
    for (n, i) in sym._heads:
        s = _sym_of(n, i)
        heads.extend(s._heads)
    qsym = Symbol(heads)
    if logger:
        logger.info("quantized %d layers (%s calibration)",
                    len(targets), calib_mode)
    return qsym, qarg_params, aux_params
