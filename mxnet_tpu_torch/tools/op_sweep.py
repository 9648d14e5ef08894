"""Seeded sample inputs for every op the port registers, and the sweep
that holds a device's results against the CPU's.

``CASES`` maps each registered op name to a :class:`Case`: its inputs
(numpy arrays drawn from a seed, or fixed ones), its attributes and the
class its results are held in:

* ``exact``: index, selection and data-movement ops (and comparisons):
  the same bits;
* ``ulp``: elementwise math, within ``ULP_BOUND`` ulps of the reference,
  the ulp taken at no less than 2^-10 of the output's largest magnitude;
* ``sum``: reductions and products, within 2^-24 · n · S + one rounding,
  S the sum of the terms' magnitudes (the op on |inputs| in float64 for a
  sum or a product of sums, ``terms=True``; otherwise the output's
  largest magnitude) and n the longest sum (``n``);
* ``random``: draws, which another device's generator cannot repeat;
* ``elsewhere``: ops whose device path a named check holds at its main
  path's shapes (the kernel ops, the update ops, MultiBox*, Dropout).

The gradient of a differentiable op is held in the class of its
forward, except where ``bwd`` names another (an exact op whose backward
sums the cotangents of repeated indices is ``sum``).

:func:`sweep` runs every case on a device and on the CPU;
``chip_smoke.py`` calls it on the card, and the CPU tests take the same
inputs to hold the ops against the JAX package.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Case", "CASES", "ELSEWHERE", "case_inputs", "sweep",
           "ULP_BOUND", "ulps", "sum_bound"]

ULP_BOUND = 16


@dataclass
class Case:
    inputs: List[Callable]              # rng -> numpy array (or None)
    attrs: dict = field(default_factory=dict)
    kind: str = "ulp"
    n: int = 1                          # longest sum, forward or backward
    terms: bool = False                 # S = op(|inputs|) in float64
    bwd: Optional[str] = None           # the backward's class


def F(*shape, lo=-2.0, hi=2.0):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def P(*shape, lo=0.5, hi=3.0):
    return F(*shape, lo=lo, hi=hi)


def I(*shape, lo=0, hi=5):  # noqa: E743 — an int32 input
    return lambda rng: rng.randint(lo, hi, shape).astype(np.int32)


def FI(*shape, lo=0, hi=5):
    return lambda rng: rng.randint(lo, hi, shape).astype(np.float32)


def C(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return lambda rng: a.copy()


def UNIQUE_ND(dims, k):
    """(len(dims), k) multi-indices into dims, no two alike."""
    def make(rng):
        flat = rng.choice(int(np.prod(dims)), k, replace=False)
        return np.stack(np.unravel_index(flat, dims)).astype(np.float32)
    return make


def _boxes(n, span=0.6, size=0.4):
    def make(rng):
        xy = rng.uniform(0.0, span, (n, 2))
        wh = rng.uniform(0.05, size, (n, 2))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return make


def _reshape(make, shape):
    return lambda rng: make(rng).reshape(shape)


X = F(3, 4)
CASES: Dict[str, Case] = {}


def add(names, case):
    for n in names.split():
        CASES[n] = case


# ---- elementwise unary ------------------------------------------------------
for _n in ("abs negative exp sqrt relu sigmoid tanh square sign ceil floor "
           "trunc fix sin cos tan arctan sinh cosh arcsinh degrees radians "
           "softsign erf expm1 identity hard_swish mish rint round").split():
    add(_n, Case([F(3, 4)]))
add("round rint", Case([C([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.49, 3.7],
                           [-0.51, 4.5, -3.5, 1.25]])]))
add("log log10 log2 rsqrt cbrt rcbrt reciprocal",
    Case([P(3, 4, lo=0.1, hi=4.0)]))
# lgamma and digamma are series: their error is absolute, so a value near
# a root (digamma at 1.46, lgamma at 1 and 2) is many of its own ulps off
add("gammaln digamma", Case([P(3, 4, lo=0.1, hi=4.0)], kind="sum", n=8))
add("cbrt rcbrt reciprocal", Case([C([[-8.0, -0.3, -27.5, 0.6],
                                      [1.7, -3.1, 64.0, -0.02],
                                      [5.0, -1e-3, 2.2, -9.9]])]))
add("gamma", Case([C([[-1.5, -2.5, 0.5, 1.3], [2.7, 3.9, -0.3, 4.4],
                      [-3.7, 0.9, 1.1, 5.5]])]))
add("log1p", Case([P(3, 4, lo=-0.9, hi=3.0)]))
add("arcsin arccos arctanh erfinv", Case([F(3, 4, lo=-0.95, hi=0.95)]))
add("arccosh", Case([P(3, 4, lo=1.05, hi=4.0)]))
add("logical_not", Case([FI(3, 4, lo=-1, hi=2)], kind="exact"))
add("copy _copy zeros_like ones_like", Case([X], kind="exact"))
add("hard_sigmoid", Case([F(3, 4, lo=-4, hi=4)]))
add("isnan isinf isfinite",
    Case([C([[0.0, np.nan, np.inf, -np.inf], [1.0, -2.0, np.nan, 3.0]])],
         kind="exact"))
add("smooth_l1", Case([F(3, 4)], {"scalar": 1.5}))
add("clip", Case([F(3, 4)], {"a_min": -0.5, "a_max": 1.0}))
add("Activation activation", Case([F(3, 4)], {"act_type": "softrelu"}))
add("LeakyReLU leaky_relu", Case([F(3, 4)], {"act_type": "elu",
                                              "slope": 0.3}))
add("Cast cast", Case([X], {"dtype": "float16"}, kind="exact"))

# ---- binary, scalar and comparisons -----------------------------------------
add("broadcast_add broadcast_sub broadcast_mul broadcast_maximum "
    "broadcast_minimum elemwise_add elemwise_sub elemwise_mul "
    "broadcast_hypot arctan2", Case([F(3, 4), F(3, 4)]))
add("broadcast_div elemwise_div broadcast_mod", Case([F(3, 4), P(3, 4)]))
add("broadcast_power", Case([P(3, 4), F(3, 4)]))
for _n in ("_plus_scalar _minus_scalar _rminus_scalar _mul_scalar "
           "_div_scalar _maximum_scalar _minimum_scalar _hypot_scalar "
           "_mod_scalar").split():
    CASES[_n] = Case([F(3, 4)], {"scalar": 1.7})
add("_rdiv_scalar _rmod_scalar _power_scalar _rpower_scalar",
    Case([P(3, 4)], {"scalar": 1.7}))
add("broadcast_equal broadcast_not_equal broadcast_greater "
    "broadcast_greater_equal broadcast_lesser broadcast_lesser_equal "
    "broadcast_logical_and broadcast_logical_or broadcast_logical_xor",
    Case([FI(3, 4, lo=-1, hi=2), FI(3, 4, lo=-1, hi=2)], kind="exact"))
add("_equal_scalar _not_equal_scalar _greater_scalar _greater_equal_scalar "
    "_lesser_scalar _lesser_equal_scalar _logical_and_scalar "
    "_logical_or_scalar _logical_xor_scalar",
    Case([FI(3, 4, lo=-1, hi=2)], {"scalar": 0.0}, kind="exact"))
add("bitwise_and bitwise_or bitwise_xor",
    Case([I(3, 4, hi=64), I(3, 4, hi=64)], kind="exact"))
add("where", Case([FI(3, 4, lo=0, hi=2), F(3, 4), F(3, 4)], kind="exact"))

# ---- reductions and products -------------------------------------------------
add("sum sum_axis mean nansum", Case([F(4, 6)], {"axis": 1}, kind="sum",
                                     n=6, terms=True))
add("prod nanprod", Case([P(4, 6, lo=0.5, hi=1.5)], {"axis": 1},
                         kind="sum", n=6, terms=True))
add("max max_axis min min_axis", Case([F(4, 6)], {"axis": 1},
                                      kind="exact"))
add("norm", Case([F(4, 6)], {"axis": 1}, kind="sum", n=6, terms=True))
add("argmax argmin argmax_channel", Case([F(4, 6)], kind="exact"))
add("cumsum", Case([F(4, 6)], {"axis": 1}, kind="sum", n=6, terms=True))
add("cumprod", Case([P(4, 6, lo=0.5, hi=1.5)], {"axis": 1}, kind="sum",
                    n=6, terms=True))
add("trace", Case([F(5, 5)], kind="sum", n=5, terms=True))
add("dot", Case([F(4, 5), F(5, 3)], kind="sum", n=5, terms=True))
add("batch_dot", Case([F(2, 4, 5), F(2, 3, 5)], {"transpose_b": True},
                      kind="sum", n=5, terms=True))
add("matmul", Case([F(2, 4, 5), F(2, 5, 3)], kind="sum", n=5, terms=True))
add("L2Normalization", Case([F(3, 4, 2)], kind="sum", n=8))
add("RMSNorm rms_norm", Case([F(3, 8), P(8)], kind="sum", n=8))
add("LayerNorm layer_norm", Case([F(3, 8), P(8), F(8)], kind="sum", n=8))
add("InstanceNorm instance_norm", Case([F(2, 3, 4, 4), P(3), F(3)],
                                       kind="sum", n=16))
add("GroupNorm group_norm", Case([F(2, 4, 3, 3), P(4), F(4)],
                                 {"num_groups": 2}, kind="sum", n=18))
add("BatchNorm batch_norm",
    Case([F(4, 3, 2, 2), P(3), F(3), F(3), P(3)], {"train": True},
         kind="sum", n=16))
add("softmax softmin SoftmaxActivation softmax_activation",
    Case([F(3, 5)], kind="sum", n=5))
add("log_softmax", Case([F(3, 5)], kind="sum", n=5))
add("FullyConnected fully_connected",
    Case([F(4, 6), F(5, 6), F(5)], {"num_hidden": 5}, kind="sum", n=7,
         terms=True))
add("Convolution convolution",
    Case([F(2, 3, 6, 6), F(4, 3, 3, 3), F(4)],
         {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)}, kind="sum",
         n=28, terms=True))
add("Deconvolution deconvolution",
    Case([F(2, 4, 4, 4), F(4, 3, 3, 3), F(3)],
         {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2)},
         kind="sum", n=37, terms=True))
add("Pooling pooling", Case([F(2, 3, 6, 6)], {"kernel": (2, 2),
                                              "stride": (2, 2),
                                              "pool_type": "avg"},
                            kind="sum", n=4, terms=True))
add("Correlation correlation", Case([F(1, 3, 6, 6), F(1, 3, 6, 6)],
                                    {"max_displacement": 1, "pad_size": 1},
                                    kind="sum", n=3))
# the densities with one parameter a sample (elementwise; the per-row
# broadcast is held by the CPU tests): n·S stands for the log-density's
# terms, up to 6 of up to 5 times the output's largest magnitude
add("_random_pdf_uniform random_pdf_uniform",
    Case([F(2, 5, lo=-1, hi=3), F(2, 5, lo=-1, hi=0), P(2, 5, lo=2, hi=3)],
         kind="sum", n=32))
add("_random_pdf_normal random_pdf_normal",
    Case([F(2, 5), F(2, 5), P(2, 5)], kind="sum", n=32))
add("_random_pdf_gamma random_pdf_gamma",
    Case([P(2, 5, lo=0.1, hi=4), P(2, 5), P(2, 5)], {"is_log": True},
         kind="sum", n=32))
add("_random_pdf_exponential random_pdf_exponential",
    Case([P(2, 5, lo=0.0, hi=4), P(2, 5)], kind="sum", n=32))
add("_random_pdf_poisson random_pdf_poisson",
    Case([FI(2, 5, hi=8), P(2, 5, hi=5)], kind="sum", n=32))
add("_random_pdf_negative_binomial random_pdf_negative_binomial",
    Case([FI(2, 5, hi=8), P(2, 5, hi=5), P(2, 5, lo=0.2, hi=0.8)],
         {"is_log": True}, kind="sum", n=32))

# ---- shapes, slicing, joining -------------------------------------------------
add("Reshape reshape", Case([F(2, 3, 4)], {"shape": (0, -1)},
                            kind="exact"))
add("reshape_like", Case([F(2, 6), F(3, 4)], kind="exact"))
add("transpose", Case([F(2, 3, 4)], {"axes": (2, 0, 1)}, kind="exact"))
add("swapaxes SwapAxis", Case([F(2, 3, 4)], {"dim1": 0, "dim2": 2},
                              kind="exact"))
add("expand_dims", Case([X], {"axis": 1}, kind="exact"))
add("squeeze", Case([F(3, 1, 4)], kind="exact"))
add("Flatten flatten", Case([F(2, 3, 4)], kind="exact"))
add("slice_axis", Case([F(4, 5)], {"axis": 1, "begin": 1, "end": 4},
                       kind="exact"))
add("slice", Case([F(4, 5, 6)], {"begin": (1, None, 5), "end": (4, 4, 0),
                                 "step": (2, 1, -2)}, kind="exact"))
add("slice_like", Case([F(4, 5), F(2, 3)], kind="exact"))
add("Concat concat", Case([F(2, 3), F(2, 2)], {"dim": 1}, kind="exact"))
add("stack", Case([F(2, 3), F(2, 3), F(2, 3)], {"axis": 1},
                  kind="exact"))
add("split SliceChannel", Case([F(2, 6, 3)], {"num_outputs": 3,
                                              "axis": 1}, kind="exact"))
add("tile", Case([F(2, 3)], {"reps": (2, 1, 2)}, kind="exact", bwd="sum",
                 n=4))
add("repeat", Case([F(2, 3)], {"repeats": 2, "axis": 1}, kind="exact",
                   bwd="sum", n=2))
add("reverse flip", Case([F(3, 4)], {"axis": (0, 1)}, kind="exact"))
add("broadcast_to", Case([F(3, 1)], {"shape": (2, 3, 4)}, kind="exact",
                         bwd="sum", n=8))
add("broadcast_like", Case([F(1, 4), F(3, 4)], kind="exact", bwd="sum",
                           n=3))
add("broadcast_axis broadcast_axes", Case([F(3, 1)], {"axis": 1,
                                                       "size": 5},
                                          kind="exact", bwd="sum", n=5))
add("depth_to_space", Case([F(1, 8, 2, 3)], {"block_size": 2},
                           kind="exact"))
add("space_to_depth", Case([F(1, 2, 4, 6)], {"block_size": 2},
                           kind="exact"))
add("Pad pad", Case([F(1, 2, 3, 3)], {"mode": "edge",
                                      "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
                    kind="exact", bwd="sum", n=4))
add("diag", Case([F(4, 4)], {"k": 1}, kind="exact"))
add("_arange_like arange_like", Case([F(3, 4)], {"start": 1.0,
                                                  "step": 0.5},
                                     kind="exact"))
add("shape_array size_array", Case([F(3, 4)], kind="exact"))
add("BlockGrad block_grad stop_gradient MakeLoss make_loss",
    Case([X], kind="exact"))
add("im2col", Case([F(1, 2, 5, 5)], {"kernel": (3, 3), "stride": (2, 1),
                                     "pad": (1, 0)}, kind="exact",
                   bwd="sum", n=9))
add("col2im", Case([F(1, 18, 9)], {"output_size": (5, 5),
                                    "kernel": (3, 3), "stride": (2, 1),
                                    "pad": (1, 0)}, kind="sum", n=9))

# ---- indexing and sequences ------------------------------------------------------
add("take", Case([F(5, 3), FI(2, 4, lo=-2, hi=7)], kind="exact",
                 bwd="sum", n=8))
add("pick", Case([F(4, 5), FI(4, hi=5)], kind="exact"))
add("Embedding embedding", Case([FI(2, 3, hi=6), F(6, 4)],
                                {"input_dim": 6, "output_dim": 4},
                                kind="exact", bwd="sum", n=6))
add("one_hot", Case([FI(2, 3, lo=-1, hi=6)], {"depth": 5, "on_value": 2.0,
                                              "off_value": -0.5},
                    kind="exact"))
add("gather_nd", Case([F(3, 4, 2), FI(2, 5, hi=3)], kind="exact",
                      bwd="sum", n=5))
add("scatter_nd", Case([F(5, 2), UNIQUE_ND((3, 4), 5)],
                       {"shape": (3, 4, 2)}, kind="exact"))
add("SequenceMask sequence_mask",
    Case([F(5, 3, 2), C([2, 5, 1])], {"use_sequence_length": True,
                                       "value": -1.0}, kind="exact"))
add("SequenceLast sequence_last",
    Case([F(3, 5, 2), C([2, 5, 1])], {"use_sequence_length": True,
                                       "axis": 1}, kind="exact"))
add("SequenceReverse sequence_reverse",
    Case([F(5, 3, 2), C([2, 5, 1])], {"use_sequence_length": True},
         kind="exact"))
add("sort", Case([F(3, 5)], {"axis": 1, "is_ascend": False}, kind="exact"))
add("argsort", Case([F(3, 5)], {"axis": 1}, kind="exact"))
add("topk", Case([F(3, 5)], {"k": 2, "ret_typ": "both"}, kind="exact"))
add("_ravel_multi_index ravel_multi_index",
    Case([C([[1, 2, 0], [3, 0, 2]])], {"shape": (3, 4)}, kind="exact"))
add("_unravel_index unravel_index",
    Case([C([7, 0, 11, -1])], {"shape": (3, 4)}, kind="exact"))
add("all_finite", Case([C([[1.0, np.inf], [0.0, 2.0]])], kind="exact"))
add("multi_all_finite", Case([X, C([1.0, np.nan])], {"num_arrays": 2},
                             kind="exact"))
add("amp_cast", Case([X], {"dtype": "float16"}, kind="exact"))
add("amp_multicast", Case([X, I(3, 4)], {"num_outputs": 2}, kind="exact"))

# ---- loss heads, spatial ops ---------------------------------------------------------
add("SoftmaxOutput softmax_output", Case([F(4, 5), FI(4, hi=5)],
                                         kind="sum", n=5))
add("LinearRegressionOutput linear_regression_output "
    "MAERegressionOutput mae_regression_output",
    Case([F(4, 3), F(4, 3)], kind="exact"))
add("LogisticRegressionOutput logistic_regression_output",
    Case([F(4, 3), F(4, 3)]))
add("SVMOutput svm_output", Case([F(4, 5), FI(4, hi=5)], kind="sum", n=5))
add("UpSampling upsampling", Case([F(1, 2, 3, 3)], {"scale": 2,
                                                    "sample_type": "bilinear"},
                                  kind="sum", n=4))
add("BilinearSampler bilinear_sampler",
    Case([F(1, 2, 4, 5), F(1, 2, 3, 3, lo=-1.2, hi=1.2)], kind="sum",
         n=4))
add("GridGenerator grid_generator",
    Case([C([[0.9, 0.1, 0.05, -0.2, 1.1, 0.1]])], {"target_shape": (3, 4)},
         kind="sum", n=12))
add("SpatialTransformer spatial_transformer",
    Case([F(1, 2, 4, 5), C([[0.9, 0.1, 0.05, -0.2, 1.1, 0.1]])],
         {"target_shape": (3, 4)}, kind="sum", n=48))
add("_contrib_DeformableConvolution DeformableConvolution "
    "deformable_convolution",
    Case([F(1, 2, 5, 5), F(1, 18, 3, 3, lo=-1.5, hi=1.5), F(3, 2, 3, 3),
          F(3)], {"kernel": (3, 3), "num_filter": 3}, kind="sum", n=18))
add("box_iou _contrib_box_iou", Case([_boxes(4), _boxes(3)], kind="sum",
                                     n=4))
add("box_encode _contrib_box_encode",
    Case([C([[1, -1, 0, 1, 1, 0]]), C([[0, 2, 1, 1, 0, 2]]),
          _reshape(_boxes(6), (1, 6, 4)), _reshape(_boxes(3), (1, 3, 4))],
         kind="sum", n=4))
add("box_decode _contrib_box_decode",
    Case([F(1, 6, 4, lo=-0.3, hi=0.3), _reshape(_boxes(6), (1, 6, 4))],
         kind="sum", n=4))
add("bipartite_matching _contrib_bipartite_matching",
    Case([F(2, 5, 4, lo=0, hi=1)], {"threshold": 0.05}, kind="exact"))
add("box_nms _contrib_box_nms",
    Case([lambda rng: np.concatenate(
        [rng.randint(0, 3, (1, 12, 1)), rng.uniform(0, 1, (1, 12, 1)),
         _boxes(12, span=0.7, size=0.3)(rng)[None]], -1).astype(
             np.float32)], {"overlap_thresh": 0.5}, kind="sum", n=4))

# ---- image ops (HWC, NHWC batched) ------------------------------------------
add("_image_to_tensor image_to_tensor",
    Case([lambda rng: rng.randint(0, 256, (2, 6, 8, 3)).astype(np.uint8)]))
add("_image_normalize image_normalize",
    Case([F(2, 3, 6, 8)], {"mean": (0.5, -0.2, 0.1),
                           "std": (1.5, 0.7, 2.0)}))
# bilinear: 6 -> 9 rows (2 taps), 8 -> 5 columns (antialiased, <= 4 taps)
add("_image_resize image_resize",
    Case([F(2, 6, 8, 3, lo=0.0, hi=255.0)], {"size": (5, 9)}, kind="sum",
         n=8, terms=True))
add("_image_crop image_crop",
    Case([F(6, 8, 3)], {"x0": 1, "y0": 2, "width": 4, "height": 3},
         kind="exact"))
add("_image_flip_left_right image_flip_left_right _image_flip_up_down "
    "image_flip_up_down", Case([F(2, 6, 8, 3)], kind="exact"))

# ---- random draws (held by distribution, not by draw) ----------------------------
for _n in ("_random_uniform random_uniform _random_normal random_normal "
           "normal_op _random_randint _random_gamma _random_exponential "
           "_random_poisson _random_bernoulli _random_gumbel _random_laplace "
           "_random_negative_binomial _shuffle shuffle _sample_uniform "
           "sample_uniform _sample_normal sample_normal _sample_gamma "
           "sample_gamma _sample_exponential sample_exponential "
           "_sample_poisson sample_poisson _sample_negative_binomial "
           "sample_negative_binomial _sample_generalized_negative_binomial "
           "sample_generalized_negative_binomial "
           "_sample_multinomial").split():
    CASES[_n] = Case([], kind="random")

# ops a named check holds on the card at its main path's shapes
ELSEWHERE = {
    "FusedConvUnit": "phases 3 and 11 (kernels 1-2)",
    "FusedAttention": "phases 3c and 11 (kernel 5)",
    "dot_product_attention": "phases 3c and 11 (kernel 5)",
    "_contrib_dot_product_attention": "phases 3c and 11 (kernel 5)",
    "MultiBoxPrior": "phase 10 (SSD step)",
    "_contrib_MultiBoxPrior": "phase 10 (SSD step)",
    "MultiBoxTarget": "phase 10 (SSD step)",
    "_contrib_MultiBoxTarget": "phase 10 (SSD step)",
    "MultiBoxDetection": "phase 10 (detection)",
    "_contrib_MultiBoxDetection": "phase 10 (detection)",
    "Dropout": "phases 9 and 12 (dropout 0.1 on the card)",
    "dropout": "phases 9 and 12 (dropout 0.1 on the card)",
    "RNN": "phase 15 (a) (every mode, forward and backward)",
    "CTCLoss": "phase 15 (d) (T = 100, batch 32)",
    "ctc_loss": "phase 15 (d) (T = 100, batch 32)",
}
for _n in ("random_flip_left_right random_flip_up_down random_brightness "
           "random_contrast random_saturation").split():
    for _p in ("_image_", "image_"):
        ELSEWHERE[_p + _n] = \
            "phase 18 (d) (fixed factors on the card, the coins' share)"
for _n in ("sgd_update sgd_mom_update nag_mom_update mp_sgd_update "
           "mp_sgd_mom_update adam_update mp_adam_update rmsprop_update "
           "rmspropalex_update ftrl_update signsgd_update signum_update "
           "adagrad_update _sparse_adagrad_update adadelta_update "
           "adamax_update nadam_update lamb_update_phase1 lamb_update_phase2 "
           "multi_sum_sq multi_sgd_update multi_sgd_mom_update "
           "multi_mp_sgd_update multi_mp_sgd_mom_update "
           "preloaded_multi_sgd_update multi_lars").split():
    ELSEWHERE[_n] = "phase 13 (every update op, captured and eager)"
for _n in ("det inverse khatri_rao linalg_det linalg_extractdiag "
           "linalg_extracttrian linalg_gelqf linalg_gemm linalg_gemm2 "
           "linalg_inverse linalg_makediag linalg_maketrian linalg_potrf "
           "linalg_potri linalg_slogdet linalg_solve linalg_sumlogdiag "
           "linalg_syevd linalg_syrk linalg_trmm linalg_trsm moments "
           "slogdet solve").split():
    ELSEWHERE[_n] = "phase 16 (d) (every linalg name against float64)"
for _n in ("quantize quantize_v2 dequantize requantize quantized_conv "
           "quantized_fully_connected quantized_pooling quantized_flatten"
           ).split():
    for _p in ("", "_contrib_"):
        ELSEWHERE[_p + _n] = "phase 19 (a)-(d) (int8 kernel, quantized " \
            "ResNet-50, the example)"
for _n in ("_contrib_quantized_act", "_contrib_quantized_concat",
           "_contrib_quantized_elemwise_add"):
    ELSEWHERE[_n] = "raises by design (as the JAX op does)"
for _n in ("ROIPooling roi_pooling _contrib_ROIPooling ROIAlign "
           "_contrib_ROIAlign PSROIPooling _contrib_PSROIPooling "
           "Proposal _contrib_Proposal MultiProposal _contrib_MultiProposal "
           "BilinearResize2D _contrib_BilinearResize2D AdaptiveAvgPooling2D "
           "_contrib_AdaptiveAvgPooling2D boolean_mask _contrib_boolean_mask "
           "fft _contrib_fft ifft _contrib_ifft").split():
    ELSEWHERE[_n] = "phase 19 (b), (e) (R-CNN shapes, card against cpu)"
ELSEWHERE["Custom"] = "phase 20 (b) (a user's op at ResNet-50's head, " \
    "a hybridized block against the cpu)"
for _n in ELSEWHERE:
    CASES[_n] = Case([], kind="elsewhere")


def case_inputs(name: str, seed: int = 0):
    """The case's inputs as numpy arrays, drawn from a seed that depends
    on the op's name."""
    rng = np.random.RandomState(seed + zlib.crc32(name.encode()) % 100003)
    return [make(rng) for make in CASES[name].inputs]


def _as_tensors(arrays, dev):
    return [None if a is None else torch.from_numpy(np.array(a)).to(dev)
            for a in arrays]


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _run(fn, arrays, attrs, dev, differentiable, cts=None):
    """Forward on ``dev`` and, when ``cts`` is given, the gradient of
    every float input (zeros where the op does not reach it)."""
    ts = _as_tensors(arrays, dev)
    ins = [t for t in ts if t is not None and t.is_floating_point()]
    want_grad = differentiable and cts is not None
    with torch.enable_grad():
        for t in ins:
            t.requires_grad_(want_grad)
        outs = _outputs(fn(*ts, **attrs))
        if not want_grad:
            return [o.detach() for o in outs], []
        pairs = [(o, c) for o, c in zip(outs, cts)
                 if c is not None and o.requires_grad]
        gs = torch.autograd.grad(
            [o for o, _ in pairs], ins, [c.to(dev) for _, c in pairs],
            allow_unused=True) if pairs else [None] * len(ins)
    gs = [torch.zeros_like(t) if g is None else g for g, t in zip(gs, ins)]
    return [o.detach() for o in outs], [g.detach() for g in gs]


def ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| in ulps of want, the ulp taken at no less
    than 2^-10 of want's largest magnitude (NaN and inf must match)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    if same.all():
        return 0.0
    fin = np.isfinite(want)
    if not fin[~same].all():
        return math.inf
    mag = np.abs(want[fin]).max() if fin.any() else 0.0
    ftype = np.float32
    floor = max(mag * 2.0 ** -10, float(np.finfo(ftype).tiny))
    step = np.spacing(np.maximum(np.abs(want), floor).astype(ftype)) \
        .astype(np.float64)
    err = np.where(same, 0.0, np.abs(got - want) / step)
    return float(np.nan_to_num(err, nan=math.inf).max())


def sum_bound(want: np.ndarray, n: int, terms=None) -> np.ndarray:
    """2^-24·n·S plus one rounding of want, S the terms' magnitudes
    (elementwise) or want's largest magnitude."""
    want = np.asarray(want, np.float64)
    s = np.abs(terms) if terms is not None else \
        np.abs(want[np.isfinite(want)]).max(initial=0.0)
    return 2.0 ** -24 * (n * s + np.abs(want)) + np.finfo(np.float32).tiny


def _terms(fn, arrays, attrs):
    """The op on |inputs| in float64 on the CPU: the sum of the terms'
    magnitudes for a sum or a product of sums."""
    ts = [None if a is None else torch.from_numpy(
        np.abs(np.asarray(a, np.float64))) for a in arrays]
    return _outputs(fn(*ts, **attrs))


def _exact_equal(a, b):
    """The same shape, dtype and bits (any NaN equal to any NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        return bool(np.array_equal(a, b, equal_nan=True)
                    and np.array_equal(np.signbit(a), np.signbit(b)))
    return bool(np.array_equal(a, b))


def _hold(kind, got, want, n, terms=None):
    """(ok, measure) for one array: the measure is ulps for ``ulp``, the
    largest error over its bound for ``sum``, 0/1 mismatch for
    ``exact``."""
    if kind == "exact":
        ok = _exact_equal(got, want)
        return ok, 0.0 if ok else 1.0
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, math.inf
    if kind == "ulp":
        u = ulps(got, want)
        return u <= ULP_BOUND, u
    g64, w64 = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = (g64 == w64) | (np.isnan(g64) & np.isnan(w64))
    bound = sum_bound(want, n, terms)
    err = np.where(same, 0.0, np.abs(g64 - w64))
    ratio = float(np.nan_to_num(err / bound, nan=math.inf).max()) \
        if err.size else 0.0
    return ratio <= 1.0, ratio


def _np(t):
    return t.cpu().numpy() if t.dtype != torch.bfloat16 else \
        t.float().cpu().numpy()


def sweep(device, names=None, seed=0) -> Dict[str, dict]:
    """Every case on ``device`` against the same call on the CPU: the
    forward and, for a differentiable op, the gradient under a seeded
    cotangent.  Returns, per op name, its class, whether it held, and
    the worst measure of its forward and backward."""
    from ..ops.registry import get_op, list_ops

    names = list_ops() if names is None else names
    out = {}
    for name in names:
        case = CASES.get(name)
        if case is None:
            out[name] = {"kind": "missing", "ok": False}
            continue
        if case.kind in ("random", "elsewhere"):
            out[name] = {"kind": case.kind, "ok": True}
            continue
        op = get_op(name)
        arrays = case_inputs(name, seed)
        rec = {"kind": case.kind, "ok": True, "fwd": 0.0, "bwd": 0.0}
        try:
            want, _ = _run(op.fn, arrays, case.attrs, "cpu",
                           op.differentiable)
            rng = np.random.RandomState(seed + 1)
            cts = [torch.from_numpy(rng.standard_normal(w.shape).astype(
                np.float32)).to(w.dtype) if w.is_floating_point() else None
                for w in want]
            grad = op.differentiable
            want, gwant = _run(op.fn, arrays, case.attrs, "cpu", grad,
                               cts if grad else None)
            got, ggot = _run(op.fn, arrays, case.attrs, device, grad,
                             cts if grad else None)
            terms = _terms(op.fn, arrays, case.attrs) if case.terms \
                else [None] * len(want)
            for g, w, t in zip(got, want, terms):
                ok, m = _hold(case.kind, _np(g), _np(w), case.n,
                              None if t is None else _np(t))
                rec["ok"] &= ok
                rec["fwd"] = max(rec["fwd"], m)
            bkind = case.bwd or case.kind
            for g, w in zip(ggot, gwant):
                ok, m = _hold(bkind, _np(g), _np(w), case.n)
                rec["ok"] &= ok
                rec["bwd"] = max(rec["bwd"], m)
            rec["bwd_kind"] = bkind
        except Exception as e:  # noqa: BLE001 — reported per op
            rec.update(ok=False, error=f"{type(e).__name__}: {e}")
        out[name] = rec
    return out


def summary(results: Dict[str, dict]) -> Tuple[dict, dict]:
    """Counts per class and the worst measure per class with its op."""
    counts = {"held": 0, "exact": 0, "ulp": 0, "sum": 0, "random": 0,
              "elsewhere": 0, "failed": 0}
    worst = {"ulp": (0.0, None), "sum": (0.0, None)}
    for name, r in results.items():
        kind = r["kind"]
        if not r["ok"]:
            counts["failed"] += 1
            continue
        counts["held"] += 1
        counts[kind] = counts.get(kind, 0) + 1
        for part in ("fwd", "bwd"):
            k = kind if part == "fwd" else r.get("bwd_kind", kind)
            if k in worst and r.get(part, 0.0) > worst[k][0]:
                worst[k] = (r[part], f"{name} ({part})")
    return counts, worst
