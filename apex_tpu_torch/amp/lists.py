"""amp O1 op classification, as data (port of ``apex_tpu.amp.lists``).

The reference's tables classify jax *primitives*: ``HALF_PRIMS`` (the
contractions) run in the compute dtype, ``FP32_PRIMS`` (exp, log, the
roots, the sums) run in f32, and every other primitive promotes mixed
float operands to the widest dtype present.  The port's engine
(:mod:`apex_tpu_torch.amp.wrap`) sees *torch functions and Tensor
methods*, which are composites, so each name below is classed by the
dtype that the reference's rewrite gives its decomposition, not by
upstream apex's ``FP32_FUNCS``:

- :data:`HALF_FUNCS`: the function is a ``dot_general`` or a
  ``conv_general_dilated`` (a bias, where it takes one, is a separate
  ``add`` after it and promotes).
- :data:`FP32_FUNCS`: its result comes out of a pinned primitive (a
  ``reduce_sum``, an ``exp``, a ``log``, an ``rsqrt``...), so it is f32.
  ``mean``, ``var``, ``softmax``, ``layer_norm`` and the BatchNorm
  statistics are here; tanh-GELU is not (see :data:`LITERAL_FUNCS`).
- :data:`LITERAL_FUNCS`: elementwise functions whose decomposition
  combines the input with a Python constant (``relu`` is ``max(x,
  0.0)``, tanh-GELU multiplies by ``0.5`` and ``0.0447...``).  A
  constant is a literal of the *traced* dtype, so a half value traced
  at f32 widens back to f32, while one traced in the half dtype stays.
- :data:`SCALAR_OPERAND_FUNCS`: arithmetic whose Python-number
  arguments are such literals (``h * 2.0``).
- everything else keeps torch's promotion, with the reference's rule
  for mixed float operands (``_promote_floats``): all widen to the
  widest, a 0-d tensor included.

``pow`` is FP32 unless its exponent is a Python int (``integer_pow``,
which keeps its dtype); ``reciprocal`` and ``square`` are
``integer_pow`` too.
"""

from __future__ import annotations

# contractions: dot_general / conv_general_dilated
HALF_FUNCS = frozenset({
    "linear", "matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "mv",
    "dot", "vdot", "inner", "addmm", "addmv", "addbmm", "baddbmm",
    "einsum", "tensordot", "bilinear",
    "conv1d", "conv2d", "conv3d",
    "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
})

# the additive operand of a HALF function: (position, keyword); it is
# added after the contraction with promotion, as the reference's
# decomposition adds it
HALF_ADDEND = {
    "linear": (2, "bias"), "bilinear": (3, "bias"),
    "conv1d": (2, "bias"), "conv2d": (2, "bias"), "conv3d": (2, "bias"),
    "conv_transpose1d": (2, "bias"), "conv_transpose2d": (2, "bias"),
    "conv_transpose3d": (2, "bias"),
    "addmm": (0, "input"), "addmv": (0, "input"),
    "addbmm": (0, "input"), "baddbmm": (0, "input"),
}

# results of pinned primitives (reduce_sum, exp, log, rsqrt, erf, ...)
FP32_FUNCS = frozenset({
    # reductions through reduce_sum / reduce_prod / cumulative sums
    "sum", "nansum", "prod", "mean", "nanmean", "var", "std", "var_mean",
    "std_mean", "cumsum", "cumprod", "logcumsumexp", "logsumexp", "norm",
    "vector_norm", "matrix_norm", "linalg_vector_norm", "linalg_norm",
    "linalg_matrix_norm", "normalize", "cosine_similarity",
    "pairwise_distance", "cdist", "dist", "renorm",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    # exp / log / roots / special functions
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "erf", "erfc", "erfinv", "lgamma", "digamma", "sigmoid",
    "logsigmoid", "logit", "tan", "asin", "acos", "atan", "atan2",
    "arcsin", "arccos", "arctan", "arctan2", "sinh", "cosh", "asinh",
    "acosh", "atanh", "arcsinh", "arccosh", "arctanh",
    "silu", "softplus", "mish", "elu", "selu", "celu", "glu",
    # softmax and the norms (exp + reduce_sum, mean + rsqrt)
    "softmax", "log_softmax", "softmin", "layer_norm", "rms_norm",
    "group_norm", "batch_norm", "instance_norm", "local_response_norm",
    # losses (log / exp / mean)
    "cross_entropy", "nll_loss", "mse_loss", "l1_loss", "smooth_l1_loss",
    "huber_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "poisson_nll_loss",
    "soft_margin_loss", "cosine_embedding_loss", "margin_ranking_loss",
    "hinge_embedding_loss", "triplet_margin_loss", "multi_margin_loss",
    "multilabel_margin_loss", "multilabel_soft_margin_loss",
    "gaussian_nll_loss",
})

# elementwise functions with an implicit Python constant
LITERAL_FUNCS = frozenset({
    "relu", "relu6", "leaky_relu", "hardtanh", "threshold",
    "hardsigmoid", "hardswish", "dropout", "dropout1d", "dropout2d",
    "dropout3d", "alpha_dropout", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "softsign", "tanhshrink", "softshrink", "hardshrink",
})

# arithmetic whose Python-number arguments are operands
SCALAR_OPERAND_FUNCS = frozenset({
    "add", "__add__", "__radd__", "sub", "subtract", "__sub__",
    "__rsub__", "rsub", "mul", "multiply", "__mul__", "__rmul__", "div",
    "divide", "true_divide", "__truediv__", "__rtruediv__",
    "__div__", "__rdiv__", "floor_divide", "__floordiv__",
    "__rfloordiv__", "remainder", "__mod__", "__rmod__", "fmod", "clamp",
    "clip", "clamp_min", "clamp_max", "where", "masked_fill", "lerp",
    "addcmul", "addcdiv", "maximum", "minimum", "fmax", "fmin",
    "__pow__", "__rpow__", "pow", "float_power",
})

# pow: FP32 (lax.pow) unless the exponent is a Python int
POW_FUNCS = frozenset({"pow", "__pow__", "__rpow__", "float_power"})

# tanh-GELU is literal-widening, erf-GELU is FP32 (erf / erfc)
GELU = "gelu"

# dtype conversions: a no-op when the value's traced dtype already is
# the target (the reference's trace then holds no convert_element_type)
CONVERT_FUNCS = frozenset({"to", "float", "double", "half", "bfloat16",
                           "type", "type_as"})


def classify(name: str) -> str:
    """The class of a torch function or Tensor method by its name:
    ``"half"``, ``"fp32"``, ``"literal"``, ``"scalar"``, ``"convert"``
    or ``"promote"``."""
    if name in HALF_FUNCS:
        return "half"
    if name in FP32_FUNCS:
        return "fp32"
    if name in LITERAL_FUNCS or name == GELU:
        return "literal"
    if name in SCALAR_OPERAND_FUNCS:
        return "scalar"
    if name in CONVERT_FUNCS:
        return "convert"
    return "promote"
