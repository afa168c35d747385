"""The O1 casting engine: an eager precision rewriter (port of
``apex_tpu.amp.wrap``).

The reference traces the unmodified function to a jaxpr and evaluates it
again with per-primitive dtype rules.  An eager program has no trace, so
:func:`auto_cast` runs the unmodified function under a
``torch.overrides.TorchFunctionMode`` that is active only inside the
wrapped call, and classes every torch function and Tensor method it
sees by :mod:`apex_tpu_torch.amp.lists`:

- HALF (the contractions): the float operands are cast to the compute
  dtype and the result comes back in it (an f32 result the caller asked
  for is dropped, as ``_half_params`` drops ``preferred_element_type``);
  a bias or an ``addmm`` input is added after, with promotion.  The
  function runs on the half operands on either device.
- FP32: the float operands are cast to f32.
- everything else promotes mixed float operands to the widest dtype
  present; a Python constant is a literal of the *traced* dtype (see
  below), so ``h * 2.0`` on a half ``h`` traced at f32 comes back f32.

The mode sits above autograd, so every cast it adds is differentiated.

**Traced dtypes.**  The reference knows, for every value, the dtype it
had when the function was traced (before the rewrite).  The engine keeps
the same fact eagerly: the mode holds a table (weak in its keys) of the
values whose dtype the rewrite changed, with their traced dtypes, and
drops it when the wrapped call returns, so a value that leaves the call
is plain again.  The table decides three things, as in the reference:
the program reads ``t.dtype`` as the traced dtype (as a traced program
reads its avals), a dtype conversion to the traced dtype is a no-op
(the trace holds no ``convert_element_type`` for it), and an opaque op
runs on operands cast back to their traced dtypes.

**Opaque ops.**  Every ``torch.autograd.Function`` is opaque, as every
``custom_vjp`` and ``pallas_call`` is in the reference: while the mode is
active, ``Function.apply`` casts the operands back to their traced dtypes
and runs the function with the mode suspended.  A user's Function whose
body runs HALF ops warns once per distinct op; the port's own kernels
never warn.  A Function whose class sets ``amp_o1 = "half"`` is a HALF
op instead (``models.bert._MatmulF32Out``: the reference's plain
``dot_general(preferred_element_type=f32)``).

The reference's ``scan`` / ``while`` / ``cond`` rewrites have no eager
counterpart: a Python loop's ops reach the mode one at a time.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Any, Callable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.weak import WeakIdKeyDictionary

from apex_tpu_torch._tree import tree_map
from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp.policies import Policy

# the op names that take no promotion: in-place, shape-only, and
# factories that copy only a dtype or a shape
_NO_PROMOTE = frozenset({
    "__setitem__", "__set__", "expand_as", "view_as", "reshape_as",
    "new_zeros", "new_ones", "new_empty", "new_full", "new_tensor",
    "zeros_like", "ones_like", "empty_like", "full_like", "rand_like",
    "randn_like", "randint_like", "__iadd__", "__isub__", "__imul__", "__itruediv__", "__idiv__",
    "__ipow__", "__ifloordiv__", "__imod__", "__iand__", "__ior__",
})

_ACTIVE: list = []          # the O1 modes entered, innermost last
_OPAQUE_WARNED: set = set()


def traced_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype ``t`` would have had without the rewrite (its own dtype
    outside an O1 call)."""
    for mode in reversed(_ACTIVE):
        d = mode.traced.get(t)
        if d is not None:
            return d
    return t.dtype


def _rewritten(t: torch.Tensor) -> bool:
    return any(t in mode.traced for mode in _ACTIVE)


def active() -> bool:
    """True inside an O1-wrapped call, outside the body of an opaque
    ``autograd.Function``: the engine's rules apply to the next op."""
    return (bool(_ACTIVE) and not _ACTIVE[-1].opaque
            and torch._C._is_torch_function_mode_enabled())


_KINDS: dict = {}                     # op name -> lists.classify(name)
# names whose class depends on their arguments
_RECLASSED = lists.POW_FUNCS | {lists.GELU}


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _float_tensors(args, kwargs):
    out = []
    for group in (args, kwargs.values()) if kwargs else (args,):
        for a in group:
            if isinstance(a, torch.Tensor):
                if a.is_floating_point():
                    out.append(a)
            elif type(a) in (list, tuple):
                out.extend(t for t in a if _is_float(t))
    return out


def _map_floats(fn, args, kwargs):
    def one(a):
        if _is_float(a):
            return fn(a)
        if isinstance(a, (list, tuple)) and any(_is_float(t) for t in a):
            return type(a)(fn(t) if _is_float(t) else t for t in a)
        return a
    return (tuple(one(a) for a in args),
            {k: one(v) for k, v in kwargs.items()})


def _has_number(args, kwargs) -> bool:
    return any(isinstance(a, (int, float)) and not isinstance(a, bool)
               for a in (*args, *kwargs.values()))


def _widest(dtypes):
    return functools.reduce(torch.promote_types, dtypes)


def _mark(out, traced):
    """Record ``traced`` for every float tensor of ``out`` whose dtype
    the rewrite changed (``out`` a tensor, or a tuple of them), in the
    innermost mode's table."""
    if traced is None or not _ACTIVE:
        return
    table = _ACTIVE[-1].traced
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if _is_float(t) and t.dtype != traced:
            table[t] = traced


def _cast(dtype):
    return lambda t: t if t.dtype == dtype else t.to(dtype)


def _conversion_target(func_name, args, kwargs) -> Optional[torch.dtype]:
    if func_name == "float":
        return torch.float32
    if func_name == "double":
        return torch.float64
    if func_name == "half":
        return torch.float16
    if func_name == "bfloat16":
        return torch.bfloat16
    if func_name == "type_as":
        return traced_dtype(args[1])
    for a in (*args[1:], kwargs.get("dtype"), kwargs.get("other")):
        if isinstance(a, torch.dtype):
            return a
        if isinstance(a, torch.Tensor):
            return traced_dtype(a)
    return None


def _without_dtype(func_name, args, kwargs):
    """``args``/``kwargs`` of a ``to`` call with the dtype dropped (the
    device and the flags kept); None when nothing is left to do."""
    if func_name != "to":
        return None
    rest = tuple(a for a in args[1:] if not isinstance(a, torch.dtype))
    kw = {k: v for k, v in kwargs.items() if k != "dtype"}
    if any(isinstance(a, torch.Tensor) for a in rest):
        return None
    if not rest and "device" not in kw:
        return None
    return (args[0],) + rest, kw


class _O1Mode(TorchFunctionMode):
    """The per-op rules of :func:`auto_cast` (see the module docstring)."""

    def __init__(self, half: torch.dtype):
        super().__init__()
        self.half = half
        self.traced = WeakIdKeyDictionary()   # tensor -> traced dtype
        self.opaque = 0          # depth inside an autograd.Function body
        self.saw_half = False    # a HALF op ran inside that body

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if self.opaque:
            if name in lists.HALF_FUNCS:
                self.saw_half = True
            return func(*args, **kwargs)
        if name == "__get__":
            # the program reads the traced dtype, as a traced program
            # reads its avals' dtype
            if getattr(getattr(func, "__self__", None), "__name__",
                       None) == "dtype":
                return traced_dtype(args[0])
            return func(*args, **kwargs)
        if (name in _NO_PROMOTE or kwargs.get("out") is not None
                or (name.endswith("_") and not name.endswith("__"))):
            return func(*args, **kwargs)
        kind = _KINDS.get(name)
        if kind is None:
            kind = _KINDS[name] = lists.classify(name)
        if kind == "convert":
            return self._convert(func, name, args, kwargs)
        floats = _float_tensors(args, kwargs)
        if not floats:
            return func(*args, **kwargs)
        if (kind not in ("half", "fp32") and name not in _RECLASSED
                and "dtype" not in kwargs):
            # one float dtype and nothing rewritten: nothing to promote,
            # the traced dtype is the real one
            d0 = floats[0].dtype
            if all(t.dtype == d0 and not _rewritten(t) for t in floats):
                return func(*args, **kwargs)
        traced = _widest([traced_dtype(t) for t in floats])
        if isinstance(kwargs.get("dtype"), torch.dtype):
            traced = kwargs["dtype"]
        if name == lists.GELU:
            kind = ("literal" if kwargs.get("approximate", "none") == "tanh"
                    else "fp32")
        elif name in lists.POW_FUNCS:
            exp = args[1] if len(args) > 1 else kwargs.get("exponent")
            kind = ("promote" if isinstance(exp, int)
                    and not isinstance(exp, bool) and name != "__rpow__"
                    else "fp32")
        elif kind == "scalar":
            kind = "literal" if _has_number(args, kwargs) else "promote"

        if kind == "half":
            out = self._half(func, name, args, kwargs)
        elif kind == "fp32":
            args, kwargs = _map_floats(_cast(torch.float32), args, kwargs)
            out = func(*args, **kwargs)
        else:
            dts = {t.dtype for t in floats}
            if kind == "literal":
                dts.add(traced)
            if len(dts) > 1:
                args, kwargs = _map_floats(_cast(_widest(dts)), args,
                                           kwargs)
            out = func(*args, **kwargs)
        _mark(out, traced)
        return out

    def _half(self, func, name, args, kwargs):
        args, kwargs = list(args), dict(kwargs)
        addend, beta = None, 1
        pos, kw = lists.HALF_ADDEND.get(name, (None, None))
        if kw in kwargs:
            addend = kwargs.pop(kw)
        elif pos is not None and len(args) > pos:
            addend, args[pos] = args[pos], None
        if kw == "input":
            # addmm-family: the product alone, the input added after
            beta = kwargs.pop("beta", 1)
            ref = args[1]
            args[0] = torch.zeros((), dtype=self.half, device=ref.device)
            kwargs["beta"] = 0
        args, kwargs = _map_floats(_cast(self.half), args, kwargs)
        out = func(*args, **kwargs)
        if addend is None:
            return out
        if kw == "input":
            return out + (addend if beta == 1 else addend * beta)
        if name.startswith("conv"):
            addend = addend.reshape((-1,) + (1,) * (out.dim() - 2))
        return out + addend

    def _convert(self, func, name, args, kwargs):
        target = _conversion_target(name, args, kwargs)
        src = args[0]
        if (target is None or not target.is_floating_point
                or not _is_float(src) or traced_dtype(src) != target
                or kwargs.get("copy")):
            out = func(*args, **kwargs)
            if target is not None and _is_float(out) and out is not src:
                _mark(out, target)
            return out
        # the trace holds no conversion: keep the rewritten dtype
        rest = _without_dtype(name, args, kwargs)
        if rest is None:
            return src
        out = func(*rest[0], **rest[1])
        _mark(out, target)
        return out


# ---- autograd.Function: opaque while a mode is active ----------------------

_ORIG_APPLY = torch.autograd.Function.__dict__["apply"]
_HOOK_DEPTH = [0]


def _operand_sig(args):
    return tuple((tuple(a.shape), str(a.dtype)) for a in args
                 if isinstance(a, torch.Tensor))


def _apply(cls, *args, **kwargs):
    mode = _ACTIVE[-1] if _ACTIVE else None
    if (mode is None or mode.opaque
            or not torch._C._is_torch_function_mode_enabled()):
        return _ORIG_APPLY.__func__(cls, *args, **kwargs)
    rule = getattr(cls, "amp_o1", "opaque")
    with torch._C.DisableTorchFunction():
        floats = _float_tensors(args, kwargs)
        traced = (_widest([traced_dtype(t) for t in floats]) if floats
                  else None)
        if rule == "half":
            args, kwargs = _map_floats(_cast(mode.half), args, kwargs)
        else:
            args, kwargs = _map_floats(
                lambda t: _cast(traced_dtype(t))(t), args, kwargs)
        sig = _operand_sig(args)
    mode.opaque += 1
    outer, mode.saw_half = mode.saw_half, False
    try:
        out = _ORIG_APPLY.__func__(cls, *args, **kwargs)
    finally:
        mode.opaque -= 1
        saw, mode.saw_half = mode.saw_half, outer
    if rule == "half":
        with torch._C.DisableTorchFunction():
            out = tree_map(lambda t: _cast(mode.half)(t)
                           if _is_float(t) else t, out)
            _mark(out, traced)
    elif saw and not cls.__module__.startswith("apex_tpu_torch."):
        _warn_opaque(cls, sig)
    return out


def _warn_opaque(cls, sig) -> None:
    """A user's Function whose body runs HALF ops runs them unrewritten
    under O1: say so, once per distinct (Function, operands)."""
    key = (cls, sig)
    if key in _OPAQUE_WARNED:
        return
    _OPAQUE_WARNED.add(key)
    warnings.warn(
        f"amp O1: autograd.Function '{cls.__qualname__}' (operands "
        f"{[s for s, _ in sig]}) is opaque to the casting engine but its "
        "body runs matmul/conv ops that would otherwise run in the "
        "compute dtype; they run at their traced (likely f32) precision. "
        "Cast its inputs explicitly, or apply apex_tpu_torch.amp."
        "auto_cast inside the function, to opt those ops into mixed "
        "precision.", stacklevel=3)


@contextlib.contextmanager
def _function_hook():
    """``torch.autograd.Function.apply`` routed through :func:`_apply`
    for as long as any O1 mode is entered."""
    if _HOOK_DEPTH[0] == 0:
        torch.autograd.Function.apply = classmethod(_apply)
    _HOOK_DEPTH[0] += 1
    try:
        yield
    finally:
        _HOOK_DEPTH[0] -= 1
        if _HOOK_DEPTH[0] == 0:
            torch.autograd.Function.apply = _ORIG_APPLY


def auto_cast(fn: Callable, policy: Optional[Policy] = None,
              compute_dtype: Any = None) -> Callable:
    """Wrap ``fn`` so listed ops run at the policy's precision: the O1
    engine over an unmodified callable (a model's forward, a loss).

    Returns ``fn`` itself when the compute dtype is f32."""
    half = (compute_dtype if compute_dtype is not None
            else (policy.compute_dtype if policy is not None
                  else torch.bfloat16))
    if half == torch.float32:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mode = _O1Mode(half)
        with _function_hook(), mode:
            _ACTIVE.append(mode)
            try:
                return fn(*args, **kwargs)
            finally:
                _ACTIVE.pop()
                mode.traced.clear()

    return wrapped


def cast_inputs(fn: Callable, dtype, argnums=None) -> Callable:
    """O2/O3 forward patch: cast floating tensor inputs to the model
    dtype (only the positional args in ``argnums`` when given: the data
    inputs, not the params or state)."""
    def cast(x):
        return x.to(dtype) if _is_float(x) else x

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if argnums is None:
            args = tree_map(cast, args)
            kwargs = tree_map(cast, kwargs)
        else:
            args = tuple(tree_map(cast, a) if i in argnums else a
                         for i, a in enumerate(args))
        return fn(*args, **kwargs)

    return wrapped
