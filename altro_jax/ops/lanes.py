"""Evaluate a per-lane JAX function on a block of lanes inside a kernel.

The Triton kernels hold one solve per lane (thread), so every scalar of a
solve is a `(BLOCK,)` vector and every small array is a NumPy object array
of such vectors (`LaneArray` below).  Triton tensors must have power-of-two
sizes and its concatenate takes two operands, so user code such as
`jnp.stack([v * cos(th), v * sin(th), w])` on an `[n, BLOCK]` array does
not lower.  Instead the user's function is traced once at its per-lane
shapes (`x [n]`, `u [m]`) and the jaxpr is interpreted here one array
element at a time: structural primitives (slice, reshape, concatenate,
transpose, broadcast, split) only rearrange the object array, elementwise
primitives are bound once per element on `(BLOCK,)` vectors, and small
contractions (`dot_general`, `reduce_*`) are unrolled into multiply-adds.

Elements are jax values of shape `()` or `(BLOCK,)`, or NumPy 0-d
constants; an elementwise primitive broadcasts its operands to the widest
of them.  A primitive outside the supported set raises
`NotImplementedError`, which the kernels turn into ineligibility at build
time (see `probe`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.extend import core as jex_core

LaneArray = np.ndarray  # dtype=object, elements () / (BLOCK,) jax values


def lane_array(elems, shape=None) -> LaneArray:
    """Object array from a (nested) list of elements without letting NumPy
    convert the jax values inside it."""
    flat = []

    def walk(e):
        if isinstance(e, (list, tuple)):
            for x in e:
                walk(x)
        else:
            flat.append(e)

    walk(elems)
    if shape is None:
        shape = []
        e = elems
        while isinstance(e, (list, tuple)):
            shape.append(len(e))
            e = e[0] if len(e) else None
    out = np.empty(len(flat), object)
    for i, e in enumerate(flat):
        out[i] = e
    return out.reshape(tuple(shape))


def is_const(e) -> bool:
    return isinstance(e, (np.ndarray, np.generic))


def dtype_of(e):
    return np.dtype(e.dtype) if hasattr(e, "dtype") else np.asarray(e).dtype


def const_array(val, dtype) -> LaneArray:
    """LaneArray of NumPy 0-d constants."""
    a = np.asarray(val, dtype)
    out = np.empty(a.shape, object)
    for idx in np.ndindex(a.shape):
        out[idx] = np.asarray(a[idx], dtype)
    return out


def _widen(elems):
    """Broadcast 0-d elements to the widest element shape."""
    shape = max((np.shape(e) for e in elems), key=len)
    if not shape:
        return elems
    return [
        e if np.shape(e) == shape else lax.broadcast_in_dim(e, shape, ())
        for e in elems
    ]


# NumPy forms of the elementwise primitives that fold constants; others
# fold through JAX at trace time
_NUMPY = {
    "add": np.add, "add_any": np.add, "sub": np.subtract,
    "mul": np.multiply, "div": np.divide, "neg": np.negative,
    "max": np.maximum, "min": np.minimum, "sin": np.sin, "cos": np.cos,
    "sqrt": np.sqrt, "exp": np.exp, "log": np.log, "abs": np.abs,
    "eq": np.equal, "ne": np.not_equal, "lt": np.less, "le": np.less_equal,
    "gt": np.greater, "ge": np.greater_equal, "square": np.square,
}


def _zero(e) -> bool:
    return is_const(e) and not np.any(e)


def _one(e) -> bool:
    return is_const(e) and bool(np.all(np.asarray(e) == 1))


def apply(prim, elems, params, out_dtype):
    """Bind `prim` on one element of each operand, folding constants and
    the structural zeros and ones that per-lane Jacobians are full of
    (x*0 is folded to 0 as for a structural zero, not by IEEE rules)."""
    name = prim.name
    if all(is_const(e) for e in elems):
        if name in _NUMPY:
            res = _NUMPY[name](*elems)
        elif name == "convert_element_type":
            res = elems[0]
        elif name == "integer_pow":
            res = np.power(elems[0], params["y"])
        else:
            with jax.ensure_compile_time_eval():
                res = np.asarray(prim.bind(*elems, **params))
        return np.asarray(res, out_dtype)
    if name in ("add", "add_any"):
        a, b = elems
        if _zero(a):
            return b
        if _zero(b):
            return a
    elif name == "sub":
        a, b = elems
        if _zero(b):
            return a
    elif name == "mul":
        a, b = elems
        if _zero(a) or _zero(b):
            return np.zeros((), out_dtype)
        if _one(a):
            return b
        if _one(b):
            return a
    elif name == "convert_element_type" and dtype_of(elems[0]) == out_dtype:
        return elems[0]
    return prim.bind(*_widen(list(elems)), **params)


def add(a, b):
    return apply(lax.add_p, (a, b), {}, _result_dtype(a, b))


def mul(a, b):
    return apply(lax.mul_p, (a, b), {}, _result_dtype(a, b))


def _result_dtype(a, b):
    return dtype_of(b) if is_const(a) else dtype_of(a)


def vec(e, width: int, dtype):
    """One element as a `(width,)` vector of `dtype` (kernel stores and
    loop carries need uniform vectors)."""
    if is_const(e):
        return jnp.full((width,), np.asarray(e, dtype))
    if e.dtype != dtype:
        e = e.astype(dtype)
    if e.shape != (width,):
        e = lax.broadcast_in_dim(e, (width,), ())
    return e


def _fold(op, elems):
    return functools.reduce(op, elems)


# ----------------------------------------------------------------- rules
def _elementwise_rule(prim, outvars, args, params):
    shape = outvars[0].aval.shape
    args = [np.broadcast_to(a, shape) for a in args]
    dtype = outvars[0].aval.dtype
    out = np.empty(shape, object)
    for idx in np.ndindex(shape):
        out[idx] = apply(prim, [a[idx] for a in args], params, dtype)
    return [out]


def _broadcast_in_dim(a, *, shape, broadcast_dimensions, **_):
    out = np.empty(shape, object)
    for idx in np.ndindex(shape):
        src = tuple(
            0 if a.shape[i] == 1 else idx[d]
            for i, d in enumerate(broadcast_dimensions)
        )
        out[idx] = a[src]
    return out


def _reshape(a, *, new_sizes, dimensions=None, **_):
    if dimensions is not None:
        raise NotImplementedError("reshape with dimensions")
    return a.reshape(new_sizes)


def _slice(a, *, start_indices, limit_indices, strides=None):
    strides = strides or (1,) * a.ndim
    return a[tuple(slice(s, l, st) for s, l, st in
                   zip(start_indices, limit_indices, strides))]


def _split(a, *, sizes, axis):
    cuts = np.cumsum(sizes)[:-1]
    return np.split(a, cuts, axis=axis)


def _dot_general(lhs, rhs, *, dimension_numbers, out_dtype):
    (lc, rc), (lb, rb) = dimension_numbers
    lf = [d for d in range(lhs.ndim) if d not in lc and d not in lb]
    rf = [d for d in range(rhs.ndim) if d not in rc and d not in rb]
    bshape = [lhs.shape[d] for d in lb]
    lshape = [lhs.shape[d] for d in lf]
    rshape = [rhs.shape[d] for d in rf]
    nb, nl, nr = (int(np.prod(s)) for s in (bshape, lshape, rshape))
    nc = int(np.prod([lhs.shape[d] for d in lc]))
    a = lhs.transpose(list(lb) + lf + list(lc)).reshape(nb, nl, nc)
    b = rhs.transpose(list(rb) + rf + list(rc)).reshape(nb, nr, nc)
    out = np.empty((nb, nl, nr), object)
    for i in range(nb):
        for j in range(nl):
            for k in range(nr):
                if nc == 0:
                    out[i, j, k] = np.asarray(0, out_dtype)
                else:
                    out[i, j, k] = _fold(
                        add, [mul(a[i, j, c], b[i, k, c]) for c in range(nc)]
                    )
    out = out.reshape(bshape + lshape + rshape)
    if out.size and dtype_of(out.flat[0]) != np.dtype(out_dtype):
        out = _map(lambda e: lax.convert_element_type(e, out_dtype), out)
    return out


def _map(fn, a):
    out = np.empty(a.shape, object)
    for idx in np.ndindex(a.shape):
        out[idx] = fn(a[idx])
    return out


def _reduce(op, a, axes):
    keep = [d for d in range(a.ndim) if d not in axes]
    r = a.transpose(keep + list(axes))
    r = r.reshape([a.shape[d] for d in keep] + [-1])
    out = np.empty(r.shape[:-1], object)
    for idx in np.ndindex(out.shape):
        out[idx] = _fold(op, list(r[idx]))
    return out


def _minimum(a, b):
    return apply(lax.min_p, (a, b), {}, _result_dtype(a, b))


def _maximum(a, b):
    return apply(lax.max_p, (a, b), {}, _result_dtype(a, b))


def _iota(*, dtype, shape, dimension, **_):
    a = np.broadcast_to(
        np.arange(shape[dimension]).reshape(
            [-1 if d == dimension else 1 for d in range(len(shape))]
        ),
        shape,
    )
    return const_array(a, dtype)


def _dynamic_slice(a, *idx, slice_sizes):
    starts = []
    for d, i in enumerate(idx):
        if not (isinstance(i, np.ndarray) and i.shape == ()
                and isinstance(i[()], np.ndarray)):
            raise NotImplementedError("dynamic_slice with traced indices")
        s = int(np.clip(int(i[()]), 0, a.shape[d] - slice_sizes[d]))
        starts.append(slice(s, s + slice_sizes[d]))
    return a[tuple(starts)]


_STRUCTURAL = {
    "broadcast_in_dim": lambda a, **p: [_broadcast_in_dim(a, **p)],
    "reshape": lambda a, **p: [_reshape(a, **p)],
    "slice": lambda a, **p: [_slice(a, **p)],
    "concatenate": lambda *a, dimension: [np.concatenate(a, axis=dimension)],
    "split": lambda a, **p: _split(a, **p),
    "transpose": lambda a, permutation: [a.transpose(permutation)],
    "rev": lambda a, dimensions: [np.flip(a, axis=dimensions)],
    "reduce_sum": lambda a, axes, **_: [_reduce(add, a, axes)],
    "reduce_max": lambda a, axes, **_: [_reduce(_maximum, a, axes)],
    "reduce_min": lambda a, axes, **_: [_reduce(_minimum, a, axes)],
    "reduce_prod": lambda a, axes, **_: [_reduce(mul, a, axes)],
    "iota": lambda **p: [_iota(**p)],
    "dynamic_slice": lambda a, *i, slice_sizes: [
        _dynamic_slice(a, *i, slice_sizes=slice_sizes)
    ],
}

# primitives whose operands and result share a shape but that are not
# elementwise; they must never reach the generic rule
_NOT_ELEMENTWISE = {
    "cumsum", "cumprod", "cummax", "cummin", "cumlogsumexp", "sort",
    "argsort", "gather", "scatter", "scatter-add", "scatter_add",
    "dynamic_update_slice", "pad", "while", "cond", "scan", "argmax",
    "argmin", "top_k",
}


def _broadcasts(shape, out_shape) -> bool:
    """Operand shape an elementwise primitive broadcasts to `out_shape`
    (a scalar, or the same rank with size-1 axes)."""
    return len(shape) == 0 or (
        len(shape) == len(out_shape)
        and all(s in (1, o) for s, o in zip(shape, out_shape))
    )


_CALL_JAXPR_PARAMS = ("jaxpr", "call_jaxpr", "fun_jaxpr")


def _inner_jaxpr(eqn):
    for key in _CALL_JAXPR_PARAMS:
        j = eqn.params.get(key)
        if j is not None:
            if isinstance(j, jex_core.ClosedJaxpr):
                return j.jaxpr, j.consts
            return j, ()
    return None


def eval_jaxpr(jaxpr, consts, *args) -> list:
    """Interpret `jaxpr` with every operand a LaneArray."""
    env = {}

    def read(v):
        if isinstance(v, jex_core.Literal):
            return const_array(v.val, v.aval.dtype)
        return env[v]

    for v, c in zip(jaxpr.constvars, consts):
        env[v] = const_array(c, v.aval.dtype)
    for v, a in zip(jaxpr.invars, args):
        if tuple(a.shape) != tuple(v.aval.shape):
            raise ValueError(f"lane array shape {a.shape} != {v.aval.shape}")
        env[v] = a
    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        name = eqn.primitive.name
        inner = _inner_jaxpr(eqn)
        if name == "squeeze":  # the output aval gives the shape
            outs = [ins[0].reshape(eqn.outvars[0].aval.shape)]
        elif name == "dot_general":
            outs = [_dot_general(
                ins[0], ins[1],
                dimension_numbers=eqn.params["dimension_numbers"],
                out_dtype=eqn.outvars[0].aval.dtype,
            )]
        elif name in _STRUCTURAL:
            outs = _STRUCTURAL[name](*ins, **eqn.params)
        elif inner is not None and name not in _NOT_ELEMENTWISE:
            outs = eval_jaxpr(inner[0], inner[1], *ins)
        elif (
            name not in _NOT_ELEMENTWISE
            and len(eqn.outvars) == 1
            and all(
                _broadcasts(v.aval.shape, eqn.outvars[0].aval.shape)
                for v in eqn.invars
            )
        ):
            outs = _elementwise_rule(eqn.primitive, eqn.outvars, ins, eqn.params)
        else:
            raise NotImplementedError(
                f"primitive {name!r} has no per-lane rule: {eqn}"
            )
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
    return [read(v) for v in jaxpr.outvars]


def _aval_of(a: LaneArray):
    dtype = dtype_of(a.flat[0]) if a.size else np.float32
    return jax.ShapeDtypeStruct(a.shape, dtype)


def call(fn, *args):
    """`fn(*args)` with every array leaf of `args` a LaneArray; returns the
    output pytree with LaneArray leaves."""
    flat, tree = jax.tree_util.tree_flatten(args)
    avals = [_aval_of(a) for a in flat]
    closed, out_shape = jax.make_jaxpr(
        lambda *fl: fn(*jax.tree_util.tree_unflatten(tree, fl)),
        return_shape=True,
    )(*avals)
    outs = eval_jaxpr(closed.jaxpr, closed.consts, *flat)
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(out_shape), outs
    )


def probe(fn, *shaped_args, width: int = 2):
    """Check that `fn` has a per-lane rule for every primitive it uses:
    `shaped_args` are pytrees of ShapeDtypeStruct (per-lane shapes).
    Raises NotImplementedError otherwise.  Nothing is executed."""

    def run(*vecs):
        it = iter(vecs)
        args = jax.tree_util.tree_map(
            lambda s: _map(lambda _: next(it), np.empty(s.shape, object)),
            shaped_args,
        )
        return jax.tree_util.tree_leaves(call(fn, *args))

    leaves = jax.tree_util.tree_leaves(shaped_args)
    vecs = [
        jax.ShapeDtypeStruct((width,), s.dtype)
        for s in leaves
        for _ in range(int(np.prod(s.shape)))
    ]
    jax.eval_shape(lambda *v: [list(o.flat) for o in run(*v)], *vecs)
