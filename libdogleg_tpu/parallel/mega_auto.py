"""Selection of the whole-solve megakernel for `batched_optimize`.

`batched_optimize` hands a batch to the megakernel (ops/pallas_mega.py)
when the regime is the kernel's: a GPU backend, a single (B, n <= 16)
float32 state batch of any size, no history and no custom Newton
strategy, a dense (n, n) JtJ, and a products function
made only of the primitives the lane interpreter below covers. Every one
of these is checked before anything is compiled. Once the kernel is
chosen, a lowering or compile fault raises: nothing falls back.

The user's ordinary per-element products function is adapted to the
kernel's lane form by re-evaluating its jaxpr with every per-element
array held as a numpy OBJECT array of the same shape. An entry is either
a concrete numpy scalar (constants, and everything computed only from
them) or a lane vector, the values of that entry for every problem of
the tile. Data movement (reshape, slice, gather with constant indices,
...) is done on the object arrays at trace time; arithmetic is done entry
by entry on lanes. The kernel therefore contains only lane-vector
arithmetic on power-of-two shapes, which is what the Triton route lowers,
and constants fold into it as literals. A dot_general's precision is
not read: the kernel computes every product in float32 (on a GPU, XLA
forms a default-precision f32 matrix product in TF32). Where the
products compute per-measurement rows and contract them away, the
measurement axis is rolled into one loop instead of unrolled (see
"rolling" below).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.extend.core import Literal

from libdogleg_tpu.params import DoglegParameters

# The kernel unrolls all linear algebra over Nstate.
MEGA_MAX_N = 16
# The interpreter unrolls every per-element array, so its products code
# grows with the measurement count; the GPU compile of the kernel grows
# faster than that. Products that unroll to more lane operations than
# this run on the XLA path. On an H100 the first call took 43 s at 1,626
# lane operations and 94 s at 3,415; 11,074 did not compile in 12 min
# (PERF.md).
MAX_LANE_OPS = 4096


def _is_lane(e) -> bool:
    return not isinstance(e, (np.generic, np.ndarray))


# Primitives with one output entry per input entry.
_ELEMENTWISE = frozenset({
    "add", "sub", "mul", "div", "rem", "pow", "atan2", "max", "min",
    "and", "or", "xor", "not", "neg", "sign", "floor", "ceil", "round",
    "abs", "sqrt", "rsqrt", "cbrt", "exp", "exp2", "expm1", "log",
    "log1p", "logistic", "tanh", "tan", "sin", "cos", "asin", "acos",
    "atan", "sinh", "cosh", "asinh", "acosh", "atanh", "erf", "erfc",
    "erf_inv", "is_finite", "integer_pow", "square", "reciprocal",
    "eq", "ne", "lt", "le", "gt", "ge", "select_n", "clamp",
    "convert_element_type", "nextafter", "copy", "copy_p",
})


def _both(lane_op, np_op):
    """A binary op on entries: numpy on two constants, JAX otherwise."""
    return lambda a, b: (lane_op(a, b) if _is_lane(a) or _is_lane(b)
                         else np_op(a, b))


_REDUCES = {
    "reduce_sum": _both(lambda a, b: a + b, np.add),
    "reduce_prod": _both(lambda a, b: a * b, np.multiply),
    "reduce_max": _both(jnp.maximum, np.maximum),
    "reduce_min": _both(jnp.minimum, np.minimum),
    "reduce_and": _both(lambda a, b: a & b, np.logical_and),
    "reduce_or": _both(lambda a, b: a | b, np.logical_or),
}

# Data-movement primitives -> positions of their DATA operands; every
# other operand is an index and must be a constant.
_STRUCTURAL = {
    "broadcast_in_dim": (0,), "reshape": (0,), "squeeze": (0,),
    "transpose": (0,), "slice": (0,), "rev": (0,), "pad": (0, 1),
    "concatenate": None,           # every operand is data
    "split": (0,), "gather": (0,), "scatter": (0, 2),
    "dynamic_slice": (0,), "dynamic_update_slice": (0, 1),
}

_CALLS = frozenset({"pjit", "jit", "closed_call", "core_call",
                    "custom_jvp_call", "custom_vjp_call", "remat",
                    "checkpoint"})


def _sub_jaxpr(eqn):
    """(jaxpr, consts) of a call-like equation."""
    p = eqn.params
    closed = (p.get("jaxpr") or p.get("call_jaxpr") or p.get("fun_jaxpr"))
    if hasattr(closed, "jaxpr"):
        return closed.jaxpr, list(closed.consts)
    return closed, []


# ---------------------------------------------------------------------------
# coverage: decided by inspecting the jaxpr, before anything compiles
# ---------------------------------------------------------------------------


def _covered(jaxpr) -> bool:
    """True if every equation is one the lane interpreter evaluates, and
    every index operand of a data-movement primitive is a constant."""
    static = set(jaxpr.constvars)

    def is_static(a):
        return isinstance(a, Literal) or a in static

    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim in _CALLS:
            sub, _ = _sub_jaxpr(eqn)
            if sub is None or not _covered(sub):
                return False
        elif prim in _STRUCTURAL:
            data = _STRUCTURAL[prim]
            if data is not None and not all(
                    is_static(a) for i, a in enumerate(eqn.invars)
                    if i not in data):
                return False
        elif not (prim in _ELEMENTWISE or prim in _REDUCES
                  or prim in ("dot_general", "iota")):
            return False
        if all(is_static(a) for a in eqn.invars):
            static.update(eqn.outvars)
    return True


# ---------------------------------------------------------------------------
# the lane interpreter
# ---------------------------------------------------------------------------


def _obj(arr) -> np.ndarray:
    """numeric array -> object array of numpy scalars (dtype kept)."""
    arr = np.asarray(arr)
    out = np.empty(arr.shape, object)
    for idx in np.ndindex(arr.shape):
        out[idx] = arr[idx]
    return out


def _numeric(val, dtype) -> np.ndarray:
    out = np.empty(val.shape, dtype)
    for idx in np.ndindex(val.shape):
        out[idx] = val[idx]
    return out


def _concrete(val) -> bool:
    return not any(_is_lane(e) for e in val.flat)


def _eager(prim, args, params):
    with jax.ensure_compile_time_eval():
        out = prim.bind(*args, **params)
    return out if prim.multiple_results else [out]


def _tree_reduce(op, terms):
    terms = list(terms)
    while len(terms) > 1:
        terms = [op(terms[i], terms[i + 1]) if i + 1 < len(terms)
                 else terms[i] for i in range(0, len(terms), 2)]
    return terms[0]


class _LaneInterpreter:
    """Evaluate a per-element jaxpr on object arrays of lanes."""

    def __init__(self, bt: int):
        self.bt = bt

    def lane(self, e):
        """An entry as a (bt,) lane: constants and traced scalars are
        broadcast."""
        if not _is_lane(e):
            return jnp.full((self.bt,), e, dtype=np.asarray(e).dtype)
        return e if e.ndim else jnp.broadcast_to(e, (self.bt,))

    def run(self, jaxpr, consts, args):
        env = {}

        def read(v):
            if isinstance(v, Literal):
                return _obj(np.asarray(v.val, v.aval.dtype))
            return env[v]

        for var, val in zip(jaxpr.constvars, consts):
            env[var] = val
        for var, val in zip(jaxpr.invars, args):
            env[var] = val
        for eqn in jaxpr.eqns:
            outs = self.eqn(eqn, [read(v) for v in eqn.invars])
            for var, val in zip(eqn.outvars, outs):
                env[var] = val
        return [read(v) for v in jaxpr.outvars]

    def eqn(self, eqn, ins, params=None, out_shape=None):
        """Evaluate one equation. params/out_shape override the
        equation's own (a rolled loop evaluates one row at a time)."""
        prim = eqn.primitive
        name = prim.name
        params = eqn.params if params is None else params
        if out_shape is None:
            out_shape = eqn.outvars[0].aval.shape
        if name in _CALLS:
            sub, consts = _sub_jaxpr(eqn)
            return self.run(sub, [_obj(c) for c in consts], ins)
        if all(_concrete(v) for v in ins):
            args = [_numeric(v, a.aval.dtype)
                    for v, a in zip(ins, eqn.invars)]
            return [_obj(o) for o in _eager(prim, args, params)]
        if name in _STRUCTURAL:
            return self.structural(eqn, ins, params)
        if name in _REDUCES:
            return [self.reduce(_REDUCES[name], ins[0], params["axes"])]
        if name == "dot_general":
            return [self.dot(params, *ins, out_shape)]
        return [self.elementwise(prim, params, ins, out_shape)]

    def elementwise(self, prim, params, ins, shape):
        ins = [np.broadcast_to(v, shape) for v in ins]
        out = np.empty(shape, object)
        for idx in np.ndindex(shape):
            ents = [v[idx] for v in ins]
            traced = [e for e in ents if _is_lane(e)]
            if any(e.ndim for e in traced):
                out[idx] = prim.bind(*(self.lane(e) for e in ents), **params)
            elif traced:       # traced scalars (rows of a rolled loop)
                out[idx] = prim.bind(*(jnp.asarray(e) for e in ents),
                                     **params)
            else:
                out[idx] = np.asarray(_eager(prim, ents, params)[0])[()]
        return out

    def reduce(self, op, val, axes):
        keep = [d for d in range(val.ndim) if d not in axes]
        moved = np.transpose(val, keep + list(axes))
        moved = moved.reshape(moved.shape[:len(keep)] + (-1,))
        out = np.empty(moved.shape[:-1], object)
        for idx in np.ndindex(out.shape):
            out[idx] = _tree_reduce(op, moved[idx])
        return out

    def dot(self, params, lhs, rhs, out_shape):
        (lc, rc), (lb, rb) = params["dimension_numbers"]
        lf = [d for d in range(lhs.ndim) if d not in lc and d not in lb]
        rf = [d for d in range(rhs.ndim) if d not in rc and d not in rb]
        lt = np.transpose(lhs, list(lb) + lf + list(lc))
        rt = np.transpose(rhs, list(rb) + rf + list(rc))
        nb = int(np.prod([lhs.shape[d] for d in lb]))
        nk = int(np.prod([lhs.shape[d] for d in lc]))
        lt = lt.reshape(nb, -1, nk)
        rt = rt.reshape(nb, -1, nk)
        out = np.empty((nb, lt.shape[1], rt.shape[1]), object)
        for b in range(nb):
            for i in range(lt.shape[1]):
                for j in range(rt.shape[1]):
                    out[b, i, j] = _tree_reduce(
                        _both(lambda a, c: a + c, np.add),
                        [lt[b, i, k] * rt[b, j, k] for k in range(nk)])
        return out.reshape(out_shape)

    def structural(self, eqn, ins, params):
        """Run the primitive itself on integer POSITIONS in place of the
        data operands, then gather the entries those positions name."""
        data = _STRUCTURAL[eqn.primitive.name]
        if data is None:
            data = range(len(ins))
        flat = [None]          # position 0: out-of-bounds fill
        args = []
        for i, (v, a) in enumerate(zip(ins, eqn.invars)):
            if i in data:
                pos = np.arange(len(flat), len(flat) + v.size, dtype=np.int32)
                flat.extend(v.flat)
                args.append(pos.reshape(v.shape))
            else:
                args.append(_numeric(v, a.aval.dtype))
        outs = []
        for o, var in zip(_eager(eqn.primitive, args, params),
                          eqn.outvars):
            o = np.asarray(o)
            zero = np.zeros((), var.aval.dtype)[()]
            res = np.empty(o.shape, object)
            for idx in np.ndindex(o.shape):
                k = int(o[idx])
                res[idx] = flat[k] if 0 < k < len(flat) else zero
            outs.append(res)
        return outs


# ---------------------------------------------------------------------------
# adapter and plan
# ---------------------------------------------------------------------------


def trace_products(products_fn, p0_elem, data_elem):
    """(closed jaxpr of p, *data_leaves -> (norm2, Jt_x, JtJ), number of
    data leaves), or None when JtJ is not a dense (n, n) array."""
    n = p0_elem.shape[-1]
    if data_elem is None:
        data_leaves, data_tree = [], None
    else:
        data_leaves, data_tree = jax.tree_util.tree_flatten(data_elem)

    def f(p, *dl):
        if data_tree is None:
            pr = products_fn(p)
        else:
            pr = products_fn(
                p, jax.tree_util.tree_unflatten(data_tree, list(dl)))
        return pr.norm2_x, pr.Jt_x, pr.JtJ

    closed = jax.make_jaxpr(f)(p0_elem, *data_leaves)
    shapes = [getattr(v.aval, "shape", None) for v in closed.jaxpr.outvars]
    if shapes != [(), (n,), (n, n)]:
        return None
    return closed, len(data_leaves)


# ---------------------------------------------------------------------------
# rolling the measurement axis into a loop
#
# Unrolled, a products function over m measurements emits O(m n^2) lane
# operations, and the GPU compile of so long a kernel does not finish in
# useful time (PERF.md). The usual products compute per-measurement rows
# and then contract the measurement axis away (x @ x, J.T @ x, J.T @ J).
# When the jaxpr has that shape, the row computations and the
# contractions run inside one fori_loop over the rows: each row is
# evaluated by the same interpreter with the row axis cut to size 1, and
# each contraction accumulates its row's contribution.
# ---------------------------------------------------------------------------

# The measurement axis: the longest leading axis of a data leaf or axis
# of a constant; it is rolled when at least this long. On an H100 the
# sample problem ran as fast rolled at 32 rows as unrolled at 31 (whose
# first call took 94 s against 6 s; PERF.md).
ROLL_MIN_ROWS = 32

# contraction primitive -> identity of its row accumulator (combined by
# the _REDUCES op; a dot_general contraction sums)
_ROW_IDENTITY = {"reduce_sum": 0, "dot_general": 0, "reduce_prod": 1,
                 "reduce_max": -np.inf, "reduce_min": np.inf}


def _row_axis(eqn, rowax, M):
    """For an equation with a row-indexed input: ("row", out axis),
    ("red", None) for a contraction of the row axis, or None."""
    name, prm = eqn.primitive.name, eqn.params
    ins = eqn.invars
    axes = [rowax.get(a) if not isinstance(a, Literal) else None
            for a in ins]
    k = next(x for x in axes if x is not None)
    if name in _ELEMENTWISE:
        for a, x in zip(ins, axes):
            if x is None and a.aval.ndim:
                return None
            if x is not None and x != k:
                return None
        return "row", k
    if name == "broadcast_in_dim":
        return "row", prm["broadcast_dimensions"][k]
    if name == "squeeze":
        return "row", k - sum(d < k for d in prm["dimensions"])
    if name == "transpose":
        return "row", list(prm["permutation"]).index(k)
    if name == "reshape" and prm.get("dimensions") is None:
        shp, new = ins[0].aval.shape, tuple(prm["new_sizes"])
        for k2, size in enumerate(new):
            if (size == M and np.prod(shp[:k]) == np.prod(new[:k2])
                    and np.prod(shp[k + 1:]) == np.prod(new[k2 + 1:])):
                return "row", k2
        return None
    if name == "concatenate":
        ok = prm["dimension"] != k and all(x == k for x in axes)
        return ("row", k) if ok else None
    if name == "slice":
        strides = prm["strides"] or (1,) * len(prm["start_indices"])
        ok = (prm["start_indices"][k] == 0
              and prm["limit_indices"][k] == M and strides[k] == 1)
        return ("row", k) if ok else None
    if name == "pad":
        ok = axes[1] is None and tuple(prm["padding_config"][k]) == (0, 0, 0)
        return ("row", k) if ok else None
    if name in _ROW_IDENTITY and name != "dot_general":
        if k in prm["axes"]:
            return "red", None
        return "row", k - sum(d < k for d in prm["axes"])
    if name == "dot_general":
        (lc, rc), (lb, rb) = prm["dimension_numbers"]
        kl, kr = axes
        if kl is not None and kl in lc:
            return (("red", None) if kr == rc[list(lc).index(kl)]
                    else None)
        if kr is not None and kr in rc:
            return None
        if kl is not None and kl in lb:
            return ("row", list(lb).index(kl)) \
                if kr == rb[list(lb).index(kl)] else None
        if kl is not None and kr is not None:
            return None
        nb = len(lb)
        if kl is not None:
            free = [d for d in range(ins[0].aval.ndim)
                    if d not in lc and d not in lb]
            return "row", nb + free.index(kl)
        free_l = ins[0].aval.ndim - len(lc) - len(lb)
        free = [d for d in range(ins[1].aval.ndim)
                if d not in rc and d not in rb]
        return "row", nb + free_l + free.index(kr)
    return None


def _row_plan(jaxpr, n_data):
    """How to roll the measurement axis of a products jaxpr: (M, rowax,
    kinds) with rowax the row axis of every row-indexed variable and
    kinds one of "inv" (before the loop), "row", "red" (in the loop),
    "post" (after it) per equation; None when the jaxpr cannot be
    rolled."""
    data = jaxpr.invars[1:1 + n_data]
    sizes = ([v.aval.shape[0] for v in data if v.aval.ndim]
             + [size for v in jaxpr.constvars for size in v.aval.shape])
    if not sizes or max(sizes) < ROLL_MIN_ROWS:
        return None
    M = max(sizes)
    rowax = {}
    for v in list(data) + list(jaxpr.constvars):
        at = [d for d, size in enumerate(v.aval.shape) if size == M]
        if len(at) > 1 or (at and v in data and at != [0]):
            return None
        if at:
            rowax[v] = at[0]
    kinds, post = [], set()
    for eqn in jaxpr.eqns:
        ins = [a for a in eqn.invars if not isinstance(a, Literal)]
        rows = [a for a in ins if a in rowax]
        if any(a in post for a in ins):
            if rows:
                return None
            kinds.append("post")
            post.update(eqn.outvars)
            continue
        if not rows:
            if eqn.primitive.name == "broadcast_in_dim":
                dims, shape = (eqn.params["broadcast_dimensions"],
                               eqn.params["shape"])
                new = [d for d, size in enumerate(shape) if size == M
                       and (d not in dims or ins[0].aval.shape[
                           list(dims).index(d)] != M)]
                if len(new) > 1:
                    return None
                if new:
                    rowax[eqn.outvars[0]] = new[0]
                    kinds.append("row")
                    continue
            kinds.append("inv")
            continue
        rule = _row_axis(eqn, rowax, M)
        if rule is None:
            return None
        kind, axis = rule
        kinds.append(kind)
        if kind == "red":
            post.update(eqn.outvars)
        else:
            rowax[eqn.outvars[0]] = axis
    return M, rowax, kinds


def _one_row(eqn, rowax, M):
    """(params, out shape) of a row-loop equation evaluated on one row:
    every row axis has size 1."""
    prm = dict(eqn.params)
    out = eqn.outvars[0]
    shape = list(out.aval.shape)
    if out in rowax:
        k = rowax[out]
        shape[k] = 1
        name = eqn.primitive.name
        if name == "broadcast_in_dim":
            prm["shape"] = tuple(shape)
        elif name == "reshape":
            prm["new_sizes"] = tuple(shape)
        elif name == "slice":
            kin = rowax[eqn.invars[0]]
            lim = list(prm["limit_indices"])
            lim[kin] = 1
            prm["limit_indices"] = tuple(lim)
    return prm, tuple(shape)


def _load(ref, shape):
    """Object array of `shape` whose flat entry i is ref[i]."""
    val = np.empty(shape, object)
    for i, idx in enumerate(np.ndindex(shape)):
        val[idx] = ref[i]
    return val


def _load_row(get, shape, axis):
    """One row of a row-indexed value: `shape` with the row axis cut to
    size 1, flat entry j read as get(j, entries per row)."""
    one = list(shape)
    one[axis] = 1
    val = np.empty(one, object)
    width = int(np.prod(one))
    for j, idx in enumerate(np.ndindex(*one)):
        val[idx] = get(j, width)
    return val


def _run_rolled(interp, jaxpr, plan, env, row_sources):
    """Evaluate a products jaxpr with its measurement axis rolled into one
    fori_loop (plan from _row_plan). env holds the row-invariant inputs;
    row_sources maps each row-indexed input to r -> its row r."""
    M, rowax, kinds = plan

    def read(e, a):
        if isinstance(a, Literal):
            return _obj(np.asarray(a.val, a.aval.dtype))
        return e[a]

    def run(e, kind):      # "inv" or "post": whole values, no row cut
        for eqn, kd in zip(jaxpr.eqns, kinds):
            if kd == kind:
                e.update(zip(eqn.outvars, interp.eqn(
                    eqn, [read(e, a) for a in eqn.invars])))

    run(env, "inv")
    reds = [eqn for eqn, kd in zip(jaxpr.eqns, kinds) if kd == "red"]
    acc0 = []
    for eqn in reds:
        aval = eqn.outvars[0].aval
        acc0 += [jnp.full((interp.bt,), _ROW_IDENTITY[eqn.primitive.name],
                          aval.dtype)] * max(int(np.prod(aval.shape)), 1)

    def body(r, acc):
        r = r.astype(jnp.int32)
        e = dict(env)
        e.update((v, row(r)) for v, row in row_sources)
        for eqn, kd in zip(jaxpr.eqns, kinds):
            if kd == "row":
                ins = [read(e, a) for a in eqn.invars]
                e.update(zip(eqn.outvars, interp.eqn(
                    eqn, ins, *_one_row(eqn, rowax, M))))
        acc, new = iter(acc), []
        for eqn in reds:
            ins = [read(e, a) for a in eqn.invars]
            part = interp.eqn(eqn, ins, *_one_row(eqn, rowax, M))[0]
            op = _REDUCES.get(eqn.primitive.name, _REDUCES["reduce_sum"])
            new += [op(next(acc), interp.lane(x)) for x in part.flat]
        return new

    acc = iter(jax.lax.fori_loop(0, M, body, acc0))
    for eqn in reds:
        aval = eqn.outvars[0].aval
        val = np.empty(aval.shape, object)
        for idx in np.ndindex(aval.shape):
            val[idx] = next(acc)
        env[eqn.outvars[0]] = val
    run(env, "post")
    return [read(env, v) for v in jaxpr.outvars]


def adapt_products_lanes(closed, n_data):
    """Lane-form products (ops/pallas_mega.py) from a traced per-element
    products jaxpr (see trace_products).

    Returns (products, shared): the lane-form function takes
    (p, *data_refs, *shared_refs), and `shared` holds the constant arrays
    a rolled loop reads one row at a time (pass them as the kernel's
    shared_data); other constants fold into the code."""
    jaxpr = closed.jaxpr
    plan = _row_plan(jaxpr, n_data)
    rowax = {} if plan is None else plan[1]
    const_row = [v for v in jaxpr.constvars if v in rowax]
    shared = tuple(
        np.moveaxis(np.asarray(c), rowax[v], 0).reshape(
            v.aval.shape[rowax[v]], -1)
        for v, c in zip(jaxpr.constvars, closed.consts) if v in rowax)
    consts = {v: _obj(np.asarray(c))
              for v, c in zip(jaxpr.constvars, closed.consts)
              if v not in rowax}
    data_vars = jaxpr.invars[1:1 + n_data]

    def products(p, *refs):
        interp = _LaneInterpreter(p[0].shape[0])
        data_refs, shared_refs = refs[:n_data], refs[n_data:]
        env = dict(consts)
        env[jaxpr.invars[0]] = np.empty(len(p), object)
        for i, pi in enumerate(p):
            env[jaxpr.invars[0]][i] = pi
        row_sources = []
        for ref, v in zip(data_refs, data_vars):
            if v in rowax:
                row_sources.append((v, lambda r, _ref=ref, _v=v: _load_row(
                    lambda j, w: _ref[r * w + j], _v.aval.shape, 0)))
            else:
                env[v] = _load(ref, v.aval.shape)
        for ref, v in zip(shared_refs, const_row):
            row_sources.append((v, lambda r, _ref=ref, _v=v: _load_row(
                lambda j, w: _ref[r, j], _v.aval.shape, rowax[_v])))
        if plan is None:
            n2, jtx, jtj = interp.run(
                jaxpr, [env[v] for v in jaxpr.constvars],
                [env[v] for v in jaxpr.invars])
        else:
            n2, jtx, jtj = _run_rolled(interp, jaxpr, plan, env,
                                       row_sources)
        n = len(p)
        return (interp.lane(n2[()]),
                [interp.lane(jtx[i]) for i in range(n)],
                [[interp.lane(jtj[i, j]) for j in range(i + 1)]
                 for i in range(n)])

    return products, shared


def _count_eqns(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        n += 1
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                n += _count_eqns(getattr(sub, "jaxpr", sub))
    return n


def lane_op_count(products, n, data_rows, dtype, shared=(), bt=32) -> int:
    """Operations one evaluation of lane-form products emits (traced on
    abstract lanes, nothing compiled; a loop body counts once)."""
    lane = jax.ShapeDtypeStruct((bt,), dtype)
    rows = [jax.ShapeDtypeStruct((r, bt), dtype) for r in data_rows]
    closed = jax.make_jaxpr(lambda p, *d: products(list(p), *d))(
        [lane] * n, *rows, *shared)
    return _count_eqns(closed.jaxpr)


def _pad_to(a, b_target):
    pad = b_target - a.shape[0]
    if pad == 0:
        return a
    return jnp.concatenate([a, jnp.repeat(a[:1], pad, axis=0)], axis=0)


def plan_megakernel(products_fn,
                    p0_batch,
                    parameters: Optional[DoglegParameters],
                    *,
                    problem_data: Any = None,
                    mesh=None,
                    axis_name: str = "dp",
                    forced: bool = False,
                    interpret: bool = False):
    """A zero-argument callable that runs this batched solve in the
    megakernel and returns a batch-leading SolveResult, or None when the
    solve is outside the kernel's regime (module docstring). With
    forced=True, a solve outside the regime raises ValueError instead.
    interpret=True runs the Pallas interpreter (CPU tests) and lifts the
    backend and dtype conditions."""
    from libdogleg_tpu.ops.pallas_mega import (DEFAULT_BLOCK_BATCH,
                                               megakernel_optimize)

    def decline(why):
        if forced:
            raise ValueError(f"use_megakernel=True, but {why}")
        return None

    if not interpret and jax.default_backend() != "gpu":
        return decline("the megakernel runs on a GPU backend only")
    leaves = jax.tree_util.tree_leaves(p0_batch)
    if len(leaves) != 1 or leaves[0].ndim != 2:
        return decline("the state batch is not a single (B, n) array")
    p0 = leaves[0]
    B, n = p0.shape
    if n > MEGA_MAX_N:
        return decline(f"Nstate {n} > {MEGA_MAX_N}")
    if p0.dtype != jnp.float32 and not interpret:
        return decline("the megakernel is compiled for float32 only")

    block = DEFAULT_BLOCK_BATCH
    n_shards = 1 if mesh is None else int(mesh.devices.size)
    if mesh is not None and B % (n_shards * block):
        return decline(f"batch {B} is no multiple of {n_shards} devices "
                       f"x {block} lanes")
    padded_B = -(-B // block) * block

    p0_elem = jax.ShapeDtypeStruct((n,), p0.dtype)
    data_elem = (None if problem_data is None else
                 jax.tree_util.tree_map(
                     lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                     problem_data))
    traced = trace_products(products_fn, p0_elem, data_elem)
    if traced is None:
        return decline("JtJ is not a dense (n, n) array")
    closed, nd = traced
    if any(isinstance(c, jax.core.Tracer) for c in closed.consts):
        return decline("the products close over a traced array")
    if not _covered(closed.jaxpr):
        return decline("the products use a primitive the lane "
                       "interpreter does not cover")
    products, shared = adapt_products_lanes(closed, nd)
    data_leaves = ([] if problem_data is None
                   else jax.tree_util.tree_leaves(problem_data))
    rows = [max(int(np.prod(d.shape[1:])), 1) for d in data_leaves]
    ops = lane_op_count(products, n, rows, p0.dtype, shared)
    if ops > MAX_LANE_OPS:
        return decline(f"the products unroll to {ops} lane operations "
                       f"(> MAX_LANE_OPS = {MAX_LANE_OPS})")

    prm = parameters if parameters is not None else DoglegParameters()

    def solve(q, *dl):
        res = megakernel_optimize(
            products, _pad_to(q, padded_B), prm,
            problem_data=tuple(_pad_to(d, padded_B) for d in dl),
            shared_data=shared, block_batch=block, mesh=mesh, axis_name=axis_name,
            interpret=interpret)
        if padded_B != B:
            res = jax.tree_util.tree_map(lambda a: a[:B], res)
        return res

    return lambda: jax.jit(solve)(p0, *data_leaves)
