"""Minimal forward-mode dual numbers with a fixed 4-wide tangent basis.

Purpose-built for the analytic LM value-and-gradient (ops/fused_iter.py): every
critic residual is DIAGONAL in the rollout step axis, so its Jacobian
contribution reduces to per-step partials w.r.t. the 4 step inputs the
social-work critic actually consumes — (x, y, yaw, v) — which are then
chain-contracted against the rollout sensitivities. Carrying 4 named
tangents through a mechanical forward evaluation avoids hand-deriving the
Moussaid social-force gradient (reference math:
social_work_cost_function.hpp:164-228), which is the one transcendental
chain too hairy to differentiate by hand safely.

Representation: ``(p, (t0, t1, t2, t3))`` — a primal array plus 4 tangent
arrays of the same shape; a tangent entry may be ``None`` (symbolic zero),
so seeding with one-hots keeps early ops sparse. Everything is plain jnp
elementwise math over arbitrary shapes: the SAME code runs per-lane (S,)
under the test suite and batched (S, B) in XLA.
"""

import jax.numpy as jnp

K = 4  # tangent basis: d/dx, d/dy, d/dyaw, d/dv


def const(p):
    return (p, (None, None, None, None))


def seed(p, k):
    """Primal p whose tangent is 1 along basis direction k."""
    t = [None] * K
    t[k] = jnp.ones_like(p)
    return (p, tuple(t))


def _zip2(ta, tb, f_a, f_b):
    """Combine tangent tuples: f_a applied to a's tangents, f_b to b's,
    summed where both exist; None stays symbolic."""
    out = []
    for a, b in zip(ta, tb):
        if a is None and b is None:
            out.append(None)
        elif a is None:
            out.append(f_b(b))
        elif b is None:
            out.append(f_a(a))
        else:
            out.append(f_a(a) + f_b(b))
    return tuple(out)


def _map1(t, f):
    return tuple(None if x is None else f(x) for x in t)


def add(a, b):
    return (a[0] + b[0], _zip2(a[1], b[1], lambda x: x, lambda x: x))


def sub(a, b):
    return (a[0] - b[0], _zip2(a[1], b[1], lambda x: x, lambda x: -x))


def mul(a, b):
    pa, pb = a[0], b[0]
    return (pa * pb, _zip2(a[1], b[1], lambda x: x * pb, lambda x: pa * x))


def scale(a, c):
    """a * c with c a constant (python/float or array)."""
    return (a[0] * c, _map1(a[1], lambda x: x * c))


def neg(a):
    return (-a[0], _map1(a[1], lambda x: -x))


def div(a, b):
    pa, pb = a[0], b[0]
    inv = 1.0 / pb
    return (pa * inv, _zip2(a[1], b[1], lambda x: x * inv, lambda x: -pa * inv * inv * x))


def exp(a):
    e = jnp.exp(a[0])
    return (e, _map1(a[1], lambda x: e * x))


def sqrt_(a):
    r = jnp.sqrt(a[0])
    half_inv = 0.5 / r
    return (r, _map1(a[1], lambda x: half_inv * x))


def cos(a):
    s = jnp.sin(a[0])
    return (jnp.cos(a[0]), _map1(a[1], lambda x: -s * x))


def sin(a):
    c = jnp.cos(a[0])
    return (jnp.sin(a[0]), _map1(a[1], lambda x: c * x))


def atan2(y, x):
    """d atan2(y, x) = (x dy - y dx) / (x^2 + y^2) (JAX's atan2 JVP)."""
    py, px = y[0], x[0]
    denom = px * px + py * py
    return (
        jnp.arctan2(py, px),
        _zip2(y[1], x[1], lambda ty: px / denom * ty, lambda tx: -py / denom * tx),
    )


def where(cond, a, b):
    """Select with a CONSTANT condition (no tangent through cond)."""

    def sel(x, y):
        if x is None and y is None:
            return None
        if x is None:
            x = jnp.zeros_like(y)
        if y is None:
            y = jnp.zeros_like(x)
        return jnp.where(cond, x, y)

    return (jnp.where(cond, a[0], b[0]), tuple(sel(x, y) for x, y in zip(a[1], b[1])))


def tangents(a):
    """Densify: return the 4 tangent arrays with zeros for symbolic zeros."""
    z = None
    out = []
    for t in a[1]:
        if t is None:
            if z is None:
                z = jnp.zeros_like(a[0])
            out.append(z)
        else:
            out.append(t)
    return tuple(out)
