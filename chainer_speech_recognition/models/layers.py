"""The few layers the acoustic models are built from, and the parameter
scope that holds their weights.

A ``Module`` is a dataclass whose ``__call__`` is the forward pass. Inside
it, sub-modules are constructed and called in place (``Dense(d,
name="qkv")(x)``) and parameters are asked for by name
(``self.param(name, init, shape, dtype)``). ``module.init(rng, *args)``
runs the forward once with an empty scope, creating every parameter the
first time it is asked for, and returns ``{"params": tree}``;
``module.apply(variables, *args)`` runs it again reading that tree. A
sub-module's parameters live under its ``name``, or under
``<ClassName>_<i>`` (i counting that class's unnamed calls in the parent).

Parameter names, shapes, initialisers and the numerics of ``Dense``,
``Conv`` and ``LayerNorm`` are those of the layer library the models were
first written with, so parameter trees and results did not change when
the models moved here (pinned by tests/fixtures/models.npz).
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["Module", "Dense", "Conv", "LayerNorm", "lecun_normal",
           "orthogonal", "zeros", "ones"]

lecun_normal = jax.nn.initializers.lecun_normal()
orthogonal = jax.nn.initializers.orthogonal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones

_CTX = threading.local()


class _Scope:
    """One module's slot in the parameter tree. ``rng`` is set while
    initialising (missing parameters are created) and None while applying
    (a missing parameter is an error)."""

    def __init__(self, tree: dict, rng, path: tuple[str, ...]):
        self.tree, self.rng, self.path = tree, rng, path
        self.unnamed: dict[str, int] = {}

    def _where(self, name: str) -> str:
        return "/".join(self.path + (name,))

    def child(self, name: str) -> "_Scope":
        if self.rng is not None:
            sub = self.tree.setdefault(name, {})
        elif name in self.tree:
            sub = self.tree[name]
        else:
            raise KeyError(f"no parameters for module {self._where(name)}")
        return _Scope(sub, self.rng, self.path + (name,))

    def param(self, name: str, init, shape, dtype):
        if name not in self.tree:
            if self.rng is None:
                raise KeyError(f"no parameter {self._where(name)}")
            seed = zlib.crc32(self._where(name).encode()) & 0x7FFFFFFF
            self.tree[name] = init(jax.random.fold_in(self.rng, seed),
                                   tuple(shape), dtype)
        return self.tree[name]


def _current() -> _Scope:
    scope = getattr(_CTX, "scope", None)
    if scope is None:
        raise RuntimeError("a Module runs only inside init() or apply()")
    return scope


def _enter(call):
    """Wrap a Module's ``__call__`` so it runs in its own child scope."""

    def scoped(self, *args, **kwargs):
        parent = _current()
        name = self.name
        if name is None:
            cls = type(self).__name__
            i = parent.unnamed.get(cls, 0)
            parent.unnamed[cls] = i + 1
            name = f"{cls}_{i}"
        _CTX.scope = parent.child(name)
        try:
            return call(self, *args, **kwargs)
        finally:
            _CTX.scope = parent

    scoped.__wrapped__ = call
    scoped.__doc__ = call.__doc__
    return scoped


@dataclasses.dataclass(eq=False)
class Module:
    name: str | None = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False)
        if "__call__" in cls.__dict__:
            cls.__call__ = _enter(cls.__dict__["__call__"])

    def param(self, name: str, init, shape, dtype=jnp.float32):
        return _current().param(name, init, shape, dtype)

    def _in_scope(self, scope: _Scope, args, kwargs):
        prev = getattr(_CTX, "scope", None)
        _CTX.scope = scope
        try:
            return type(self).__call__.__wrapped__(self, *args, **kwargs)
        finally:
            _CTX.scope = prev

    def init(self, rng: jax.Array, *args, **kwargs) -> dict:
        tree: dict = {}
        self._in_scope(_Scope(tree, rng, ()), args, kwargs)
        return {"params": tree}

    def apply(self, variables: dict, *args, **kwargs):
        return self._in_scope(_Scope(variables["params"], None, ()),
                              args, kwargs)


def _promote(dtype, *xs):
    dtype = dtype or jnp.result_type(*xs)
    return [jnp.asarray(x, dtype) for x in xs]


class Dense(Module):
    """``x @ kernel + bias`` over the last axis, computed in ``dtype``."""

    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x):
        kernel = self.param("kernel", lecun_normal,
                            (x.shape[-1], self.features), self.param_dtype)
        bias = self.param("bias", zeros, (self.features,), self.param_dtype)
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y + bias.reshape((1,) * (y.ndim - 1) + (-1,))


class Conv(Module):
    """N-d convolution over channels-last input ``[B, *spatial, C]``.

    ``padding`` is "VALID", "SAME" or one ``(lo, hi)`` pair per spatial
    axis; ``feature_group_count = C`` makes it depthwise."""

    features: int
    kernel_size: tuple[int, ...]
    strides: Any = 1
    padding: Any = "SAME"
    feature_group_count: int = 1
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x):
        ks = tuple(self.kernel_size)
        nd = len(ks)
        strides = ((self.strides,) * nd if isinstance(self.strides, int)
                   else tuple(self.strides))
        padding = (self.padding if isinstance(self.padding, str)
                   else tuple(tuple(p) for p in self.padding))
        kernel = self.param(
            "kernel", lecun_normal,
            ks + (x.shape[-1] // self.feature_group_count, self.features),
            self.param_dtype)
        bias = self.param("bias", zeros, (self.features,), self.param_dtype)
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        spatial = tuple(range(1, nd + 1))
        lhs = (0, nd + 1) + spatial
        dn = lax.ConvDimensionNumbers(
            lhs_spec=lhs, rhs_spec=(nd + 1, nd) + tuple(range(nd)),
            out_spec=lhs)
        y = lax.conv_general_dilated(
            x, kernel, strides, padding, lhs_dilation=(1,) * nd,
            rhs_dilation=(1,) * nd, dimension_numbers=dn,
            feature_group_count=self.feature_group_count)
        return y + bias.reshape((1,) * (y.ndim - 1) + (-1,))


class LayerNorm(Module):
    """LayerNorm over the last axis. Statistics are at least float32 and
    use the one-pass variance ``E[x²] − E[x]²`` (clipped at 0)."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x):
        d = x.shape[-1]
        stat = jnp.promote_types(self.dtype or x.dtype, jnp.float32)
        xs = x.astype(stat)
        mean = jnp.mean(xs, axis=-1, keepdims=True)
        mean2 = jnp.mean(lax.square(xs), axis=-1, keepdims=True)
        var = jnp.maximum(0.0, mean2 - lax.square(mean))
        scale = self.param("scale", ones, (d,), self.param_dtype)
        bias = self.param("bias", zeros, (d,), self.param_dtype)
        mul = lax.rsqrt(var + self.epsilon) * scale
        y = (x - mean) * mul + bias
        return y.astype(self.dtype or jnp.result_type(x, scale, bias))
