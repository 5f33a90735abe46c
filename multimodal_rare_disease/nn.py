"""Minimal neural-network module layer.

The model code is written against a small subset of the flax.linen API
(`Module` with `compact`/`setup`, `param`, BatchNorm statistics, dropout
RNG, `init`/`apply` with `mutable=` and `method=`). This module
implements exactly that subset on plain JAX, so the framework needs no
module library beyond JAX itself.

Compatibility contract (pinned by tests/test_nn.py against flax where
flax is installed):

- parameter and batch-statistic trees have the same paths, shapes and
  dtypes as flax.linen's for the same module code, so checkpoints,
  `parallel/tp.py`'s sharding rules, `train/freeze.py`'s masks and the
  converted-weight maps of `models/convert.py` address the same leaves;
- initialisation draws the same numbers: a parameter's key is the root
  key folded with the SHA-1 of its module path plus a per-scope counter,
  as in flax's lazy RNG;
- the layers compute what flax's do, with the same dtype promotion.

`PyTreeNode` / `static_field` cover the frozen-dataclass pytree used by
the train state.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import threading
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

Array = Any
Dtype = Any

initializers = jax.nn.initializers
relu = jax.nn.relu
gelu = jax.nn.gelu
leaky_relu = jax.nn.leaky_relu
swish = jax.nn.swish
sigmoid = jax.nn.sigmoid
softmax = jax.nn.softmax
log_softmax = jax.nn.log_softmax
one_hot = jax.nn.one_hot

_default_kernel_init = initializers.lecun_normal()
_default_embed_init = initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0)


# ---------------------------------------------------------------------------
# variable scopes
# ---------------------------------------------------------------------------


def _fold_in_static(key, data: Tuple[Union[str, int], ...]):
    """Fold a module path (+ counter) into `key` via its SHA-1 digest."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


def _copy_dicts(tree):
    """Fresh nested dicts over the same leaves (copy-on-write root)."""
    if isinstance(tree, Mapping):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Root:
    def __init__(self, variables: Dict[str, Any], rngs: Dict[str, Any],
                 mutable, initializing: bool):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable  # True (all collections) or a set of names
        self.initializing = initializing


class _Scope:
    """One module's view of the variables: a path below the root."""

    def __init__(self, root: _Root, path: Tuple[str, ...]):
        self.root = root
        self.path = path
        self.rng_counters: Dict[str, int] = {}
        self.children: Dict[str, "_Scope"] = {}

    def push(self, name: str) -> "_Scope":
        if name not in self.children:
            self.children[name] = _Scope(self.root, self.path + (name,))
        return self.children[name]

    def is_mutable(self, col: str) -> bool:
        m = self.root.mutable
        return m is True or col in m

    def _node(self, col: str, create: bool):
        node = self.root.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.root.variables[col] = {}
        for p in self.path:
            nxt = node.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = node[p] = {}
            node = nxt
        return node

    def get(self, col: str, name: str):
        node = self._node(col, create=False)
        return None if node is None else node.get(name)

    def put(self, col: str, name: str, value) -> None:
        if not self.is_mutable(col):
            raise ValueError(
                f"cannot set {self.describe(name)}: collection {col!r} is "
                "not mutable (pass mutable=[...] to apply)")
        self._node(col, create=True)[name] = value

    def make_rng(self, name: str):
        rngs = self.root.rngs
        if name not in rngs:
            if "params" not in rngs:
                raise ValueError(f"{self.describe()} needs a PRNG key for "
                                 f"{name!r} (pass rngs={{{name!r}: key}})")
            name = "params"
        self.rng_counters[name] = self.rng_counters.get(name, 0) + 1
        return _fold_in_static(rngs[name],
                               self.path + (self.rng_counters[name],))

    def describe(self, name: Optional[str] = None) -> str:
        parts = self.path + ((name,) if name else ())
        return "/".join(parts) or "<root>"


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

_UNSET = object()
_CTX = threading.local()
_NOT_WRAPPED = ("setup", "__post_init__", "__init__", "__setattr__")


def _stack() -> list:
    stack = getattr(_CTX, "stack", None)
    if stack is None:
        stack = _CTX.stack = []
    return stack


def compact(fn: Callable) -> Callable:
    """Mark the method that declares submodules and params inline."""
    fn._compact = True
    return fn


def _wrap_method(fn: Callable) -> Callable:
    is_compact = getattr(fn, "_compact", False)

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._bind()
        stack = _stack()
        stack.append(self)
        if is_compact:
            self._autoname.clear()
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


def _name_children(attr: str, value) -> None:
    if isinstance(value, Module):
        if value.name is None:
            object.__setattr__(value, "name", attr)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            if isinstance(v, Module) and v.name is None:
                object.__setattr__(v, "name", f"{attr}_{i}")


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class: a dataclass of hyper-parameters whose methods run
    against variables bound by `init` / `apply`.

    Submodules created in a `@compact` method are children of the module
    running it, named by their `name=` or `ClassName_<n>`; submodules
    assigned in `setup` are named by their attribute unless given a name.
    """

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)
    parent: Any = dataclasses.field(default=_UNSET, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = inspect.get_annotations(cls)
        for attr, fn in list(vars(cls).items()):
            # methods only: a function-valued field default (an
            # initializer) is data, not a method
            if (inspect.isfunction(fn) and attr not in fields
                    and attr not in _NOT_WRAPPED
                    and (not attr.startswith("_") or attr == "__call__")):
                setattr(cls, attr, _wrap_method(fn))
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_scope", None)
        object.__setattr__(self, "_setup_done", False)
        object.__setattr__(self, "_in_setup", False)
        object.__setattr__(self, "_autoname", {})
        if self.parent is _UNSET:
            stack = _stack()
            object.__setattr__(self, "parent", stack[-1] if stack else None)
        parent = self.parent
        if parent is not None and self.name is None and not parent._in_setup:
            prefix = type(self).__name__
            n = parent._autoname.get(prefix, 0)
            parent._autoname[prefix] = n + 1
            object.__setattr__(self, "name", f"{prefix}_{n}")

    def __setattr__(self, attr, value):
        if getattr(self, "_in_setup", False):
            _name_children(attr, value)
        object.__setattr__(self, attr, value)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"

    # -- binding -----------------------------------------------------------

    def _bind(self) -> None:
        if self._scope is None:
            if self.parent is None or self.name is None:
                raise ValueError(
                    f"{type(self).__name__} is not bound to variables: "
                    "call it through init() or apply(), or from inside "
                    "another module's method")
            self.parent._bind()
            object.__setattr__(self, "_scope",
                               self.parent._scope.push(self.name))
        if not self._setup_done:
            object.__setattr__(self, "_setup_done", True)
            stack = _stack()
            stack.append(self)
            object.__setattr__(self, "_in_setup", True)
            try:
                self.setup()
            finally:
                object.__setattr__(self, "_in_setup", False)
                stack.pop()

    def setup(self) -> None:
        """Declare submodules as attributes (lazy, once per binding)."""

    def clone(self, **overrides) -> "Module":
        kw = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self) if f.init}
        kw.update(overrides)
        return type(self)(**kw)

    # -- variables ---------------------------------------------------------

    def param(self, name: str, init_fn: Callable, *init_args):
        """The parameter `name`, created with init_fn(key, *init_args)
        when variables are being initialised."""
        scope = self._scope
        value = scope.get("params", name)
        if value is None:
            if not scope.root.initializing:
                raise KeyError(f"parameter {scope.describe(name)} not found")
            value = init_fn(scope.make_rng("params"), *init_args)
            scope.put("params", name, value)
        return value

    def _variable(self, col: str, name: str, init_fn: Callable[[], Array]):
        scope = self._scope
        value = scope.get(col, name)
        if value is None:
            if not scope.is_mutable(col):
                raise KeyError(f"variable {col}:{scope.describe(name)} "
                               "not found")
            value = init_fn()
            scope.put(col, name, value)
        return value

    def make_rng(self, name: str = "params"):
        return self._scope.make_rng(name)

    def is_initializing(self) -> bool:
        return self._scope.root.initializing

    # -- entry points ------------------------------------------------------

    def _run(self, root: _Root, method, args, kwargs):
        module = self.clone(parent=None)
        object.__setattr__(module, "_scope", _Scope(root, ()))
        if method is None:
            fn = module.__call__
        elif isinstance(method, str):
            fn = getattr(module, method)
        else:
            fn = functools.partial(method, module)
        return fn(*args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs) -> Dict[str, Any]:
        """Create the variables by running `method` (default __call__)."""
        if not isinstance(rngs, Mapping):
            rngs = {"params": rngs}
        root = _Root({}, dict(rngs), True, initializing=True)
        self._run(root, method, args, kwargs)
        return root.variables

    def apply(self, variables: Mapping[str, Any], *args, rngs=None,
              method=None, mutable=False, **kwargs):
        """Run `method` on `variables`. With `mutable` (a collection name,
        a list of them, or True) returns (output, updated collections)."""
        if mutable is True:
            cols = True
        elif isinstance(mutable, str):
            cols = {mutable}
        else:
            cols = set(mutable or ())
        own = {col: (_copy_dicts(v) if (cols is True or col in cols) else v)
               for col, v in variables.items()}
        root = _Root(own, dict(rngs or {}), cols, initializing=False)
        out = self._run(root, method, args, kwargs)
        if not cols:
            return out
        names = own.keys() if cols is True else cols
        return out, {c: root.variables.get(c, {}) for c in names}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _promote(*args, dtype=None, inexact=True):
    """Cast every non-None argument to `dtype` (or their common type)."""
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
        if inexact and not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


def _tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _padding(padding, rank: int):
    if isinstance(padding, str):
        return padding
    if isinstance(padding, int):
        return [(padding, padding)] * rank
    pads = [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    if len(pads) != rank or any(len(p) != 2 for p in pads):
        raise ValueError(f"invalid padding {padding!r} for rank {rank}")
    return pads


def _per_dim(x, rank: int) -> tuple:
    if x is None:
        x = 1
    return (x,) * rank if isinstance(x, int) else tuple(x)


def _add_bias(y, bias):
    return y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())))
        return y if bias is None else _add_bias(y, bias)


class DenseGeneral(Module):
    """Dense over the trailing `axis` dims to a `features` shape; the
    kernel is initialised as the equivalent 2-D matrix."""

    features: Union[int, Sequence[int]]
    axis: Union[int, Sequence[int]] = -1
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        features = _tuple(self.features)
        axis = tuple(a % inputs.ndim for a in _tuple(self.axis))
        n_feat = len(features)

        def kernel_init(key, shape, dtype=jnp.float32):
            flat = (int(np.prod(shape[:-n_feat])),
                    int(np.prod(shape[-n_feat:])))
            return jnp.reshape(self.kernel_init(key, flat, dtype), shape)

        def bias_init(key, shape, dtype=jnp.float32):
            flat = (int(np.prod(shape)),)
            return jnp.reshape(self.bias_init(key, flat, dtype), shape)

        kernel = self.param("kernel", kernel_init,
                            tuple(inputs.shape[a] for a in axis) + features,
                            self.param_dtype)
        bias = (self.param("bias", bias_init, features, self.param_dtype)
                if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        contract = tuple(range(len(axis)))
        y = lax.dot_general(inputs, kernel, ((axis, contract), ((), ())))
        if bias is not None:
            batch_ones = (1,) * (inputs.ndim - len(axis))
            y = y + jnp.reshape(bias, batch_ones + features)
        return y


class Conv(Module):
    """N-d convolution over channels-last inputs with one batch dim."""

    features: int
    kernel_size: Sequence[int]
    strides: Union[None, int, Sequence[int]] = 1
    padding: Any = "SAME"
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        ks = _tuple(self.kernel_size)
        rank = len(ks)
        in_features = inputs.shape[-1]
        if in_features % self.feature_group_count:
            raise ValueError("input features must divide into groups")
        kernel = self.param(
            "kernel", self.kernel_init,
            ks + (in_features // self.feature_group_count, self.features),
            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        nd = inputs.ndim
        lhs = (0, nd - 1) + tuple(range(1, nd - 1))
        rhs = (nd - 1, nd - 2) + tuple(range(0, nd - 2))
        y = lax.conv_general_dilated(
            inputs, kernel, _per_dim(self.strides, rank),
            _padding(self.padding, rank),
            dimension_numbers=lax.ConvDimensionNumbers(lhs, rhs, lhs),
            feature_group_count=self.feature_group_count)
        return y if bias is None else _add_bias(y, bias)


class ConvTranspose(Module):
    features: int
    kernel_size: Sequence[int]
    strides: Union[None, int, Sequence[int]] = None
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = _default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        ks = _tuple(self.kernel_size)
        rank = len(ks)
        kernel = self.param("kernel", self.kernel_init,
                            ks + (inputs.shape[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        y = lax.conv_transpose(
            inputs, kernel, _per_dim(self.strides, rank),
            _padding(self.padding, rank))
        return y if bias is None else _add_bias(y, bias)


def _stats(x, axes, dtype):
    """f32 (at least) mean and E[x^2]-E[x]^2 variance clipped at 0."""
    dtype = jnp.promote_types(dtype or jnp.result_type(x), jnp.float32)
    x = x.astype(dtype)
    mu = x.mean(axes)
    mu2 = lax.square(x).mean(axes)
    return mu, jnp.maximum(0.0, mu2 - lax.square(mu))


def _normalize(module, x, mean, var, axes, dtype, param_dtype, epsilon,
               use_bias, use_scale, bias_init, scale_init):
    feat = x.shape[-1]
    shape = (1,) * (x.ndim - 1) + (feat,)
    y = x - jnp.expand_dims(mean, axes)
    mul = lax.rsqrt(jnp.expand_dims(var, axes) + epsilon)
    args = [x]
    if use_scale:
        scale = module.param("scale", scale_init, (feat,),
                             param_dtype).reshape(shape)
        mul = mul * scale
        args.append(scale)
    y = y * mul
    if use_bias:
        bias = module.param("bias", bias_init, (feat,),
                            param_dtype).reshape(shape)
        y = y + bias
        args.append(bias)
    if dtype is None:
        dtype = _promote(*args)[0].dtype
    return jnp.asarray(y, dtype)


class BatchNorm(Module):
    """Batch normalisation over every axis but the last; running
    statistics live in the 'batch_stats' collection."""

    use_running_average: Optional[bool] = None
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x, use_running_average: Optional[bool] = None):
        use_ra = (self.use_running_average if use_running_average is None
                  else use_running_average)
        if use_ra is None:
            raise ValueError("BatchNorm needs use_running_average")
        feat = (x.shape[-1],)
        axes = tuple(range(x.ndim - 1))
        ra_mean = self._variable("batch_stats", "mean",
                                 lambda: jnp.zeros(feat, jnp.float32))
        ra_var = self._variable("batch_stats", "var",
                                lambda: jnp.ones(feat, jnp.float32))
        if use_ra:
            mean, var = ra_mean, ra_var
        else:
            mean, var = _stats(x, axes, self.dtype)
            if not self.is_initializing():
                m = self.momentum
                self._scope.put("batch_stats", "mean",
                                m * ra_mean + (1 - m) * mean)
                self._scope.put("batch_stats", "var",
                                m * ra_var + (1 - m) * var)
        return _normalize(self, x, mean, var, axes, self.dtype,
                          self.param_dtype, self.epsilon, self.use_bias,
                          self.use_scale, self.bias_init, self.scale_init)


class LayerNorm(Module):
    """Layer normalisation over the last axis."""

    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x):
        mean, var = _stats(x, (x.ndim - 1,), self.dtype)
        return _normalize(self, x, mean, var, (x.ndim - 1,), self.dtype,
                          self.param_dtype, self.epsilon, self.use_bias,
                          self.use_scale, self.bias_init, self.scale_init)


class Dropout(Module):
    rate: float
    deterministic: Optional[bool] = None
    rng_collection: str = "dropout"

    @compact
    def __call__(self, inputs, deterministic: Optional[bool] = None):
        det = self.deterministic if deterministic is None else deterministic
        if det is None:
            raise ValueError("Dropout needs deterministic=True/False")
        if self.rate == 0.0 or det:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng(self.rng_collection),
                                    p=keep, shape=inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


class Embed(Module):
    num_embeddings: int
    features: int
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    embedding_init: Callable = _default_embed_init

    @compact
    def __call__(self, inputs):
        if not jnp.issubdtype(inputs.dtype, jnp.integer):
            raise ValueError("Embed inputs must be integers")
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features),
                           self.param_dtype)
        (table,) = _promote(table, dtype=self.dtype, inexact=False)
        return jnp.take(table, inputs, axis=0)


def max_pool(inputs, window_shape: Sequence[int],
             strides: Optional[Sequence[int]] = None, padding="VALID"):
    """Max pooling over the spatial dims of [B, *spatial, C] inputs."""
    window = tuple(window_shape)
    strides = tuple(strides) if strides is not None else (1,) * len(window)
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(tuple(p) for p in padding) + ((0, 0),)
    return lax.reduce_window(inputs, -jnp.inf, lax.max, (1,) + window + (1,),
                             (1,) + strides + (1,), padding)


# ---------------------------------------------------------------------------
# frozen dataclass pytrees
# ---------------------------------------------------------------------------


def static_field(**kwargs):
    """A PyTreeNode field kept out of the pytree leaves (hashed as
    static jit metadata instead)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


class PyTreeNode:
    """Frozen dataclass registered as a pytree; `replace` returns a copy
    with some fields changed."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields
                         if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")])

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)
