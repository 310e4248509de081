"""Vector-space algebra over a tensor or a dict/list/tuple of tensors.

PyTorch counterpart of ``spark_agd_tpu/core/tvec.py``: the optimizer's
recurrences are vector-space operations that map leafwise, so the same
AGD loop drives a GLM weight vector, a ``(D, K)`` matrix or a dict of
MLP parameters.  Reductions (``dot``, ``norm``) return 0-d tensors on
the leaves' device; the caller decides when a scalar goes to the host.

The lanes (``lane``, ``stack_lanes``, ``lane_dot``) hold K trees of one
structure stacked on a leading axis, the port's counterpart of a tree
batched by ``jax.vmap``.
"""

from __future__ import annotations

import torch


def leaves(tree):
    """The tensors of ``tree`` in a fixed order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten_like(tree, leaves):
    """Tensors of the ``leaves`` iterator (tensors or arrays) in
    ``tree``'s structure and on its leaves' devices, in the order of
    :func:`leaves`."""
    if isinstance(tree, dict):
        out = {k: unflatten_like(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        parts = [unflatten_like(t, leaves) for t in tree]
        return tuple(parts) if isinstance(tree, tuple) else parts
    return torch.as_tensor(next(leaves)).to(tree.device)


def tmap(fn, *trees):
    """Apply ``fn`` leafwise over trees of one structure; mismatched
    structures raise instead of silently truncating."""
    first = trees[0]
    if isinstance(first, dict):
        keys = set(first)
        for t in trees[1:]:
            if not isinstance(t, dict) or set(t) != keys:
                raise ValueError("tree structures differ")
        return {k: tmap(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        for t in trees[1:]:
            if not isinstance(t, (list, tuple)) or len(t) != len(first):
                raise ValueError("tree structures differ")
        out = [tmap(fn, *parts) for parts in zip(*trees)]
        return tuple(out) if isinstance(first, tuple) else out
    for t in trees[1:]:
        if isinstance(t, (dict, list, tuple)):
            raise ValueError("tree structures differ")
    return fn(*trees)


def add(a, b):
    return tmap(torch.add, a, b)


def sub(a, b):
    return tmap(torch.sub, a, b)


def scale(s, a):
    return tmap(lambda x: s * x, a)


def axpby(alpha, a, beta, b):
    """``alpha * a + beta * b`` leafwise (the AT interpolation primitive)."""
    return tmap(lambda x, y: alpha * x + beta * y, a, b)


def _reduce_leaves(parts):
    if not parts:
        return torch.zeros((), dtype=torch.float32)
    return sum(parts[1:], parts[0])


def dot(a, b):
    """Full inner product across all leaves, in the leaf dtype."""
    parts = leaves(tmap(lambda x, y: torch.vdot(x.reshape(-1),
                                                y.reshape(-1)), a, b))
    return _reduce_leaves(parts)


def sq_norm(a):
    return dot(a, a)


def norm(a):
    return torch.sqrt(sq_norm(a))


def zeros_like(a):
    return tmap(torch.zeros_like, a)


def size(a):
    """Total element count across leaves (Python int)."""
    return sum(x.numel() for x in leaves(a))


def l1_norm(a):
    return _reduce_leaves([x.abs().sum() for x in leaves(a)])


def isfinite_all(a):
    parts = [torch.isfinite(x).all() for x in leaves(a)]
    if not parts:
        return torch.tensor(True)
    out = parts[0]
    for p in parts[1:]:
        out = out & p
    return out


def lane(tree, k: int):
    """Lane ``k`` of a tree stacked on a leading lane axis."""
    return tmap(lambda a: a[k], tree)


def stack_lanes(trees):
    """Stack trees of one structure on a new leading lane axis."""
    return tmap(lambda *xs: torch.stack(xs), *trees)


def lane_dot(a, b):
    """``(K,)`` inner products of the lanes of two stacked trees, in the
    leaf dtype."""
    parts = leaves(tmap(lambda x, y: (x * y).reshape(x.shape[0], -1).sum(1),
                        a, b))
    return sum(parts[1:], parts[0])
