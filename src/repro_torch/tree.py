"""Nested-dict trees: the port's stand-in for the JAX package's pytrees.

The reference keeps parameters, optimizer state and error-feedback state
as nested dicts of arrays and walks them with ``jax.tree``; its leaves
cross to the port as numpy arrays (``from_numpy``, ``to_numpy``).  The port keeps
the same nesting (dicts, or ``nn.ParameterDict``s for parameters) of
tensors and walks it here in JAX's order: a dict's keys sorted, depth
first.  That order is the optimizer's summation order and the
checkpoint's leaf index, so a checkpoint written by either package
restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _is_node(x) -> bool:
    return isinstance(x, dict) or (hasattr(x, "keys")
                                   and not isinstance(x, torch.Tensor))


def leaves_with_path(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in JAX's flatten order (keys sorted)."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree.keys()):
        out.extend(leaves_with_path(tree[key], prefix + (key,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def keystr(path: Path) -> str:
    """JAX's ``keystr`` of a dict path: ``['a']['b']``."""
    return "".join(f"[{key!r}]" for key in path)


def unflatten(pairs) -> Dict[str, Any]:
    """Nested dicts from ``(path, value)`` pairs."""
    root: Dict[str, Any] = {}
    for path, value in pairs:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return root


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same paths of ``rest``),
    as nested dicts of the same structure, empty dicts kept."""
    if _is_node(tree):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree.keys())}
    return fn(tree, *rest)


def map_structure(fn: Callable, tree, is_leaf: Callable = lambda x: False):
    """``fn`` over the leaves of a tree of dicts (keys sorted), tuples and
    NamedTuples (in their order, their type kept): the pytree walk of
    decode states (``attention.KVCache``, the cross K/V pairs) and of spec
    trees, whose ``PartitionSpec`` leaves are tuples (``is_leaf``)."""
    if is_leaf(tree):
        return fn(tree)
    if _is_node(tree):
        return {key: map_structure(fn, tree[key], is_leaf)
                for key in sorted(tree.keys())}
    if isinstance(tree, tuple):
        out = [map_structure(fn, t, is_leaf) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def from_numpy(arr) -> torch.Tensor:
    """A numpy leaf of the reference as a tensor of its own (a copy: the
    reference's arrays may be read-only views of JAX's buffers); bfloat16
    (``ml_dtypes``, which the port does not import) through its 16-bit
    view."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (imported only once a tensor that is not
    an ordinary one turns up)."""
    if type(x) is torch.Tensor or isinstance(x, torch.nn.Parameter) \
            or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def to_numpy(t: torch.Tensor, name: str = "") -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its dtype's name; bfloat16 as its
    uint16 view, as the reference stores it.  A DTensor is refused (each
    rank holds a chunk of it: ``train.checkpoint`` gathers it first);
    ``name`` names the leaf in the error."""
    if is_dtensor(t):
        raise TypeError(f"leaf {name or '?'} is a DTensor: each rank holds "
                        f"a chunk of it, gather it first (checkpoint.save "
                        f"gathers DTensor leaves to their owner ranks)")
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def dtype_name(dtype: torch.dtype) -> str:
    """The name ``to_numpy`` gives a leaf of ``dtype`` (numpy's)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def get(tree, path: Path):
    for key in path:
        tree = tree[key]
    return tree
