"""Tree helpers used across training and checkpointing (twin of
``repro.utils.tree``).

A tree here is what the port's training state is made of: `Params`
modules (`repro_torch.models.layers`), nested dicts, lists, tuples and
NamedTuples of tensors, with ``None`` for an absent subtree (as JAX
treats it: no leaves).  Paths join dict keys, NamedTuple fields, list
indices and a module's parameter names with ``/`` (``'opt/mu/layers/0/
attn/q/kernel'``), the checkpoint's serialization keys.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree: Any):
    """(key, child) pairs of one level of ``tree``; a leaf has none."""
    if isinstance(tree, nn.Module):
        return [(name.replace(".", "/"), p) for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree: Any) -> Dict[str, Tensor]:
    """Flatten a tree into {'a/b/0': leaf} (checkpoint serialization keys).

    Dict keys are taken in sorted order, as JAX's tree flattening takes
    them; a module's parameters in registration order."""
    flat: Dict[str, Tensor] = {}
    _walk("", tree, flat)
    return flat


def _walk(prefix: str, node: Any, flat: Dict[str, Tensor]) -> None:
    # A module-level function: a recursive closure would be a reference
    # cycle holding ``flat``, and with it every leaf (a step's gradients),
    # until the cyclic garbage collector ran.
    if node is None:
        return
    items = _items(node)
    if items is None:
        flat[prefix] = node
        return
    for key, child in items:
        _walk(f"{prefix}/{key}" if prefix else key, child, flat)


def tree_leaves(tree: Any):
    return list(flatten_with_paths(tree).values())


def tree_size_bytes(tree: Any) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree)
               if isinstance(leaf, Tensor))


def tree_num_params(tree: Any) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree) if isinstance(leaf, Tensor))


def check_no_nans(tree: Any) -> Tuple[bool, str]:
    """Return (ok, message). ok=False if any floating leaf holds NaN/Inf."""
    for key, leaf in flatten_with_paths(tree).items():
        if isinstance(leaf, Tensor) and leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            return False, f"non-finite values at {key}"
    return True, "ok"


def map_with_paths(fn: Callable[[str, Tensor], Tensor], tree: Any) -> Any:
    """A new tree of ``tree``'s structure whose leaves are
    ``fn(path, leaf)``.  A `Params` module is rebuilt as a new `Params`
    whose leaves keep the old ones' ``requires_grad``."""
    from repro_torch.models.layers import Params

    def walk(prefix: str, node: Any) -> Any:
        def join(key):
            return f"{prefix}/{key}" if prefix else str(key)

        if node is None:
            return None
        if isinstance(node, Params):
            new = Params(walk(prefix, params_tree(node)))
            flags = {k: t.requires_grad for k, t in flatten_with_paths(node).items()}
            for key, t in flatten_with_paths(new).items():
                t.requires_grad_(flags[key])
            return new
        if isinstance(node, dict):
            return {k: walk(join(k), v) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(join(f), v) for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(join(i), v) for i, v in enumerate(node))
        return fn(prefix, node)

    return walk("", tree)


def params_tree(p) -> Dict[str, Any]:
    """A `Params` module as the nested dict (and lists) it was built from."""
    out: Dict[str, Any] = {name: t for name, t in p._parameters.items()}
    for name, mod in p._modules.items():
        out[name] = ([params_tree(m) for m in mod] if isinstance(mod, nn.ModuleList)
                     else params_tree(mod))
    return out
