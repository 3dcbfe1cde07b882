"""Pytree registration of the batch and operator dataclasses.

Tensor fields (and the operators nested in them) are children; every other
field (ints, strings, host NumPy arrays), and which optional fields are
None, is static context.  So
``torch.utils._pytree.tree_flatten(batch)`` lists a batch's tensors in a
fixed order, and ``tree_unflatten`` rebuilds the batch from tensors alone:
an exported program takes a batch as its flat tensors
(``serving.export_forward``), as the JAX package's ``tree_flatten`` does.
``static_signature`` is the part of the context such a program was traced
with: a batch must share it with the template, as well as its tensors'
shapes, to be read as the template was.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch.utils._pytree as pytree

# registered class -> (its static fields, those of them that are host-only)
_STATIC: Dict[type, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}


def register_tensor_dataclass(cls, static: Sequence[str] = (), host: Sequence[str] = ()):
    """Register the frozen dataclass ``cls`` as a pytree node whose
    ``static`` fields ride in the context.  The ``host`` fields among them
    are host-side data that no traced program reads (a batch's output row
    indices); ``static_signature`` leaves them out.  Returns ``cls``."""
    static = tuple(static)
    _STATIC[cls] = (static, tuple(host))
    fields = tuple(f.name for f in dataclasses.fields(cls) if f.name not in static)

    def flatten(obj):
        # a field that is None (an operator the batch lacks) is no child
        present = tuple(name for name in fields if getattr(obj, name) is not None)
        return [getattr(obj, name) for name in present], (present, tuple(getattr(obj, name) for name in static))

    def unflatten(values, context):
        present, static_values = context
        absent = {name: None for name in fields if name not in present}
        return cls(**dict(zip(present, values)), **absent, **dict(zip(static, static_values)))

    pytree.register_pytree_node(cls, flatten, unflatten)
    return cls


def _plain(value):
    """``value`` with NumPy scalars as Python numbers and tuples as lists."""
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    return value.item() if hasattr(value, "item") else value


def static_signature(spec: pytree.TreeSpec):
    """The static context of a flattened tree as JSON data, host-only
    fields left out: for each node its type, its present fields and their
    static values, then its children's signatures."""
    if spec.is_leaf():
        return None
    node = [spec.type.__name__]
    if spec.type in _STATIC:
        names, host = _STATIC[spec.type]
        present, values = spec.context
        node += [list(present), {n: _plain(v) for n, v in zip(names, values) if n not in host}]
    else:
        node.append(repr(spec.context))
    return node + [[static_signature(spec.child(i)) for i in range(spec.num_children)]]
