"""User-function signature introspection.

The reference deduces tuple/result/state/key types and riched-ness from C++
functor signatures with heavy template metaprogramming
(reference ``wf/meta.hpp:84-256``).  In Python the same job is a
``inspect.signature`` arity check: a user function is "riched" when it accepts
a trailing ``RuntimeContext`` parameter.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable


def _positional_arity(fn: Callable) -> int:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return -1  # builtins / C callables: assume non-riched
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            # Only *required* positionals count: a defaulted trailing param is
            # a closure helper, not a RuntimeContext slot.
            if p.default is inspect.Parameter.empty:
                n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return -1
    return n


def is_riched(fn: Callable, base_arity: int) -> bool:
    """True when ``fn`` takes ``base_arity + 1`` positional args, the extra one
    being the RuntimeContext (reference meta.hpp riched variants)."""
    n = _positional_arity(fn)
    if n < 0:
        return False
    return n == base_arity + 1


def adapt(fn: Callable, base_arity: int) -> Callable:
    """Normalize a possibly-riched user function to always accept
    ``(*args, context)``: non-riched functions get the context swallowed."""
    if is_riched(fn, base_arity):
        return fn

    @functools.wraps(fn)
    def wrapper(*args):
        return fn(*args[:-1])

    return wrapper
