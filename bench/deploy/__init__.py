"""One module a deployment kind (a config's ``kind``): builds the kind's
data into the port from the seed and turns a query spec into the plan the
port's apps make for it."""

from __future__ import annotations

from typing import Callable

from .. import traffic


def compose(spec, leaf_plan: Callable):
    """The ``(expression, env)`` plan of a spec of any form: each leaf's
    own plan (``leaf_plan(element)``, the app's plan of one range or
    bitmap) joined by the expressions' ``&``, ``|`` and ``~``
    (``traffic.fold``), and the env the union of the leaves' envs, where
    one name is one handle."""
    env = {}

    def leaf(element):
        expression, part = leaf_plan(element)
        for name, handle in part.items():
            if env.setdefault(name, handle) is not handle:
                raise ValueError(f"two handles named {name!r} in {spec!r}")
        return expression

    return traffic.fold(spec, leaf), env
