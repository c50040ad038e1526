"""Wrapping the program's functions for the traced runs, from outside it.

A target is written "module:attribute.path", e.g.
"afesp_tpu_torch.driver:do_ccsd_spatial" or
"afesp_tpu_torch.driver:dat.read_integrals".  `wrap_everywhere` replaces
the function it names in every loaded module of the program that holds
it under any name (a function imported by name into another module is
bound there too), and `restore` puts every original back.  A target the
program no longer has is skipped: the metric that reads it then finds
nothing to read.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable

PROGRAM = "afesp_tpu_torch"


def resolve(target: str):
    """The object a target names, or None."""
    mod_name, _, path = target.partition(":")
    try:
        obj = importlib.import_module(mod_name)
    except ImportError:
        return None
    for part in path.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


class Patches:
    """The replacements made, for `restore`."""

    def __init__(self):
        self.made: list[tuple[object, str, object]] = []

    def wrap_everywhere(self, target: str, make_wrapper: Callable) -> bool:
        """Replace the function `target` names by make_wrapper(original)
        wherever the program holds it; False if there is no such function."""
        fn = resolve(target)
        if fn is None or not callable(fn):
            return False
        wrapper = make_wrapper(fn)
        for name, mod in list(sys.modules.items()):
            if mod is None or not (name == PROGRAM or name.startswith(PROGRAM + ".")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is fn:
                    self.made.append((mod, attr, fn))
                    setattr(mod, attr, wrapper)
        return True

    def restore(self) -> None:
        for mod, attr, fn in reversed(self.made):
            setattr(mod, attr, fn)
        self.made.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()
