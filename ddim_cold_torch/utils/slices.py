"""Refusal of options that belong to later slices of the port.

The port mirrors the JAX package's signatures. An option whose slice has
not landed yet is accepted only at its off value; any other value raises
``NotImplementedError`` naming the ROADMAP.md item that brings it, so
nothing is silently ignored.
"""

from __future__ import annotations


def refuse_later(given: dict, table: dict, where: str) -> None:
    """``table`` maps option name → (off value, ROADMAP.md item)."""
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{where} got an unexpected argument {name!r}")
        off, item = table[name]
        if value is not off and value != off:
            raise NotImplementedError(
                f"{where}({name}={value!r}) is not ported yet: ROADMAP.md {item}")
