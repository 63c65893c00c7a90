"""Logical-axis sharding annotations.

Models never mention physical mesh axes: they call
``constrain(x, "batch", "seq", "embed")`` with *logical* axis names, and a
rule table binds those names to a mesh.  The port has no mesh yet, so
``constrain`` is the identity, as the JAX package's is outside any mesh
binding.  It stays the one place where tensor placements (DTensor) will
land, without touching the model files.
"""
from __future__ import annotations


def constrain(x, *logical):
    """``x`` unchanged: no mesh is bound in the port (``logical`` names the
    axes of ``x`` for when one is)."""
    del logical
    return x
