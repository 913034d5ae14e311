"""Descriptor matching."""

from . import matcher  # noqa: F401
