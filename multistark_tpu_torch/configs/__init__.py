"""Concrete configurations."""

from .goldilocks_blake3 import GoldilocksBlake3Config  # noqa: F401
