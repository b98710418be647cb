"""Concrete configurations."""

from .babybear_poseidon2 import BabyBearPoseidon2Config  # noqa: F401
from .goldilocks_blake3 import GoldilocksBlake3Config  # noqa: F401
