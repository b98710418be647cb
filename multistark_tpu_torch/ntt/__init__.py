"""Batched NTT / LDE on torch tensors."""

from .ntt import NttEngine, ntt_stage_  # noqa: F401
