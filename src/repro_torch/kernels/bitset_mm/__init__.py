"""Packed boolean OR-AND matrix product, the step of the device closure,
and the unscheduled closure built on it."""

from .ops import (
    bitset_mm,
    bitset_mm_mxu,
    bitset_mm_torch,
    closure_fixpoint,
    pack_bits,
    uint32_bits,
    unpack_bits,
)

__all__ = ["bitset_mm", "bitset_mm_mxu", "bitset_mm_torch",
           "closure_fixpoint", "pack_bits", "uint32_bits", "unpack_bits"]
