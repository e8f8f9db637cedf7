"""Packed boolean OR-AND matrix product, the step of the device closure."""

from .ops import (
    bitset_mm,
    bitset_mm_torch,
    pack_bits,
    uint32_bits,
    unpack_bits,
)

__all__ = ["bitset_mm", "bitset_mm_torch", "pack_bits", "uint32_bits",
           "unpack_bits"]
