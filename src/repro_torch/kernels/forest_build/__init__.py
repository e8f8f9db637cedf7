"""Segmented-MBR reduction for the device R-tree bulk load."""

from .ops import (
    TN,
    gather_child_slots,
    level_mbr,
    mbr_reduce,
    np_inert_plane,
    seg_mbr,
    seg_mbr_torch,
    slot_major,
    tile_pyramid_device,
)

__all__ = [
    "TN", "gather_child_slots", "level_mbr", "mbr_reduce",
    "np_inert_plane", "seg_mbr", "seg_mbr_torch", "slot_major",
    "tile_pyramid_device",
]
