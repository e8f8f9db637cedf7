"""Analytics query classes (RangeCount / RangeCollect results)."""

from .program import CollectResult

__all__ = ["CollectResult"]
