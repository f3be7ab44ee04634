"""Axis-aligned boxes in (x, y, w, h) form.

Counterpart of `vpd_tpu/utils/box.py` (a copy: this package imports
nothing of `vpd_tpu`).
"""

from typing import NamedTuple


class Box(NamedTuple):
    x: int
    y: int
    w: int
    h: int

    @property
    def x2(self):
        return self.x + self.w

    @property
    def y2(self):
        return self.y + self.h

    @property
    def area(self):
        return self.w * self.h


def calc_iou(b1, b2):
    iw = min(b1.x2, b2.x2) - max(b1.x, b2.x)
    ih = min(b1.y2, b2.y2) - max(b1.y, b2.y)
    isect = max(iw, 0) * max(ih, 0)
    return isect / (b1.area + b2.area - isect)


def calc_union(b1, b2):
    x1, y1 = min(b1.x, b2.x), min(b1.y, b2.y)
    return Box(x1, y1,
               max(b1.x2, b2.x2) - x1,
               max(b1.y2, b2.y2) - y1)


def calc_contains(box, x, y):
    """True if point (x, y) lies inside box (boundary inclusive)."""
    return 0 <= x - box.x <= box.w and 0 <= y - box.y <= box.h
