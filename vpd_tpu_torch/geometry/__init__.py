from .skeleton import SkeletonSpec  # noqa: F401
from . import coco  # noqa: F401
