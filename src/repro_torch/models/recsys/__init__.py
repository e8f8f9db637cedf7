from .din import DINConfig
from . import din
