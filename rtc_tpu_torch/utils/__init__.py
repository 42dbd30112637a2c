from .config import DEFAULT_CONFIG, RenderConfig  # noqa: F401
from .constants import BIG, EPSILON, is_almost_equal  # noqa: F401
