from .canvas import Canvas, write_ppm  # noqa: F401
