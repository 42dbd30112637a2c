from . import (  # noqa: F401
    colors,
    intersect,
    lighting,
    matrices,
    normals,
    patterns,
    rays,
    transforms,
    tuples,
    vec,
)
