from . import (  # noqa: F401
    colors,
    intersect,
    lighting,
    matrices,
    normals,
    patterns,
    rays,
    shading,
    transforms,
    tuples,
    vec,
)
