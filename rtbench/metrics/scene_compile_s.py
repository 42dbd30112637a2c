def read(r):
    """Host seconds to read the scene's files and run compile_scene."""
    return r.host.get("scene_compile_s")
