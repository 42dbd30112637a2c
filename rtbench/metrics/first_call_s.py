def read(r):
    """Host seconds of the first render() or train step: the kernel
    library's build or load, the eager run and the CUDA graph's capture."""
    return r.host.get("first_call_s")
