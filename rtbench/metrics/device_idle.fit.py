from rtbench import readers


def read(r):
    return readers.device_idle(r)
