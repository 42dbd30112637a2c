from rtbench import readers


def read(r):
    return readers.kernel_ms(r)
