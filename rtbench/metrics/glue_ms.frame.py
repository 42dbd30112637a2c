from rtbench import readers


def read(r):
    return readers.glue_ms(r)
