"""Process start to the first timed query: CUDA start-up, the kernels
loaded (built in a checkout's first run), the collection drawn, the
index and graph built, the parameters resolved and the cell's batches
warmed."""
LAYER = "entry"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return rec.setup_s
