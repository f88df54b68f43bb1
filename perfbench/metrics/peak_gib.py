"""The allocator's peak on the card over the program's set-up and the
window (``torch.cuda.max_memory_allocated``, reset once the collection
is drawn, read before the reference runs), in GiB."""
LAYER = "device"
UNIT = "GiB"
SOURCE = "device_trace"
MOVES = "peak_gib"


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
