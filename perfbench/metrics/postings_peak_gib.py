"""The card allocator's peak over ``core/build.build_index``'s postings
phase, in GiB: the build's own counter (``postings_peak_bytes`` among its
phase timings, ``torch.cuda.max_memory_allocated`` at the phase's end;
the harness resets the peak once the collection is drawn, so this is the
phase's peak, the collection included). Nothing where the program keeps
no such counter."""
LAYER = "builders"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "peak_gib"


def read(rec):
    peak = (rec.values.get("build_phases") or {}).get("postings_peak_bytes")
    return peak / 2**30 if peak else None
