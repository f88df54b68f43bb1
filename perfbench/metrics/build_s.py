"""Seconds of ``core/build.build_index`` on the collection, host clock
to a synchronize."""
LAYER = "builders"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return rec.values.get("build_s")
