"""Seconds of ``core/build.build_index``'s postings phase (each
coordinate's top-lam postings picked out and ordered), from the build's
own phase timings, host clock to a synchronize; nothing where the
program does not time the phase."""
LAYER = "builders"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return (rec.values.get("build_phases") or {}).get("postings")
