"""h2d_mb.stream: the bytes the stream loop copies from host arrays to the
device a window of the traced clip, in MB (1e6 bytes): the program's
counter ``stream.h2d_bytes`` (the batch, the first window's depth, the
refine's views) over the clip's AGM-Net forwards, one a window. The
program counts only while a profiler is active, which in this cell's run
is the traced clip alone."""

MOVES = "stream_fps"


def read(obs):
    from igs_bench.spans import program_counters

    windows = (obs.get("trace") or {}).get("agm_forwards")
    nbytes = program_counters().get("stream.h2d_bytes")
    if not windows or nbytes is None:
        return None
    return nbytes / windows / 1e6
