"""refine_graph_share.stream: the share of the traced clip's refine steps
that replayed a CUDA graph, in %: the program's counter
``refine.graph_replays`` over it plus ``refine.eager_steps`` (every step
run uncaptured: the eager route's, and a new graph's warm-up before its
capture). The program counts only while a profiler is active, which in
this cell's run is the traced clip alone. None where the program counts
neither."""

MOVES = "stream_fps"


def read(obs):
    from igs_bench.spans import program_counters

    counters = program_counters()
    replays = counters.get("refine.graph_replays", 0)
    steps = replays + counters.get("refine.eager_steps", 0)
    if steps <= 0:
        return None
    return 100.0 * replays / steps
