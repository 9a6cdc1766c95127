"""blend_ns_per_pair.stream: the device time of the packed blend kernels
(``csrc/blend_fwd.cu``'s and ``blend_bwd.cu``'s, by the names the trace
gives them, the tile-order kernel of each launch included) in the traced
clip, over the tile pairs their launches walked (the program's counters
``raster.pairs_blended.fwd`` and ``.bwd``, which count only while a
profiler is active: in this cell's run, the traced clip), in ns a pair."""

MOVES = "stream_fps"
KERNELS = ("blend_fwd_kernel", "blend_bwd_kernel", "tile_order_kernel")
COUNTERS = ("raster.pairs_blended.fwd", "raster.pairs_blended.bwd")


def read(obs):
    from igs_bench.spans import program_counters
    from igs_bench.trace import seconds_matching

    counters = program_counters()
    pairs = sum(counters.get(k, 0) for k in COUNTERS)
    device_s = seconds_matching(
        (obs.get("trace") or {}).get("device_seconds") or {}, KERNELS)
    if pairs <= 0 or device_s <= 0:
        return None
    return 1e9 * device_s / pairs
