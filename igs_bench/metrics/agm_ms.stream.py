"""agm_ms.stream: the pipeline's ``AGM_times`` (anchors, AGM-Net's forward
and its renders, host clock after a device sync), the mean over the
measured window's windows, in ms."""

MOVES = "stream_fps"


def read(obs):
    times = obs.get("agm_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
