"""stream_fps: every frame whose window completed (its refine included)
over all the time of the measured window, on the host clock."""

MOVES = None


def read(obs):
    if "frames" not in obs or not obs.get("window_s"):
        return None
    return obs["frames"] / obs["window_s"]
