"""refine_step_ms: the pipeline's ``refine_log[*].ms_per_step`` (CUDA events
over a key frame's Adam steps, densify included), the mean over the
measured window's key frames."""

MOVES = "stream_fps"


def read(obs):
    ms = obs.get("refine_ms_per_step")
    if not ms:
        return None
    return sum(ms) / len(ms)
