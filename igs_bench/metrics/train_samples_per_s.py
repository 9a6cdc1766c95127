"""train_samples_per_s: every pair trained over all the time of the
measured window, on the host clock."""

MOVES = None


def read(obs):
    if "steps" not in obs or not obs.get("window_s"):
        return None
    return obs["frames"] / obs["window_s"]
