"""device_idle.train: 1 − the union of the device's operation intervals
over the traced span (whole training steps), in %."""

MOVES = "train_samples_per_s"


def read(obs):
    tr = obs.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
