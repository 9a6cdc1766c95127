"""setup_s: seconds from the process's start to the opening of the
measured window (imports, inputs, weights, builds, the warm clip)."""

MOVES = None


def read(obs):
    return obs.get("setup_s")
