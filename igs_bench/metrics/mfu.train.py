"""mfu.train: AGM-Net's model FLOPs (forward and backward) of every step of
the measured window over its wall time and the configuration's peak, in
%. The FLOPs of one step are counted on the plain reference at the cell's
shapes (``igs_bench/flops.py``); the peak is the configuration's
``peak``."""

MOVES = "train_samples_per_s"


def read(obs):
    if not obs.get("steps") or not obs.get("window_s"):
        return None
    rate = obs["steps"] * obs["agm_flops"] / obs["window_s"]
    return 100.0 * rate / float(obs["cfg"]["peak"]["flops_per_s"])
