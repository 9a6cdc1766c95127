"""mfu.stream: AGM-Net's model FLOPs of every window of the measured
window over its wall time and the configuration's peak, in %. The FLOPs of
one window are counted on the plain reference at the cell's shapes
(``igs_bench/flops.py``); the peak is the configuration's ``peak``."""

MOVES = "stream_fps"


def read(obs):
    if not obs.get("windows") or not obs.get("window_s"):
        return None
    rate = obs["windows"] * obs["agm_flops"] / obs["window_s"]
    return 100.0 * rate / float(obs["cfg"]["peak"]["flops_per_s"])
