"""train_opt_ms: the optimizer's update, clip and schedule
(backward → optimizer), from the CUDA events the benchmark records
at the train step's ``on_stage`` marks, the mean over the measured
window's steps, in ms."""

MOVES = "train_samples_per_s"


def read(obs):
    return obs.get("opt_ms")
