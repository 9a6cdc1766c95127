"""train_bwd_ms: the backward (loss → backward), from the CUDA events
the benchmark records at the train step's ``on_stage`` marks, the mean
over the measured window's steps, in ms."""

MOVES = "train_samples_per_s"


def read(obs):
    return obs.get("bwd_ms")
