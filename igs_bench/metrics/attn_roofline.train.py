"""attn_roofline.train: attention's least time over its device time in the
traced steps, in %. The least time is counted from AGM-Net's attention
shapes at the configuration's compute types (``igs_bench/flops.py``: the
triplane's and the swin windows', the shifted windows' masked pairs left
out), forward and backward, for each step traced; the device time is
that of the kernels named below: the forward (B7) and the backward
(B8)."""

MOVES = "train_samples_per_s"
KERNELS = ("attn_fwd", "attn_delta", "attn_dkv", "attn_dq")


def read(obs):
    from igs_bench.trace import seconds_matching

    tr = obs.get("trace")
    if not tr or not tr.get("agm_forwards"):
        return None
    device_s = seconds_matching(tr["device_seconds"], KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * tr["agm_forwards"] * obs["attention_bound_s"] / device_s
