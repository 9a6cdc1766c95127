"""attn_roofline.stream: attention's least time over its device time in the
traced clip, in %. The least time is counted from AGM-Net's attention
shapes at the configuration's compute types (``igs_bench/flops.py``: the
triplane's and the swin windows', the shifted windows' masked pairs left
out) for each forward the clip ran; the device time is that of the
kernels named below, the port's attention forward (B7)."""

MOVES = "stream_fps"
KERNELS = ("attn_fwd",)


def read(obs):
    from igs_bench.trace import seconds_matching

    tr = obs.get("trace")
    if not tr or not tr.get("agm_forwards"):
        return None
    device_s = seconds_matching(tr["device_seconds"], KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * tr["agm_forwards"] * obs["attention_bound_s"] / device_s
