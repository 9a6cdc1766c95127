"""The plain reference of the benchmark: a frozen copy of the port's plain
modules (AGM-Net, the anchors, the tile rasterizer in plain PyTorch, the
key-frame refine), with no kernel, no pair budget and no shared pair list.

It imports nothing of ``igs_tpu_torch``; the benchmark builds it from the
same inputs and weights as the program and computes in float32 with TF32
off (``strict_fp32``). ``lowp.control()`` computes it one precision step
below the configuration instead: the control that a comparison must fail.
"""
