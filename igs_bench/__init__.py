"""The benchmark of ``igs_tpu_torch``, the PyTorch/CUDA port of Instant
Gaussian Stream: ``python -m igs_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``)."""
