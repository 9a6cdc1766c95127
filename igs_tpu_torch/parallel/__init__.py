"""The port's parallel paths over ``torch.distributed`` (counterpart of
``igs_tpu/parallel/``): process groups, the (data, tile) mesh of ranks,
the data-parallel AGM forward, and the launcher that starts ranks."""
