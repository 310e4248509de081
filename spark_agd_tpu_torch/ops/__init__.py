"""spark_agd_tpu_torch.ops subpackage."""
