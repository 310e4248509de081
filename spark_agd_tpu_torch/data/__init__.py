"""spark_agd_tpu_torch.data subpackage."""
