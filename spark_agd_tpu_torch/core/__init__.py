"""spark_agd_tpu_torch.core subpackage."""
