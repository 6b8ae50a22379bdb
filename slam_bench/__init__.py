"""The benchmark of fast_lio_sam_qn_tpu_torch (see README.md)."""
