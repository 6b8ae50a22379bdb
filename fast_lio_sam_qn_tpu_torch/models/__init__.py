"""Models of the port; each module mirrors fast_lio_sam_qn_tpu/models/."""
