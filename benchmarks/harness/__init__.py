"""The benchmark harness of ``vgan_tpu_torch``: cell loading, the runners of each traffic kind,
tracing, the yardstick and the correctness comparison."""
