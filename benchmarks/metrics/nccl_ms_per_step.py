"""nccl_ms_per_step: the device time of the NCCL kernels on rank 0 in the
traced window, over its training steps, in ms."""


def read(r):
    nccl_us = r["trace"].device_time_matching_us("nccl")
    if not nccl_us or not r.get("steps"):
        return None
    return nccl_us / 1e3 / r["steps"]
