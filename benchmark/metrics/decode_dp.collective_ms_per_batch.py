"""Device milliseconds of the NCCL kernels per global batch on rank 0 of
a data-parallel decode (the all-reduce of the longest share's frames and
the all-gathers that assemble the handle), in its traced batch. A
collective kernel runs until every rank has reached it, so this holds
rank 0's wait for the slowest rank as well as the transfer."""


def read(inputs):
    got = inputs.get("collectives")
    if not got or not got.get("batches"):
        return None
    return 1e3 * got["device_s"] / got["batches"]
