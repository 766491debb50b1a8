"""A kernel class that the tests add as a new file: the decoder's
products of each decode step, at the bf16 peak."""
from h100bench.work import decoder_projections, dims

PATTERNS = ("gemm",)
BOUND = "bf16_flops"


def work(log, cfg):
    if log.steps <= 0:
        return None
    m, layers = log.slots, dims(cfg)["layers"]
    ops = sum(2 * m * n * k for _, n, k in decoder_projections(cfg))
    nbytes = sum(2 * (n * k + m * (n + k))
                 for _, n, k in decoder_projections(cfg))
    return ops * layers * log.steps, nbytes * layers * log.steps
