"""K5: the int8 weight-only products of decode steps (``int8_gemv.cu``).

Work: every decode step reads each decoder layer's int8 projections
(fused qkv, o, fused gate-up, down) once, with their float32 per-channel
scales, and the step's rows of bf16 activations in and out; operations
2 M N K for M rows (the engine's slots). The head's int8 product is not
counted: its 32,258 rows are not a multiple of 128 and take the
dequantized product. None for a bf16 configuration.
"""
from h100bench.work import decoder_projections, dims

PATTERNS = ("int8_gemv",)
BOUND = "int8_ops"


def work(log, cfg):
    if cfg["weights"] != "int8" or log.steps <= 0:
        return None
    m = log.slots
    ops = nbytes = 0
    for _, n, k in decoder_projections(cfg):
        ops += 2 * m * n * k
        nbytes += n * k + 4 * n + 2 * m * (n + k)
    layers = dims(cfg)["layers"]
    return ops * layers * log.steps, nbytes * layers * log.steps
