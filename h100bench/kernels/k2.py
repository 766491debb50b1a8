"""K2: decode attention over the page pool (``paged_decode.cu``).

Work: each token a decode step produced, with a context of c rows, reads
c rows of bf16 keys and values in every layer and does 4 c d_head
operations a head; slots already finished inside a block are no work.
"""
from h100bench.work import dims

PATTERNS = ("paged_split_kernel", "paged_merge_kernel")
BOUND = "bf16_flops"


def work(log, cfg):
    if not log.decode_contexts:
        return None
    d = dims(cfg)
    rows = sum(log.decode_contexts)
    nbytes = rows * d["layers"] * 2 * d["kv_heads"] * d["hd"] * 2
    nbytes += len(log.decode_contexts) * d["layers"] * 2 * d["heads"] \
        * d["hd"] * 2
    ops = 4 * rows * d["layers"] * d["heads"] * d["hd"]
    return ops, nbytes
