"""K1: flash attention in the vision tower and prefill (``flash_attn.cu``,
bf16).

Work: a tower block attends its patches to each other (4 S^2 d_head
operations a head; q, k, v read and the output written once); a
prefill of rows
[start, end) attends each row to the rows up to it, reading q and the
output for its own rows and k and v for every row it sees.
"""
from h100bench.work import dims, prefill_keys

PATTERNS = ("flash_fwd_kernel", "flash_split_kernel")
BOUND = "bf16_flops"


def work(log, cfg):
    d = dims(cfg)
    s, vhd = d["patches"], d["v_heads"] * d["v_hd"]
    blocks = log.prompt_images * d["feature_blocks"]
    ops = 4 * s * s * vhd * blocks
    nbytes = 4 * s * vhd * 2 * blocks
    hd_all = d["heads"] * d["hd"]
    kv_all = d["kv_heads"] * d["hd"]
    for start, end in log.prefills:
        ops += 4 * prefill_keys(start, end) * hd_all * d["layers"]
        nbytes += (2 * (end - start) * hd_all + 2 * end * kv_all) * 2 \
            * d["layers"]
    if ops == 0:
        return None
    return ops, nbytes
