"""Work a window needs, counted from what the harness saw and the
configuration, the same whichever kernel does it; kernel classes and the
table of peaks.

``Log`` gathers, over a traced window: decode steps, the context of every
token a decode step produced, every prefill window, and every pass of the
vision tower. A kernel class is a file ``kernels/<name>.py`` with
``PATTERNS`` (substrings of the profiler's kernel names), ``BOUND`` (the
peak its operations are held to, a key of ``peaks.json``) and
``work(log, cfg) -> (operations, bytes)``, or ``None`` where the window
gave it nothing to do.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List, Optional, Tuple

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Log:
    slots: int = 0
    steps: int = 0
    decode_contexts: List[int] = dataclasses.field(default_factory=list)
    prefills: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    prompt_images: int = 0          # tower to the feature layer, connector


def dims(cfg: dict) -> dict:
    heads = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // heads
    v = cfg["vision"]
    return {"layers": cfg["num_hidden_layers"], "heads": heads,
            "kv_heads": cfg["num_key_value_heads"], "hd": hd,
            "d": cfg["hidden_size"], "i": cfg["intermediate_size"],
            "vocab": cfg["vocab_size"],
            "v_layers": v["num_hidden_layers"],
            "v_heads": v["num_attention_heads"],
            "v_hd": v["hidden_size"] // v["num_attention_heads"],
            "v_d": v["hidden_size"], "v_i": v["intermediate_size"],
            "patches": (v["image_size"] // v["patch_size"]) ** 2,
            "patch_in": v["num_channels"] * v["patch_size"] ** 2,
            "feature_blocks": cfg["feature_layer"] % v["num_hidden_layers"]
            + 1}


def prefill_keys(start: int, end: int) -> int:
    """Query-key pairs of a causal prefill of rows [start, end) over a
    cache that holds rows [0, start): row r sees r + 1 keys."""
    return sum(r + 1 for r in range(start, end))


def decoder_projections(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, N, K) of one decoder layer's products."""
    d = dims(cfg)
    nq, nkv = d["heads"] * d["hd"], d["kv_heads"] * d["hd"]
    return [("qkv", nq + 2 * nkv, d["d"]), ("o", d["d"], nq),
            ("gateup", 2 * d["i"], d["d"]), ("down", d["d"], d["i"])]


def model_flops(log: Log, cfg: dict) -> float:
    """Model FLOPs of a window: 2 x the parameters each decoded or
    prefilled token uses, attention over its context, and each tower
    pass (its blocks' products and attention, and the connector)."""
    d = dims(cfg)
    per_token = sum(n * k for _, n, k in decoder_projections(cfg)) \
        * d["layers"]
    tokens = len(log.decode_contexts) + sum(e - s for s, e in log.prefills)
    heads_dim = d["heads"] * d["hd"]
    flops = 2.0 * per_token * tokens
    flops += 2.0 * d["vocab"] * d["d"] * (len(log.decode_contexts)
                                          + len(log.prefills))
    flops += 4.0 * heads_dim * d["layers"] * (
        sum(log.decode_contexts)
        + sum(prefill_keys(s, e) for s, e in log.prefills))
    s = d["patches"]
    block = 2.0 * s * (4 * d["v_d"] ** 2 + 2 * d["v_d"] * d["v_i"]) \
        + 4.0 * s * s * d["v_d"]
    embed = 2.0 * s * d["patch_in"] * d["v_d"]
    connector = 2.0 * s * d["v_d"] * d["d"]
    flops += log.prompt_images * (embed + d["feature_blocks"] * block
                                  + connector)
    return flops


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"h100bench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_class(name: str, root: Path = HERE):
    return load_module(root / "kernels" / f"{name}.py")


def roofline_share(name: str, log: Log, cfg: dict, kernel_s: float,
                   root: Path = HERE) -> Optional[float]:
    """Least time the class's work could take over the profiled time of
    its kernels, in percent; None where the window gave it no work or no
    kernel of the class ran."""
    kc = kernel_class(name, root)
    got = kc.work(log, cfg)
    if got is None or kernel_s <= 0:
        return None
    ops, nbytes = got
    pk = peaks()
    least = max(ops / pk[kc.BOUND], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least / kernel_s
