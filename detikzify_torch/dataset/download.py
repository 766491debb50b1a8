"""Minimal download helper with local-cache reuse (network environments;
counterpart of ``detikzify_tpu/dataset/download.py``). ``requests`` is
imported only when a file is fetched."""
from __future__ import annotations

import hashlib
import os


def fetch(url: str, cache_dir: str | None = None) -> str:
    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "detikzify_torch")
    os.makedirs(cache_dir, exist_ok=True)
    name = hashlib.sha1(url.encode()).hexdigest()[:16] + "-" + \
        os.path.basename(url)
    path = os.path.join(cache_dir, name)
    if os.path.exists(path):
        return path
    import requests

    with requests.get(url, stream=True, timeout=60) as resp:
        resp.raise_for_status()
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            for chunk in resp.iter_content(1 << 20):
                f.write(chunk)
        os.replace(tmp, path)
    return path
