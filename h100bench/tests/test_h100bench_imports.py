"""What a run loads, by whole top-level module names, in a fresh
interpreter: the harness never JAX or the JAX package; the reference
neither of those nor the port."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from conftest import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "detikzify_tpu"}


def _loaded(code: str) -> set:
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(ROOT / 'h100bench' / 'tests')!r})
        {textwrap.indent(textwrap.dedent(code), '        ').strip()}
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_no_jax(tmp_path):
    loaded = _loaded(f"""
        from pathlib import Path
        from conftest import add_tiny_cells
        from h100bench import harness
        root = Path({str(tmp_path)!r})
        add_tiny_cells(root)
        harness.run_cell(root, "tiny-sample-int8", 9, 1.0, True,
                         device="cpu", bench=root / "h100bench")
    """)
    assert "detikzify_torch" in loaded      # the system under test ran
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_reference_loads_neither_jax_nor_the_port():
    loaded = _loaded(f"""
        import json
        from h100bench import check, traffic
        cfg = json.load(open({str(ROOT / 'h100bench/tests/tiny/tiny-int8.json')!r}))
        fig = traffic.figures(1, 3, 48)[0]
        seq = {{"figure": fig, "token_ids": [511] * 3 + [509, 7, 300],
               "prompt_len": 4}}
        mix = json.load(open({str(ROOT / 'h100bench/tests/tiny/tiny-sample.json')!r}))
        ev = {{"sequences": [seq], "sampled": [seq]}}
        out = check.compare(cfg, mix, 9, ev, "cpu", control=True)
        assert out["token_gap"] is not None and out["nucleus_miss"] is not None
    """)
    assert not loaded & (JAX_SIDE | {"detikzify_torch"}), \
        loaded & (JAX_SIDE | {"detikzify_torch"})
