#!/usr/bin/env python
"""Load-test the HTTP serving front end (``detikzify_torch/serve.py``;
counterpart of ``examples/serve_bench.py``).

Spins up the server in-process around a DS-1.3b-shaped engine
(zero-initialized weights -- decode throughput is weight-value-
independent) and fires concurrent one-shot clients that share a sampling
key, so the scheduler fuses them into continuous-batched engine waves;
one extra client exercises the SSE streaming path concurrently. Reports
end-to-end requests/min, aggregate decode tok/s, and the fused fraction
straight from ``/metrics``.

The reference has no serving front end to compare against -- this
measures the serving layer's overhead on top of the raw engine (int8 +
fused projections, 16 slots, decode block 128).

Usage::

    python -m detikzify_torch.examples.serve_bench [--requests 48]
        [--clients 16] [--max-new-tokens 160] [--device cuda|cpu]
        [--tiny]                      # --tiny: tiny config (smoke test)
"""
import argparse
import base64
import http.client
import io
import json
import threading
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=48)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--max-new-tokens", type=int, default=160)
    p.add_argument("--tiny", action="store_true",
                   help="tiny config (smoke test, not a benchmark); with "
                        "--device cpu it needs no card")
    p.add_argument("--device", default="cuda",
                   help="device of the weights and the engine ('cpu' runs "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)

    import torch
    from PIL import Image, ImageDraw

    from detikzify_torch.config import get_config, tiny_test_config
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.infer import DetikzifyPipeline, FakeBackend, \
        set_backend
    from detikzify_torch.models import convert
    from detikzify_torch.models.detikzify import Params
    from detikzify_torch.ops.sampling import SamplingParams
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.serve import make_server

    set_backend(FakeBackend())
    device = torch.device(args.device)
    if args.tiny:
        cfg = tiny_test_config(vocab_size=512).replace(model_max_length=96)
        params = convert.init_random(cfg, device=device,
                                     dtype=torch.float32)
        engine_kw = dict(num_slots=4, max_len=96)
    else:
        from detikzify_torch.ops.quant import (fuse_projections,
                                               quantize_params)

        cfg = get_config("detikzify-ds-1.3b").replace(model_max_length=640)
        params = Params(cfg, device=device, dtype=torch.bfloat16)
        with torch.no_grad():
            for t in params.parameters():
                t.zero_()
        # int8 serving tree + fused qkv/gate-up, the engine shape whose
        # throughput the serving layer adds to
        params = fuse_projections(quantize_params(params))
        engine_kw = dict(num_slots=16, max_len=640, decode_block=128)
    tok = ByteTokenizer(vocab_size=cfg.text.vocab_size,
                        image_token_id=cfg.image_token_id,
                        bos_token_id=cfg.bos_token_id,
                        eos_token_id=cfg.eos_token_id,
                        pad_token_id=cfg.pad_token_id,
                        model_max_length=cfg.model_max_length)
    engine = DecodeEngine(params, cfg, sampling=SamplingParams(
        temperature=0.8, top_p=0.95, top_k=0), device=device, **engine_kw)
    pipe = DetikzifyPipeline(params, cfg, DetikzifyProcessor(tok, cfg),
                             engine=engine, metric="fast", device=device)
    httpd, inference = make_server(pipe, "127.0.0.1", 0,
                                   batch_window_s=0.05, max_pending=256)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    img = Image.new("RGB", (420, 420), "white")
    ImageDraw.Draw(img).rectangle([40, 40, 380, 380], outline="black",
                                  width=3)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    payload = json.dumps({"image": b64, "temperature": 0.8,
                          "max_new_tokens": args.max_new_tokens}).encode()

    def post(path="/v1/generate", body=payload):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    # warm the compiled programs (start + decode shapes) off the clock
    status, _ = post()
    assert status == 200, status
    print(f"warmup ok; {args.requests} requests from {args.clients} "
          f"clients, max_new_tokens={args.max_new_tokens}", flush=True)

    base = inference.metrics()
    errors, lock = [], threading.Lock()
    todo = list(range(args.requests))
    lat_idle = []           # client-side sampling latencies, idle server

    def client(lat=lat_idle):
        while True:
            with lock:
                if not todo:
                    return
                todo.pop()
            t_req = time.perf_counter()
            status, data = post()
            with lock:
                lat.append(time.perf_counter() - t_req)
            if status != 200:
                with lock:
                    errors.append((status, data[:200]))

    def stream_client():
        # one SSE consumer alongside the batch: must not stall the waves
        status, data = post("/v1/stream")
        if status != 200 or b"event: result" not in data:
            with lock:
                errors.append(("stream", data[:200]))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client)
               for _ in range(args.clients)] + \
              [threading.Thread(target=stream_client)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    m = inference.metrics()
    served = (m["requests"]["sample"] - base["requests"]["sample"])
    batched = (m["requests"]["batched"] - base["requests"]["batched"])
    toks = (m["engine"]["decode_tokens"] - base["engine"]["decode_tokens"])
    assert not errors, errors[:3]
    assert served == args.requests + 1, (served, args.requests)

    def pct(xs, q):
        s = sorted(xs)
        return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]

    result = {
        "requests": served,
        "wall_s": round(wall, 2),
        "requests_per_min": round(60 * served / wall, 1),
        "decode_tok_s": round(toks / wall, 1),
        "fused_fraction": round(batched / served, 3),
        "sample_p50_s": round(pct(lat_idle, 0.5), 3),
        "sample_p95_s": round(pct(lat_idle, 0.95), 3),
        "failed": m["requests"]["failed"] - base["requests"]["failed"],
    }

    # --- mixed workload: one MCTS search monopolizing its slot share
    # while sampling clients keep arriving. Sampling latency must stay
    # near its idle value (no head-of-line blocking: the search's on_tick
    # hook interleaves the waves into reserved slots).
    mcts_budget = 12 if args.tiny else 45
    mcts_payload = json.dumps({
        "image": b64, "algorithm": "mcts", "timeout": mcts_budget,
        "temperature": 0.8}).encode()
    mcts_out = {}

    def mcts_client():
        t_req = time.perf_counter()
        status, data = post(body=mcts_payload)
        mcts_out.update(
            status=status, wall=time.perf_counter() - t_req,
            candidates=len(json.loads(data).get("candidates", []))
            if status == 200 else 0)

    mt = threading.Thread(target=mcts_client)
    mt.start()
    while inference.metrics()["active_mcts"] == 0 and mt.is_alive():
        time.sleep(0.02)
    lat_mixed = []
    todo.extend(range(max(4, args.requests // 2)))
    mixed_clients = [
        threading.Thread(target=client, args=(lat_mixed,))
        for _ in range(max(2, args.clients // 4))]
    t0 = time.perf_counter()
    for t in mixed_clients:
        t.start()
    for t in mixed_clients:
        t.join()
    mixed_wall = time.perf_counter() - t0
    mt.join()
    assert not errors, errors[:3]
    assert mcts_out["status"] == 200, mcts_out
    result.update({
        "mixed_requests": len(lat_mixed),
        "mixed_wall_s": round(mixed_wall, 2),
        "mixed_sample_p50_s": round(pct(lat_mixed, 0.5), 3),
        "mixed_sample_p95_s": round(pct(lat_mixed, 0.95), 3),
        "mixed_vs_idle_p95": round(pct(lat_mixed, 0.95)
                                   / max(pct(lat_idle, 0.95), 1e-9), 2),
        "mcts_budget_s": mcts_budget,
        "mcts_candidates_during_mix": mcts_out["candidates"],
        "server_latency_s": inference.metrics()["latency_s"],
    })
    print(json.dumps(result))
    inference.stop()
    httpd.shutdown()
    pipe.close()


if __name__ == "__main__":
    main()
