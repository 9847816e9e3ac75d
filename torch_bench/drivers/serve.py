"""Serving: the port's HTTP service in this process, open-loop load from
another (torch_bench/loadgen.py).

Set-up: the seeded weights as a checkpoint that ``InpaintService`` loads,
its bucket warm-up, ``make_server`` on a free local port, the payload
tiles PNG-encoded into request bodies, the load generator started and
warmed. Window: from ``go`` until the generator has every answer (or
has waited a minute past the last due time). Check: the sampled
answers, decoded by the benchmark's codec, against the reference's
composite in the service's output contract.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from torch_bench import codec, traffic
from torch_bench.reference.steps import eval_forward, precision
from torch_bench.weights import seeded_state

HERE = Path(__file__).resolve().parents[1]


def break_path(service, fault: str) -> None:
    forward = service._forward
    if fault == "answer":  # every answer altered where it is produced
        def altered(xm):
            out = forward(xm).clone()
            out[0] ^= 1
            return out
        service._forward = altered
    elif fault == "half_batch":  # half of each batch computed, the rest copies
        def halved(xm):
            h = max(1, xm.shape[0] // 2)
            out = forward(xm[:h])
            return torch.cat([out, out[:1].expand(xm.shape[0] - h, *out.shape[1:])])
        service._forward = halved
    else:
        raise ValueError(f"no fault {fault!r} in this driver")


def traced(run, label, fn):
    def call(*args):
        with run.span(label):
            return fn(*args)
    return call


def batcher_counts(service):
    with service.batcher._lock:
        return service.batcher.stats["batches"], service.batcher.stats["batch_size_sum"]


def run(run) -> None:
    from terra_gan_tpu_torch.serving.server import InpaintService, make_server

    cfg, mix, dev = run.config, run.traffic, run.device
    side, width = cfg["image_size"], cfg["base_width"]
    with tempfile.TemporaryDirectory(prefix="torch_bench_serve_") as tmp:
        tmp = Path(tmp)
        state = seeded_state("generator", width, run.seed, dev)
        torch.save({k: v.cpu() for k, v in state.items()}, tmp / "generator.pth")
        service = InpaintService(checkpoint=str(tmp / "generator.pth"), size=side,
                                 out_size=mix["out_size"], max_batch=mix["max_batch"],
                                 base_width=width, device=dev)
        if run.control:
            from torch_bench.drivers.control import reference_program
            service.generator = reference_program(state, run.control)
        del state
        if run.fault:
            break_path(service, run.fault)
        service.warmup()
        if run.tracing:
            service.decode_pair = traced(run, "decode", service.decode_pair)
            service.encode_output = traced(run, "encode", service.encode_output)
            service.batcher.infer_fn = traced(run, "forward", service.batcher.infer_fn)
        server = make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        images, masks = traffic.tile_set(mix, mix["payloads"], side, run.seed, dev)
        bodies = tmp / "bodies.jsonl"
        bodies.write_bytes(b"\n".join(codec.inpaint_body(i, m) for i, m in zip(images, masks)))
        cmd = [sys.executable, str(HERE / "loadgen.py"),
               "--url", f"http://127.0.0.1:{server.server_address[1]}",
               "--bodies", str(bodies), "--rate", str(mix["rate"]),
               "--seconds", str(run.seconds), "--seed", str(run.seed),
               "--samples", str(tmp / "samples.npz"),
               "--sample-share", str(mix["sample_share"]), "--sample-max", str(mix["sample_max"])]
        gen = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            if gen.stdout.readline().strip() != "ready":
                raise RuntimeError("the load generator did not come up")
            counts0 = batcher_counts(service)
            with run.window():
                gen.stdin.write("go\n")
                gen.stdin.flush()
                result = json.loads(gen.stdout.readline())
            counts1 = batcher_counts(service)
        finally:
            gen.stdin.close()
            try:
                gen.wait(timeout=120)
            except subprocess.TimeoutExpired:
                gen.kill()
                gen.wait()
            server.shutdown()
            server.server_close()
            thread.join()
        samples = dict(np.load(tmp / "samples.npz"))

    lat = np.array([np.inf if v is None else v for v in result["latency_ms"]])
    run.counts.update(latency_ms=lat, batches=counts1[0] - counts0[0],
                      batched=counts1[1] - counts0[1])
    run.attempted, run.failed = result["sent"], result["failed"]
    for key in ("sent", "ok", "failed", "offered_per_s", "completed_per_s", "lateness_ms_p95",
                "lateness_ms_max", "latency_slope_ms_per_s", "first_third_p50_ms", "last_third_p50_ms", "sampled"):
        run.info(f"loadgen.{key}", result[key])
    del service, server
    run.free()

    diff = total = 0
    state = seeded_state("generator", width, run.seed, dev)
    with precision("fp32", dev):
        for idx, p, answer in zip(samples["index"], samples["payload"], samples["answer"]):
            want, _ = eval_forward(state, torch.from_numpy(images[p : p + 1]).to(dev),
                                   torch.from_numpy(masks[p : p + 1]).to(dev))
            want = codec.output_contract(want[0].cpu().numpy(), mix["out_size"])
            diff += int((answer != want).sum()) if answer.shape == want.shape else want.size
            total += want.size
    run.check("u8_mismatch", diff / total if total else float("inf"), run.limits["u8_mismatch"])
