#!/usr/bin/env python3
"""Benchmark of the PyTorch port: full-size DCAE real-codec throughput on
Kodak-size images, on one NVIDIA GPU (bench.py's protocol on the port).

    python3 bench_torch.py [batch (8)] [rounds (3)]

Headline metric: encode + decode images per second on 768x512 (Kodak
size) with the flagship config (N=192, M=320, 119M parameters, bf16
transforms, f32 entropy side), real rANS bitstreams. Baseline: the
reference paper's GPU latency of 193 ms enc + dec a Kodak image (5.18
img/s; BASELINE.md "Latency / complexity").

Protocol (bench.py's): self_check certifies the one-fetch encoder, one
pair at batch 1 and one at the batch warm up, and every measured part is
host wall time ending in a device synchronize (the host rANS runs inside
compress and decompress). The headline is the MEDIAN serving round over
the time budget, of the better of the two serving loops (classic
encdec_pipeline, interleaved encdec_pipeline_interleaved, raced in turns);
best-of is kept in detail. A serving round of the interleaved loop in which
any batch fell back to the classic codec (rans.EscapeError) or failed its
lanes checksum is left out of the interleaved median and counted in
detail.interleaved_profile. A failed checksum sets interleaved_profile.ok
false and ends the interleaved loop's turns. The interleaved median is the
headline only while the profile is ok and its median holds at least half
as many rounds as the classic one.

Environment:
  DCAE_BENCH_TOTAL_S       hard cap in seconds (SIGALRM), default 1500
  DCAE_BENCH_CONFIG        full (default) or tiny
  DCAE_BENCH_DTYPE         transforms' dtype, default bfloat16
  DCAE_BENCH_BUDGET_S      serving rounds go on until this many seconds
                           have passed; default 150 when rounds > 1, else 0
  DCAE_BENCH_PIPE_BATCHES  batches a serving round, default 6
  DCAE_BENCH_CKPT          a checkpoint of the port (utils/checkpoint.py);
                           unset: the first of auto_ckpts() that exists
                           (full config only): checkpoint_latest.ckpt or
                           checkpoint_best.ckpt in $TMPDIR/dcae_bench_ckpt
                           (/tmp without TMPDIR), which
                           `python -m dcae_tpu_torch.tools.validate_training
                           --full --save_path $TMPDIR/dcae_bench_ckpt`
                           writes;
                           empty: seeded weights. A checkpoint named here
                           that does not load is an error.
  DCAE_BENCH_DEVICE        the device (default CUDA; `cpu` for tests). No
                           card and no such request: an error line, exit 1.

Output: a JSON line at each milestone, each after a `launches {...}` line
(the hand kernels' launch counters by measured part, reset after the
warm-up). SIGTERM, SIGINT and SIGALRM print the best result so far and exit
0. The LAST line on stdout is the result.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

METRIC = "kodak768x512_encdec_images_per_sec"
BASELINE_IMG_PER_SEC = 1000.0 / 193.0   # the reference's enc + dec
CORPUS = "structured-v2"                # data/synthetic.py::synthetic_kodak
SEEDED = "random (seed 0)"


def auto_ckpts() -> tuple:
    """Where an unset DCAE_BENCH_CKPT looks, in order: the run's own
    temporary directory (TMPDIR), so that no other checkout's checkpoint
    is picked up."""
    d = os.path.join(tempfile.gettempdir(), "dcae_bench_ckpt")
    return tuple(os.path.join(d, f"checkpoint_{w}.ckpt")
                 for w in ("latest", "best"))


def new_result() -> dict:
    """The JSON line before any measurement: value 0 and an error."""
    return {"metric": METRIC, "value": 0.0, "unit": "img/s",
            "vs_baseline": 0.0,
            "detail": {"error": "bench did not reach a measurement"}}


def emit(result: dict) -> None:
    """Print the result so far as one JSON line (the last line wins)."""
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()


def set_value(result: dict, img_per_sec: float) -> None:
    result["value"] = round(img_per_sec, 4)
    result["vs_baseline"] = round(result["value"] / BASELINE_IMG_PER_SEC, 4)
    result["detail"].pop("error", None)


def install_capture_guards(result: dict, total_s: float) -> None:
    """SIGTERM, SIGINT and SIGALRM print `result` as it stands and exit 0;
    SIGALRM fires after total_s seconds (none when total_s <= 0). A handler
    runs between bytecodes, so one that arrives during a device
    synchronize waits for it."""
    def handler(signum, frame):
        result["detail"]["terminated_by_signal"] = signum
        # os.write: the handler may interrupt a buffered print
        os.write(sys.stdout.fileno(), (json.dumps(result) + "\n").encode())
        os._exit(0)

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM):
        signal.signal(sig, handler)
    if total_s > 0:
        signal.alarm(max(1, int(total_s)))


def device_detail(device) -> str:
    """The device's name; for a card also its power limit (nvidia-smi)."""
    import torch
    from dcae_tpu_torch.utils.profiling import card_line

    if device.type != "cuda":
        return str(device)
    limit = card_line().rsplit(",", 1)[1].strip()
    return f"{torch.cuda.get_device_name(device)}, power limit {limit}"


class Launches:
    """The hand kernels' launch counters (ops/kernels/*.py `.launches`) by
    measured part: take(part) adds the launches since the last take (or
    reset) to the part's and sets the counters to 0."""

    def __init__(self):
        from dcae_tpu_torch.ops.kernels import wrappers

        self.wrappers = wrappers()
        self.parts: dict = {}
        self.reset()

    def reset(self) -> None:
        for w in self.wrappers.values():
            w.launches = 0

    def take(self, part: str) -> None:
        into = self.parts.setdefault(part, dict.fromkeys(self.wrappers, 0))
        for k, w in self.wrappers.items():
            into[k] += w.launches
        self.reset()

    def line(self) -> str:
        total = {k: sum(p[k] for p in self.parts.values())
                 for k in self.wrappers}
        return "launches " + json.dumps({"total": total, **self.parts})


def run(codec, images: np.ndarray, n_rounds: int = 3, budget_s: float = 0.0,
        pipe_batches: int = 6, *, weights: str = SEEDED,
        result: dict | None = None) -> dict:
    """bench.py's measured parts on `codec` (tables baked) and `images`
    (B, H, W, 3) uint8 of the synthetic Kodak corpus: warm-up and
    certification, single-image latency, (a) two sequential batch pairs,
    (b) the interleaved profile, (c) the serving rounds, the interleaved and
    the shipped-index single-image latency. `result` (new_result() when
    None) is updated in place and emitted at each milestone, after the
    launch line. weights: what the codec's weights are, for
    detail.weights. Returns result."""
    from dcae_tpu_torch.entropy.rans import EscapeError
    from dcae_tpu_torch.utils.profiling import force_sync

    result = new_result() if result is None else result
    batch, H, W = images.shape[:3]
    pixels = batch * H * W
    detail = result["detail"]
    detail.update({"weights": weights, "batch": batch,
                   "device": device_detail(codec.device), "corpus": CORPUS})
    launches = Launches()

    def milestone():
        print(launches.line(), flush=True)
        emit(result)

    def pair(x, encode, decode):
        """(encode s, decode s, encoded, decoded) of one synchronized
        pair."""
        t0 = time.perf_counter()
        enc = encode(x)
        t1 = time.perf_counter()
        dec = force_sync(decode(enc))
        return t1 - t0, time.perf_counter() - t1, enc, dec

    def classic(enc):
        return codec.decompress(enc["strings"], enc["shape"])

    # warm-up; self_check switches to the one-fetch encoder when its
    # stream bit-matches the staged (decoder-replay) one
    fused_ok = codec.self_check(images[:1])
    for b in (1, batch):
        pair(images[:b], codec.compress, classic)
    launches.reset()

    enc_s, dec_s, _, _ = pair(images[:1], codec.compress, classic)
    single_ms, single_enc_ms = 1e3 * (enc_s + dec_s), 1e3 * enc_s
    launches.take("single_image")

    # (a) sequential batch pairs: the per-stage split
    best = None
    for _ in range(2):
        enc_s, dec_s, enc, _ = pair(images, codec.compress, classic)
        if best is None or enc_s + dec_s < sum(best):
            best = (enc_s, dec_s)
    total_bytes = sum(len(s) for grp in enc["strings"] for s in grp)
    launches.take("sequential")
    enc_s, dec_s = best
    set_value(result, batch / (enc_s + dec_s))
    detail.update({
        "profile": "sequential(provisional)",
        "encode_ms_per_img": round(1e3 * enc_s / batch, 1),
        "decode_ms_per_img": round(1e3 * dec_s / batch, 1),
        "sequential_img_per_sec": round(batch / (enc_s + dec_s), 4),
        "single_image_ms": round(single_ms, 1),
        "single_image_encode_ms": round(single_enc_ms, 1),
        "bpp": round(total_bytes * 8 / pixels, 4),
        "encode_mode": codec.encode_mode,
        "fast_encoder": fused_ok,
        "pipeline_batches": pipe_batches,
    })
    milestone()

    # (b) the interleaved profile: the y streams coded on the device both
    # ways. Untrained weights may put more out-of-table symbols in a slice
    # than the patch list holds (EscapeError): the profile is then skipped.
    try:
        pair(images, codec.compress_device, codec.decompress_interleaved)
        best_il = None
        for _ in range(3):
            enc_s, dec_s, enc_il, dec_il = pair(
                images, codec.compress_device, codec.decompress_interleaved)
            if best_il is None or enc_s + dec_s < sum(best_il):
                best_il = (enc_s, dec_s)
        il_bytes = (sum(len(s) for s in enc_il["istreams"])
                    + enc_il["states"].nbytes
                    + sum(len(s) for s in enc_il["z_strings"]))
        interleaved = {
            "img_per_sec": round(batch / sum(best_il), 4),
            "encode_ms_per_img": round(1e3 * best_il[0] / batch, 1),
            "decode_ms_per_img": round(1e3 * best_il[1] / batch, 1),
            "ok": bool(dec_il["ok"]),
            "bpp": round(il_bytes * 8 / pixels, 4),
            "lanes": enc_il["lanes"],
        }
    except EscapeError as e:
        print(f"# interleaved profile skipped: {e}", file=sys.stderr)
        interleaved = {"ok": False, "skipped": str(e)}
    launches.take("interleaved")
    detail["interleaved_profile"] = interleaved

    # (c) the serving rounds: each loop codes pipe_batches copies of the
    # batch; the two loops run in turns, a same-window A/B
    stream = [images] * pipe_batches
    n_images = batch * pipe_batches
    pipe_times, pipe_il_times = [], []
    race_il = interleaved["ok"]
    if race_il:
        interleaved.update(classic_batches=0, failed_batches=0,
                           rounds_excluded=0)

    def update_headline():
        med_c = n_images / float(np.median(pipe_times))
        det = {"profile": "classic",
               "pipeline_ms_per_img": round(
                   1e3 * float(np.median(pipe_times)) / n_images, 1),
               "best_img_per_sec": round(n_images / min(pipe_times), 4),
               "rounds": len(pipe_times)}
        ips = med_c
        result["classic_median_img_per_sec"] = round(med_c, 4)
        if pipe_il_times:
            med_il = n_images / float(np.median(pipe_il_times))
            interleaved["pipeline_img_per_sec"] = round(
                n_images / min(pipe_il_times), 4)
            interleaved["pipeline_median_img_per_sec"] = round(med_il, 4)
            interleaved["rounds"] = len(pipe_il_times)
            result["interleaved_classic_ratio"] = round(med_il / med_c, 4)
            if (interleaved["ok"] and 2 * len(pipe_il_times)
                    >= len(pipe_times) and med_il > med_c):
                ips = med_il
                det["profile"] = "interleaved_device_decode"
                det["best_img_per_sec"] = interleaved["pipeline_img_per_sec"]
                det["pipeline_ms_per_img"] = round(
                    1e3 * float(np.median(pipe_il_times)) / n_images, 1)
            det["classic_median_img_per_sec"] = round(med_c, 4)
        set_value(result, ips)
        detail.update(det)

    t_rounds = time.perf_counter()
    r = 0
    while r < n_rounds or time.perf_counter() - t_rounds < budget_s:
        r += 1
        t0 = time.perf_counter()
        outs = codec.encdec_pipeline(stream)
        force_sync([o["x_hat"] for o in outs])
        pipe_times.append(time.perf_counter() - t0)
        launches.take("serving_classic")
        if race_il:
            t0 = time.perf_counter()
            outs = codec.encdec_pipeline_interleaved(stream)
            force_sync([o["x_hat"] for o in outs])
            dt = time.perf_counter() - t0
            launches.take("serving_interleaved")
            n_classic = sum(o["profile"] == "classic" for o in outs)
            n_failed = sum(not bool(o["ok"]) for o in outs)
            interleaved["classic_batches"] += n_classic
            interleaved["failed_batches"] += n_failed
            if n_failed:
                interleaved["ok"] = race_il = False
            if n_classic or n_failed:
                interleaved["rounds_excluded"] += 1
            else:
                pipe_il_times.append(dt)
        update_headline()
        if r == 1:
            milestone()

    # single-image latency of the interleaved profile
    if interleaved["ok"]:
        try:
            pair(images[:1], codec.compress_device,
                 codec.decompress_interleaved)
            enc_s, dec_s, _, _ = pair(images[:1], codec.compress_device,
                                      codec.decompress_interleaved)
            interleaved["single_image_ms"] = round(1e3 * (enc_s + dec_s), 1)
            interleaved["single_image_encode_ms"] = round(1e3 * enc_s, 1)
        except EscapeError as e:
            print(f"# interleaved single-image metric skipped: {e}",
                  file=sys.stderr)
        launches.take("interleaved_single_image")

    # single-image latency with the indexes shipped: the host decodes every
    # slice first, then one decode_all call
    def shipped(enc):
        return codec.decompress(enc["strings"], enc["shape"],
                                indexes=enc["indexes"])

    pair(images[:1], codec.compress_with_indexes, shipped)
    enc_s, dec_s, _, _ = pair(images[:1], codec.compress_with_indexes,
                              shipped)
    launches.take("indexes_1trip")
    detail["single_image_decode_1trip_ms"] = round(1e3 * dec_s, 1)
    detail["single_image_1trip_ms"] = round(1e3 * (enc_s + dec_s), 1)

    # the headline single-image latency: the best of the three profiles
    candidates = {"classic": single_ms,
                  "indexes_1trip": 1e3 * (enc_s + dec_s)}
    if interleaved.get("single_image_ms"):
        candidates["interleaved"] = interleaved["single_image_ms"]
    prof = min(candidates, key=candidates.get)
    detail["single_image_ms"] = round(candidates[prof], 1)
    detail["single_image_profile"] = prof
    detail["single_image_classic_ms"] = round(single_ms, 1)

    update_headline()
    milestone()
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    result = new_result()
    install_capture_guards(result,
                           float(os.environ.get("DCAE_BENCH_TOTAL_S", "1500")))

    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.data.synthetic import synthetic_kodak
    from dcae_tpu_torch.models.codec import DCAECodec, resolve_device
    from dcae_tpu_torch.utils.checkpoint import load_params_only

    try:
        device = resolve_device(os.environ.get("DCAE_BENCH_DEVICE"))
    except RuntimeError as e:
        result["detail"]["error"] = f"{e} (DCAE_BENCH_DEVICE=cpu runs on " \
                                    "the CPU)"
        emit(result)
        return 1
    batch = int(argv[0]) if len(argv) > 0 else 8
    n_rounds = int(argv[1]) if len(argv) > 1 else 3
    budget_s = float(os.environ.get(
        "DCAE_BENCH_BUDGET_S", "150" if n_rounds > 1 else "0"))
    pipe_batches = int(os.environ.get("DCAE_BENCH_PIPE_BATCHES", "6"))
    dtype = os.environ.get("DCAE_BENCH_DTYPE", "bfloat16")
    full = os.environ.get("DCAE_BENCH_CONFIG", "full") != "tiny"
    cfg = (DCAEConfig(compute_dtype=dtype) if full
           else DCAEConfig.tiny(compute_dtype=dtype))

    if device.type == "cuda":
        # every kernel at once (one nvcc a source), not one by one at its
        # first launch in the warm-up
        from dcae_tpu_torch.ops.kernels import _build

        t0 = time.perf_counter()
        _build.build_kernels()
        print(f"# kernels built in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    ckpt = os.environ.get("DCAE_BENCH_CKPT")
    named = ckpt is not None
    if not named and full:
        ckpt = next((p for p in auto_ckpts() if os.path.exists(p)), None)
    codec, weights = None, SEEDED
    if ckpt:
        try:
            codec = DCAECodec(cfg, params=load_params_only(ckpt),
                              device=device)
            weights = f"trained ({ckpt})"
        except Exception as e:   # any unreadable or mismatched file
            if named:
                result["detail"]["error"] = (f"DCAE_BENCH_CKPT={ckpt} did "
                                             f"not load: {e!r}")
                emit(result)
                return 1
            result["detail"]["checkpoint_load_failed"] = f"{ckpt}: {e!r}"
            print(f"# checkpoint {ckpt} did not load, using seeded "
                  f"weights: {e!r}", file=sys.stderr)
    if codec is None:
        codec = DCAECodec(cfg, seed=0, device=device)
    try:
        codec.update(force=True)
        run(codec, synthetic_kodak(batch), n_rounds, budget_s, pipe_batches,
            weights=weights, result=result)
    finally:
        codec.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
