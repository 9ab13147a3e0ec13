"""Closed-loop training traffic: make_train_step steps, each on a batch of
`batch` random crops of `crop` x `crop` cut on the host, that step, from a
pool of `pool` synthetic `pool_size`^2 images drawn from the seed, and
uploaded through pinned memory. With `world` > 1 the step is
shard_train_step over a data-parallel mesh of `world` processes, one card
each (NCCL; gloo on the CPU): this process is rank 0 and starts the others
(this file run as a script), `batch` is each rank's share of the global
batch, and rank 0 decides when the window closes, telling the others
over a gloo group before each step.

Set-up builds the one train state (the model on the device, both Adams,
the noise generator) and drives it through its first four steps by the
window's own feed and call; the first three are the ones the
judge (reference/train_check.py) follows. The window then steps until
`--seconds` have passed and waits for the device. Quantity: img_per_s
(images of the steps completed over the whole window). A traced run
profiles `trace_seconds` from `trace_skip_s` on.

Traffic file keys: batch, crop, pool, pool_size, world, trace_skip_s,
trace_seconds, work (the yardstick's statement of a step's model work); "report" maps end-to-end metric names to
the quantities.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)),
                    os.path.dirname(HERE)]

from harness import core, corpus, program, trace, weights  # noqa: E402
from reference import train_check  # noqa: E402

# the set-up's steps: the judge follows the first three, the fourth shows
# that nothing is left to build or warm before the window
SETUP_STEPS = 4
# a rank's exit code when it loaded a module that the run may not load
FORBIDDEN_RC = 3


def run(ctx: core.Context, device: str = "cuda") -> core.Result:
    """Rank 0 of the run, and the other ranks started and waited for."""
    world = int(ctx.cell.traffic.get("world", 1))
    if world == 1:
        return run_rank(ctx, device, 0, 1, 0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), ctx.cell.name,
         str(ctx.seed), str(ctx.seconds), device, str(r), str(world),
         str(port), ctx.bench_json])
        for r in range(1, world)]
    try:
        res = run_rank(ctx, device, 0, world, port)
    finally:
        for p in procs:
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        res.failed += 1
        res.notes.append(f"ranks' exit codes {codes}")
    res.forbidden += [f"rank {r}'s (its error names them)" for r, rc in enumerate(codes, 1)
                      if rc == FORBIDDEN_RC]
    return res


def thirds(stamps, t0: float, window: float):
    """How many of the host's time stamps fall in each third of the
    window: a drift within the run shows here."""
    return [sum(t0 + k * window / 3 <= t < t0 + (k + 1) * window / 3
                for t in stamps) for k in range(3)]


def crops_of(pool, rng, n: int, crop: int):
    """n random crop x crop crops of the pool's images."""
    size = pool[0].shape[0]
    which = rng.integers(0, len(pool), n)
    at = rng.integers(0, size - crop + 1, (n, 2))
    return np.stack([pool[i][y:y + crop, x:x + crop]
                     for i, (y, x) in zip(which, at)])


def run_rank(ctx: core.Context, device: str, rank: int, world: int,
             port: int):
    """One rank's run; rank 0 returns the Result, the others None."""
    import torch.distributed as dist

    from dcae_tpu_torch.models.dcae import DCAE
    from dcae_tpu_torch.train.state import (create_train_state,
                                            make_optimizer)
    from dcae_tpu_torch.train.step import make_train_step

    cell, tf = ctx.cell, ctx.cell.traffic
    rec = cell.config["recipe"]
    cfg = program.model_config(cell.config)
    c = dataclasses.asdict(cfg)
    B, crop = int(tf["batch"]), int(tf["crop"])
    n_pool, size = int(tf["pool"]), int(tf["pool_size"])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    notes = []
    flags = None
    if world > 1:
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        flags = dist.new_group(backend="gloo")
    # the configuration's precision: f32 with TF32 off, as the trainer sets
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with ThreadPoolExecutor(max_workers=6) as ex:
        pool = list(ex.map(
            lambda i: corpus.synth_image(
                np.random.default_rng(ctx.subseed(1, i)), size),
            range(n_pool)))
    crops = np.random.default_rng(ctx.subseed(4, rank))

    def feed():
        """One batch: (host array, device tensor)."""
        host = crops_of(pool, crops, B, crop)
        t = torch.from_numpy(host)
        if cuda:
            t = t.pin_memory().to(device, non_blocking=True)
        return host, t

    state_dict = weights.make(c, ctx.subseed(2), device)
    with torch.device(device):
        model = DCAE(cfg)
    model.load_state_dict(state_dict, strict=True)
    del state_dict
    tx = make_optimizer(rec["learning_rate"], rec["aux_learning_rate"],
                        rec["clip_max_norm"])
    noise_seed = ctx.subseed(5)
    st = create_train_state(
        model, tx, torch.Generator(device=device).manual_seed(noise_seed))
    step = make_train_step(model, tx, rec["lmbda"], rec["metric"])
    if world > 1:
        from dcae_tpu_torch.parallel.mesh import make_mesh, shard_train_step
        step = shard_train_step(step, make_mesh(sp=1))
    names = {id(p): n for n, p in model.named_parameters()}
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    tracer = trace.Tracer(ctx.trace and rank == 0,
                          float(tf.get("trace_skip_s", 2.0)),
                          float(tf.get("trace_seconds", 3.0)))

    def one_step():
        with tracer.span("feed"):
            host, xb = feed()
        with tracer.span("step"):
            _, met = step(st, xb)
        return host, met["loss"] + met["aux_loss"]

    # set-up: the state's first steps, through the window's feed and call
    prog = {"loss": [], "grad": {}, "change": {}}
    first = []
    for i in range(SETUP_STEPS):
        host, loss = one_step()
        if i < 3:
            first.append(host)
            prog["loss"].append(loss)
        if i == 0:
            b1 = st.main_opt.param_groups[0]["betas"][0]
            for opt in filter(None, (st.main_opt, st.aux_opt)):
                for grp in opt.param_groups:
                    for p in grp["params"]:
                        m = opt.state.get(p, {}).get("exp_avg")
                        prog["grad"][names[id(p)]] = (
                            torch.linalg.vector_norm(m / (1 - b1))
                            if m is not None else float("nan"))
        if i == 2:
            with torch.no_grad():
                prog["change"] = {n: torch.linalg.vector_norm(p - p0[n])
                                  for n, p in model.named_parameters()}
            del p0
    sync()
    prog = {"loss": [float(v) for v in prog["loss"]],
            "grad": {k: float(v) for k, v in prog["grad"].items()},
            "change": {k: float(v) for k, v in prog["change"].items()}}
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    losses = []
    n_steps = 0
    tracer.begin()
    t_start = time.perf_counter()
    ctx.mark_first_call(t_start)
    deadline = t_start + ctx.seconds
    go = torch.ones(1, dtype=torch.int32)
    stamps = []                   # host time after each step was sent
    while True:
        if rank == 0:
            go[0] = int(time.perf_counter() < deadline)
        if flags is not None:
            dist.broadcast(go, 0, group=flags)
        if not go[0]:
            break
        tracer.tick(t_start, sync)
        _, loss = one_step()
        losses.append(loss)
        n_steps += 1
        stamps.append(time.perf_counter())
        tracer.count(B * world)
    sync()
    t_end = time.perf_counter()
    tracer.stop(sync)
    if ctx.trace and rank == 0:
        notes.append(tracer.overhead_note())
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    peaks = [(window_peak, setup_peak, bad)]
    if world > 1:
        peaks = [None] * world
        dist.all_gather_object(peaks, (window_peak, setup_peak, bad),
                               group=flags)
        dist.destroy_process_group()
    if rank:
        return None
    bad = sum(p[2] for p in peaks)
    window = t_end - t_start
    q = {"img_per_s": (n_steps - bad) * B * world / window}
    notes.append(f"window {window:.3f} s, {n_steps} steps of {world} x {B} "
                 f"crops, {bad} non-finite; set-up losses {prog['loss']}; "
                 f"steps sent a third of the window "
                 f"{thirds(stamps, t_start, window)}")

    del st, step, model, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the first three global batches: every rank's crops, in rank order
    others = [np.random.default_rng(ctx.subseed(4, r)) for r in
              range(1, world)]
    first = [np.concatenate([f] + [crops_of(pool, g, B, crop)
                                   for g in others])
             for f in first]
    t_j = time.perf_counter()
    refd = train_check.steps(c, rec, weights.make(c, ctx.subseed(2), device),
                             first, noise_seed, device, chunk=B)
    got = train_check.compare(prog, refd)
    limits = cell.limits["checks"]
    checks = [(n, got[n], float(limits[n])) for n in limits]
    notes.append(f"reference losses {refd['loss']}; judged in "
                 f"{time.perf_counter() - t_j:.3f} s; worst leaves "
                 f"{got['worst']}")
    return core.Result(
        attempted=n_steps, failed=bad, quantities=q, checks=checks,
        memory_peak_bytes=max(max(p[:2]) for p in peaks),
        device_count=world, notes=notes, judged=True, trace=tracer.result,
        counts={"images": tracer.images, "requests": tracer.requests,
                "batch": B, "height": crop, "width": crop,
                "window_peak_bytes": window_peak})


def main(argv) -> None:
    """A rank other than 0: workload seed seconds device rank world port
    bench_json. A run of the fault variants names its variant in
    BENCH_PATCH, and every rank carries the same patches. Once the window
    has closed the rank looks for forbidden modules in its own process
    and exits with FORBIDDEN_RC when it finds one."""
    import contextlib

    cell_name, seed, seconds, device, rank, world, port, bench = argv
    cell = core.load_cell(bench, cell_name)
    ctx = core.Context(cell, int(seed), float(seconds), False, device,
                       time.perf_counter(), bench_json=bench)
    with contextlib.ExitStack() as stack:
        variant = os.environ.get("BENCH_PATCH")
        if variant:
            v = core.load_module(os.path.join(cell.root, "tests",
                                              "variants.py"), "variants")
            for p in v.train_patches(variant, int(rank)):
                stack.enter_context(p)
        run_rank(ctx, device, int(rank), int(world), int(port))
    bad = core.forbidden_modules()
    if bad:
        print(f"error: rank {rank} loaded modules that the run may not "
              f"load: {bad}", file=sys.stderr)
        sys.exit(FORBIDDEN_RC)


if __name__ == "__main__":
    main(sys.argv[1:])

