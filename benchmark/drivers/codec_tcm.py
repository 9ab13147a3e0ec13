"""Closed-loop codec traffic on TCM: drivers/codec_closed.py's loop as it
is (compress_device then decompress_interleaved, the classic fallback
counted, the quantities, the sample, the traced sub-window, the
harness's "encode" / "decode" spans), with TCM in the DCAE's three
places: the program's TCMConfig of the configuration file, its weights
drawn from the seed (harness/tcm_weights.py) and the plain TCM
reference in the judge (reference/tcm_check.py).

A traced run also registers a sink of the program's own spans
(utils/profiling.py): their host seconds in the untraced part of the
window go into the tracer's record beside the harness's spans
(`tcm.mix`, `tcm.swatten`, the codec driver's), where the readers of
the pre-window spans find them. An untraced run registers none.

The program's TCMConfig is imported by codec_closed's first step, so a
program without TCM stops at once on this cell.

Traffic file keys: codec_closed's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types
from unittest import mock

from drivers import codec_closed
from harness import core, tcm_weights, trace
from reference import tcm_check


def model_config(config: dict):
    """The program's TCMConfig of a configuration file's "model" dict."""
    from dcae_tpu_torch.config import TCMConfig

    fields = {f.name for f in dataclasses.fields(TCMConfig)}
    return TCMConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in config["model"].items() if k in fields})


def run(ctx: core.Context, device: str = "cuda") -> core.Result:
    from dcae_tpu_torch.utils import profiling

    tracers = []

    class Tracer(trace.Tracer):
        """The harness's tracer, told the program's spans too once the
        window has opened."""

        def __init__(self, *args):
            super().__init__(*args)
            self.opened = False
            tracers.append(self)

        def begin(self) -> None:
            super().begin()
            self.opened = True

        def program_span(self, name: str, start: float, end: float):
            if self.opened and not self.active and self.result is None:
                self.pre["spans"][name] += end - start

    class Sink(profiling.Sink):
        def span(self, name, start, end):
            for t in tracers:
                t.program_span(name, start, end)

    with contextlib.ExitStack() as stack:
        for name, stand_in in (
                ("program", types.SimpleNamespace(model_config=model_config)),
                ("weights", types.SimpleNamespace(make=tcm_weights.make)),
                ("codec_check", types.SimpleNamespace(judge=tcm_check.judge)),
                ("trace", types.SimpleNamespace(Tracer=Tracer))):
            stack.enter_context(mock.patch.object(codec_closed, name,
                                                  stand_in))
        if ctx.trace:
            stack.enter_context(profiling.registered(Sink()))
        return codec_closed.run(ctx, device)
