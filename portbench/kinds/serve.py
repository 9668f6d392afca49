"""Single tiles served one request at a time, open loop.

The program under test: ``InferenceSession(model, batch_size=1)`` on the
graph that ``optimize="auto"`` picks at B=1 (the module's forward with the
decoder's fused blocks, captured as a CUDA graph at construction), each
request a ``[1, 192, 192, 13]`` float32 numpy tile through ``predict``
(upload, replay, download). Requests are due at open-loop arrivals of the
traffic file's fixed ``rate`` (``traffic.arrivals``); the generator and the
server are one loop, so a request is served at its due time or, when the
previous one ran late, as soon as it finished. A request's latency runs
from its due time to its restored tile on the host; ``serve_p95_ms`` is
the 95th percentile over all requests due in the window.

The traced run first serves ``traced_requests`` unprofiled, timing each
``predict`` on the host and each replay with CUDA events (the profiler's
cost on the host would inflate the first), then the same count under the
profiler for the device's busy time and the breakdown.

The check: ``sample`` requests, drawn from the seed, are restored again by
the plain reference in float32; the number compared is the worst
request's relative RMS gap.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traffic as gen
from portbench.kinds import DTYPES, program_model, rel_rms
from portbench.reference.precision import exact_fp32, fp8_operands
from portbench.weights import reference_model, seeded_state


class _TimedGraph:
    """A captured graph whose every replay is bracketed by CUDA events."""

    def __init__(self, graph):
        self.graph, self.pairs = graph, []

    def replay(self):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        self.graph.replay()
        end.record()
        self.pairs.append((start, end))


class Driver:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        from msid_tpu_torch.deployment.inference import InferenceSession

        self.cell, self.seed, self.device = cell, seed, device
        self.config = cell["config"]["config"]
        t = self.traffic = cell["traffic"]
        self.pool = gen.tiles(t, seed, device)
        model = program_model(cell["config"], seeded_state(self.config, seed, device), device,
                              DTYPES[cell["config"]["dtype"]])
        self.session = InferenceSession(model, batch_size=1, image_size=int(t["tile_size"]),
                                        num_bands=int(t["bands"]), device=device)
        del model
        self.rng = np.random.default_rng([int(seed), 5])
        self.attempted = self.failed = 0
        self.kept = {}                  # request index -> (pool index, output)
        self.extra = {}
        self.late_s = []
        for i in range(int(t["warmup"])):
            self.session.predict(self.pool[i % len(self.pool)])

    def serve(self, rate: float, seconds: float) -> list:
        """Serve the arrivals of ``seconds`` at ``rate``; the latencies (s)."""
        dues = gen.arrivals(rate, seconds, self.seed)
        picks = self.rng.integers(len(self.pool), size=len(dues))
        sample = set(self.rng.choice(len(dues), size=min(int(self.traffic["sample"]), len(dues)),
                                     replace=False).tolist())
        latencies, walls = [], []
        start = time.perf_counter()
        for i, due in enumerate(dues):
            while (now := time.perf_counter() - start) < due:
                if due - now > 2e-3:
                    time.sleep(due - now - 1e-3)
            self.late_s.append(now - due)
            out = self.session.predict(self.pool[picks[i]])
            done = time.perf_counter() - start
            latencies.append(done - due)
            walls.append(done - now)
            self.attempted += 1
            if i in sample:
                self.kept[i] = (int(picks[i]), out)
        self.extra["predict_ms"] = [1e3 * w for w in walls]
        return latencies

    def window(self, seconds: float) -> dict:
        latencies = self.serve(float(self.traffic["rate"]), seconds)
        return {"serve_p95_ms": 1e3 * float(np.percentile(latencies, 95))}

    def unprofiled(self) -> None:
        """``traced_requests`` requests at the cell's rate before the
        profiler starts: each ``predict``'s wall time, and each replay's
        device time from CUDA events around it."""
        t = self.traffic
        rate = float(t["rate"])
        graph = self.session.graphs.get(1)          # none on the CPU: no device time
        timed = None
        if graph is not None:
            timed = graph.graph = _TimedGraph(graph.graph)
        try:
            self.serve(rate, int(t["traced_requests"]) / rate)
        finally:
            if timed is not None:
                graph.graph = timed.graph
        if timed is not None:
            torch.cuda.synchronize()
            self.extra["replay_ms"] = [s.elapsed_time(e) for s, e in timed.pairs]

    def traced(self) -> None:
        rate = float(self.traffic["rate"])
        predict_ms = self.extra["predict_ms"]
        self.serve(rate, int(self.traffic["traced_requests"]) / rate)
        self.extra["predict_ms"] = predict_ms

    def notes(self) -> list[str]:
        late = np.asarray(self.late_s) * 1e3
        return [f"serve: {self.attempted} requests at {self.traffic['rate']}/s; the generator "
                f"ran late by median {np.median(late):.3f} ms, p95 {np.percentile(late, 95):.3f} "
                f"ms, max {late.max():.3f} ms"]

    def release(self) -> None:
        self.session = None

    def reference(self, tiles: np.ndarray, operands=None) -> torch.Tensor:
        state = seeded_state(self.config, self.seed, self.device)
        ref = reference_model(self.config, state, self.device).eval()
        if operands is not None:
            ref.operands.fn = operands
        with exact_fp32(), torch.no_grad():
            return ref(torch.from_numpy(tiles).to(self.device)).cpu()

    def control(self) -> dict:
        """The control's number: the reference with fp8 operands in the
        program's place, on the requests the check would compare."""
        tiles = np.concatenate([self.pool[self.kept[i][0]] for i in sorted(self.kept)])
        got, want = self.reference(tiles, fp8_operands), self.reference(tiles)
        return {"worst_request_rel_rms": max(rel_rms(g, w) for g, w in zip(got, want))}

    def check(self) -> dict:
        order = sorted(self.kept)
        if not order:
            return {"worst_request_rel_rms": float("inf")}
        want = self.reference(np.concatenate([self.pool[self.kept[i][0]] for i in order]))
        return {"worst_request_rel_rms": max(
            rel_rms(torch.from_numpy(self.kept[i][1][0]), want[k]) for k, i in enumerate(order))}
