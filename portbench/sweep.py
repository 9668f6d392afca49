"""The serving knee, found once when a serving cell is defined: on the
card, one session of the cell's set-up is driven closed loop (requests back
to back: the service rate), then open loop at each rate given, each for a
short window. Prints one JSON line per step. The knee is the highest rate
whose queue does not grow through the window (the last request finishing
within a few service times of its due time); the cell's traffic file
records it and sets its rate at four fifths of it.

    python3 -m portbench.sweep --workload flagship.serve.b1 --seed 7 \
        --rates 200,250,300,350,400 --seconds 5
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import registry
from portbench.kinds.serve import Driver


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 3
    cell = registry.cell(registry.load_benchmark(Path.cwd()), args.workload)
    driver = Driver(cell, args.seed, torch.device("cuda", 0))
    walls = []
    for i in range(500):
        t = time.perf_counter()
        driver.session.predict(driver.pool[i % len(driver.pool)])
        walls.append(time.perf_counter() - t)
    service = float(np.median(walls))
    print(json.dumps({"closed_loop_per_s": 1 / float(np.mean(walls)),
                      "service_p50_ms": 1e3 * service,
                      "service_p95_ms": 1e3 * float(np.percentile(walls, 95))}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        driver.late_s = []
        lat = np.asarray(driver.serve(rate, args.seconds)) * 1e3
        late = np.asarray(driver.late_s) * 1e3
        print(json.dumps({"rate": rate, "requests": len(lat), "p50_ms": float(np.median(lat)),
                          "p95_ms": float(np.percentile(lat, 95)), "max_ms": float(lat.max()),
                          "last_ms": float(lat[-1]), "late_p95_ms": float(np.percentile(late, 95)),
                          "queue_grew": bool(lat[-1] > 10 * 1e3 * service
                                             and lat[-len(lat) // 4:].mean()
                                             > 2 * lat[:len(lat) // 4].mean())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
