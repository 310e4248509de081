"""Child program of the port's fleet tests (tests/test_torch_fleet.py):
one serving replica process on the CPU.

It loads the newest generation of the model registry, builds a
``ServeEngine`` on the CPU, and serves it through a ``ReplicaServer`` of
the package it is asked for (the port's, ``--package torch``, or the JAX
package's, ``--package jax``), announcing itself in the fleet directory
and polling the registry for new generations.  Its telemetry goes to
``FLEET_DIR/records.hNNN.jsonl``.  ``--kill-at N`` arms a
``kill_replica`` chaos fault at its N-th request.  SIGTERM stops it
cleanly; it then prints one JSON line with the requests it saw and the
generation it serves.

Usage: python torch_fleet_child.py --package {torch,jax} --fleet-dir DIR
       --registry DIR --replica N [--max-queue-rows N] [--kill-at N]
"""

import argparse
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--fleet-dir", required=True)
    ap.add_argument("--registry", required=True)
    ap.add_argument("--replica", type=int, required=True)
    ap.add_argument("--max-queue-rows", type=int, default=None)
    ap.add_argument("--kill-at", type=int, default=-1)
    args = ap.parse_args(argv)

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from spark_agd_tpu import obs, serve
        from spark_agd_tpu.resilience import chaos
        kw = {}
    else:
        from spark_agd_tpu_torch import obs, serve
        from spark_agd_tpu_torch.resilience import chaos
        kw = {"device": "cpu"}

    os.makedirs(args.fleet_dir, exist_ok=True)
    tel = obs.Telemetry([obs.JSONLSink(os.path.join(
        args.fleet_dir, f"records.h{args.replica:03d}.jsonl"))])
    registry = serve.ModelRegistry(args.registry, telemetry=tel, **kw)
    loaded = registry.load_newest()
    if loaded is None:
        print("no published generation to serve", file=sys.stderr)
        return 1
    engine = serve.ServeEngine(loaded.model, generation=loaded.generation,
                               max_batch=16, min_bucket=4, **kw)
    faults = None
    if args.kill_at >= 0:
        faults = chaos.ChaosSchedule(
            [chaos.ScheduledFault("kill_replica", at_iter=args.kill_at,
                                  process=args.replica)], telemetry=tel)
    server = serve.ReplicaServer(
        args.fleet_dir, args.replica, engine, registry=registry,
        telemetry=tel, chaos=faults, max_queue_rows=args.max_queue_rows,
        beat_every_s=0.25, poll_every_s=0.1)
    signal.signal(signal.SIGTERM, lambda *_: server.request_stop())
    server.start()
    while not server._stop.is_set():
        time.sleep(0.05)
    server.stop()
    tel.flush()
    print(json.dumps({"replica": args.replica,
                      "requests_seen": server.requests_seen,
                      "generation": int(engine.generation)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
