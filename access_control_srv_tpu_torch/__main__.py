"""Process entrypoint: start the worker + gRPC transport, stop cleanly on
SIGINT/SIGTERM (reference: src/start.ts:6-21 — cfg from the working
directory, worker.start, SIGINT -> worker.stop).

    python -m access_control_srv_tpu_torch [--config-dir DIR]
        [--addr HOST:PORT] [--device cuda|cuda:N|cpu]
    python -m access_control_srv_tpu_torch --broker [--addr HOST:PORT]
    python -m access_control_srv_tpu_torch --router --replica H:P ...
    python -m access_control_srv_tpu_torch --cluster [--replicas N]
        [--device cuda|cpu]

The worker serves on the CUDA device unless ``--device`` names another
(``cpu`` runs every kernel's plain PyTorch version); without CUDA the
default fails at startup.  ``--broker`` serves the cross-process
event/cache broker (srv/broker.py) instead of a worker — the Kafka/Redis
role of a multi-worker deployment; ``--router`` serves a ClusterRouter
(srv/router.py) over already-running replicas; ``--cluster`` brings up
the whole local tier (broker + N replicas on ``--device`` + router,
parallel/cluster.py) in one command.  Each prints its ready line
(``broker listening on``, ``routing on``) and stops on SIGINT / SIGTERM.

With ``cluster:distributed:enabled`` in the config, each process of an
N-rank world is started alike, its rank in ``ACS_CLUSTER_PROCESS_ID``:
rank 0 serves once every rank has compiled, and prints ``serving on``;
every other rank prints ``following rank 0 as rank R``, runs the
follower loop of the ``parallel:*`` mesh (srv/follower.py), binds no
port, and ends when rank 0 stops.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="access_control_srv_tpu_torch")
    parser.add_argument(
        "--config-dir", default=os.getcwd(),
        help="directory holding config.json / config_{ENV}.json",
    )
    parser.add_argument(
        "--env", default=os.environ.get("NODE_ENV"),
        help="config environment overlay name",
    )
    parser.add_argument(
        "--addr", default=None,
        help="bind address (overrides server:transports[0].addr)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to serve on (default: the CUDA device)",
    )
    parser.add_argument(
        "--broker", action="store_true",
        help="serve the cross-process event/cache broker instead of a worker",
    )
    parser.add_argument(
        "--broker-data-dir", default=None,
        help="broker durability: journal directory (topics/offsets/KV "
             "survive restarts)",
    )
    parser.add_argument(
        "--broker-secret", default=os.environ.get("ACS_BROKER_SECRET"),
        help="broker auth: shared secret required from every connection "
             "(also via ACS_BROKER_SECRET)",
    )
    parser.add_argument(
        "--broker-fsync-interval", default=None, type=float,
        help="broker durability: fsync the journal at most every N "
             "seconds (0 = every record); default keeps flush-only "
             "semantics — a host crash can drop the flushed tail",
    )
    parser.add_argument(
        "--broker-snapshot-every", default=None, type=int,
        help="broker durability: take a crash-consistent snapshot and "
             "truncate the journal behind it every N journal records "
             "(default: never — replay walks the full journal)",
    )
    parser.add_argument(
        "--router", action="store_true",
        help="serve a cluster router (srv/router.py) over running "
             "replicas instead of a worker",
    )
    parser.add_argument(
        "--replica", action="append", default=None, metavar="HOST:PORT",
        help="replica address for --router (repeatable)",
    )
    parser.add_argument(
        "--cluster", action="store_true",
        help="bring up the whole local cluster tier: broker + replicas "
             "+ router (parallel/cluster.py)",
    )
    parser.add_argument(
        "--replicas", default=None, type=int,
        help="replica count for --cluster (default: cfg cluster:replicas)",
    )
    args = parser.parse_args(argv)

    if args.addr is not None:
        _, sep, port = args.addr.rpartition(":")
        if not sep or not port.isdecimal() or not 0 <= int(port) <= 65535:
            parser.error(
                f"--addr must be HOST:PORT (e.g. 0.0.0.0:50061), "
                f"got {args.addr!r}"
            )

    stop_event = threading.Event()

    def request_stop(signum, frame):
        stop_event.set()

    signal.signal(signal.SIGINT, request_stop)
    signal.signal(signal.SIGTERM, request_stop)

    if args.broker:
        from .srv.broker import BrokerServer

        host, _, port = (args.addr or "127.0.0.1:0").rpartition(":")
        broker = BrokerServer(
            host or "127.0.0.1", int(port),
            data_dir=args.broker_data_dir,
            secret=args.broker_secret,
            fsync_interval_s=args.broker_fsync_interval,
            snapshot_every=args.broker_snapshot_every,
        ).start()
        print(f"broker listening on {broker.address}", flush=True)
        stop_event.wait()
        broker.stop()
        return 0

    if args.router:
        from .srv.config import Config
        from .srv.router import ClusterRouter

        if not args.replica:
            parser.error("--router requires at least one --replica")
        cfg = Config.load(args.config_dir, env=args.env)
        router = ClusterRouter(
            args.replica,
            addr=args.addr or cfg.get("cluster:router:addr", "127.0.0.1:0"),
            cfg=cfg.get("cluster:router") or {},
        ).start()
        print(f"routing on {router.addr}", flush=True)
        stop_event.wait()
        router.stop()
        return 0

    if args.cluster:
        from .parallel.cluster import LocalCluster
        from .srv.config import Config

        cfg = Config.load(args.config_dir, env=args.env)
        cluster = LocalCluster(
            n_replicas=args.replicas or cfg.get("cluster:replicas", 2),
            seed_cfg=cfg.get("seed_data") or {},
            router_cfg=cfg.get("cluster:router") or {},
            device=args.device,
        ).start()
        print(f"routing on {cluster.router.addr}", flush=True)
        stop_event.wait()
        cluster.stop()
        return 0

    from .srv.config import Config
    from .srv.transport_grpc import GrpcServer
    from .srv.worker import Worker

    cfg = Config.load(args.config_dir, env=args.env)
    # a multi-process world (cluster:distributed): every rank joins the
    # process group before any device work; rank 0 serves below, every
    # other rank follows its kernel calls and binds no port
    import torch.distributed as dist

    from .parallel.cluster import maybe_initialize_distributed

    try:
        maybe_initialize_distributed(cfg, device=args.device)
    except Exception as err:
        print(f"startup error: {err}", file=sys.stderr, flush=True)
        return 1
    if dist.is_initialized() and dist.get_rank() != 0:
        from .srv.follower import serve

        # a follower ends with rank 0's stop, or at a signal's default
        signal.signal(signal.SIGINT, signal.SIG_DFL)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        return serve(cfg, device=args.device)
    worker = Worker()
    try:
        worker.start(cfg, device=args.device)
    except Exception as err:  # startup error path (start.ts:11-14)
        print(f"startup error: {err}", file=sys.stderr, flush=True)
        return 1
    transports = cfg.get("server:transports") or []
    addr = args.addr or (
        transports[0].get("addr") if transports else "0.0.0.0:50061"
    )
    server = GrpcServer(worker, addr).start()
    print(f"serving on {server.addr}", flush=True)

    stop_event.wait()  # SIGINT / SIGTERM
    print("shutting down", flush=True)
    server.stop()
    worker.stop()
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
