"""Container healthcheck: one grpc.health.v1.Health/Check round-trip
(the reference image's healthcheck role; exit 0 iff SERVING).

Usage: python -m access_control_srv_tpu_torch.healthcheck HOST:PORT
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    addr = argv[0] if argv else "127.0.0.1:50061"
    import grpc

    from .srv.gen.rc import health_pb2

    channel = grpc.insecure_channel(addr)
    try:
        rpc = channel.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
        resp = rpc(health_pb2.HealthCheckRequest(), timeout=4)
        ok = resp.status == health_pb2.HealthCheckResponse.SERVING
        print("SERVING" if ok else "NOT_SERVING")
        return 0 if ok else 1
    except grpc.RpcError as err:
        print(f"health check failed: {err.code().name}", file=sys.stderr)
        return 1
    finally:
        channel.close()


if __name__ == "__main__":
    sys.exit(main())
