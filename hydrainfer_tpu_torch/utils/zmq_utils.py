"""ZMQ PUSH/PULL helpers for cross-process token streaming (port of
hydrainfer_tpu/utils/zmq_utils.py, a copy)."""
from dataclasses import dataclass

import zmq


@dataclass
class ZmqConfig:
    host: str = "127.0.0.1"
    port: int = -1          # -1 = auto


def init_zmq_send(config: ZmqConfig):
    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.PUSH)
    sock.connect(f"tcp://{config.host}:{config.port}")
    return sock


def init_zmq_recv(config: ZmqConfig):
    from .socket_utils import find_free_port
    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.PULL)
    if config.port in (-1, None):
        config.port = find_free_port()
    sock.bind(f"tcp://{config.host}:{config.port}")
    return sock
