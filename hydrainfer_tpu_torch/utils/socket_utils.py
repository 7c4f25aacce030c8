"""Free-port lookup (port of hydrainfer_tpu/utils/socket_utils.py, a copy of
its `find_free_port`: that module imports no JAX, and the port imports
nothing of the JAX package. Its `get_host` / `parse_address`, which nothing
calls, are left out)."""
import socket


def find_free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port
