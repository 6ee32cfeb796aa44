"""Network helpers: IP discovery and reachability preflight.

A copy of the JAX package's ``cluster/net.py`` (no JAX in it). Parity
targets: the reference's IP helper
(the reference's README.md:271-275: ``socket.gethostbyname(socket.gethostname())``)
and its manual ``ping <ip>`` preflight advice (README.md:251), turned into a
programmatic TCP check the launcher runs before gang-start.
"""

from __future__ import annotations

import socket
import time
from typing import Dict, List


def my_ip() -> str:
    """Best-effort local IP (README.md:271-275 equivalent, with a UDP-connect
    fallback that works when the hostname doesn't resolve)."""
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))  # no packets sent; just picks a route
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def free_ports(n: int) -> List[int]:
    """n distinct free ports, all held (bound) simultaneously before release
    so none is a duplicate and all were genuinely free at the same moment —
    unlike probing one port and assuming the next n-1 consecutive ones."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def backoff_schedule(attempts: int, backoff: float = 0.5,
                     backoff_max: float = 8.0) -> List[float]:
    """Sleep lengths BETWEEN ``attempts`` tries: bounded exponential,
    ``backoff * 2**i`` capped at ``backoff_max`` (len == attempts - 1).
    Shared by the reachability retry below and unit-testable on its own."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    return [min(backoff * 2.0**i, backoff_max) for i in range(attempts - 1)]


def check_reachable(addr: str, timeout: float = 2.0, attempts: int = 1,
                    backoff: float = 0.5, backoff_max: float = 8.0,
                    _sleep=time.sleep) -> bool:
    """TCP reachability to host:port (the programmatic 'ping', README.md:251).

    A connection *refusal* still means the host is up (nothing bound to the
    port yet — normal before gang-start); only DNS failure or a timeout /
    network unreachability counts as down. Those failures are retried up to
    ``attempts`` times with bounded exponential backoff (``backoff``,
    doubling, capped at ``backoff_max``): a worker VM that is still booting
    resolves/routes a few seconds late, and one slow host must delay
    gang-start, not fail it. A positive answer returns immediately."""
    host, port = addr.rsplit(":", 1)
    delays = backoff_schedule(attempts, backoff, backoff_max)
    for i in range(attempts):
        try:
            with socket.create_connection((host, int(port)), timeout=timeout):
                return True
        except ConnectionRefusedError:
            return True  # host answered; port simply not bound yet
        except OSError:
            if i < len(delays):
                _sleep(delays[i])
    return False


def preflight(workers: List[str], timeout: float = 2.0, attempts: int = 3,
              backoff: float = 0.5, backoff_max: float = 8.0) -> Dict[str, bool]:
    """Reachability map for a worker list, run by the launcher before
    gang-start (replaces the reference's manual `ping`, README.md:251).
    Retries each unreachable worker with bounded exponential backoff
    (``attempts`` tries) so workers still booting pass the gang-start
    check instead of failing on the first refused/unrouted probe."""
    return {
        w: check_reachable(w, timeout=timeout, attempts=attempts,
                           backoff=backoff, backoff_max=backoff_max)
        for w in workers
    }
