"""paddle.distributed.utils helpers (the port of
`paddle_tpu/distributed/utils.py`): free ports, the host's name and
address, a logger, the fluid-era argparse helper, and the launcher's
cluster model re-exported."""
import logging
import socket

from .launch import get_cluster, Pod  # noqa: F401  (re-exported helpers)


def find_free_ports(num):
    """`num` ports the kernel hands out, as a set (ref utils.py
    find_free_ports)."""
    socks, ports = [], []
    try:
        for _ in range(num):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return set(ports)


def get_host_name_ip():
    try:
        host = socket.gethostname()
        return host, socket.gethostbyname(socket.getfqdn(host))
    except OSError:
        return None


def get_logger(log_level=20, name="root"):
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(levelname)s %(asctime)s %(filename)s:%(lineno)d] %(message)s"))
        logger.addHandler(h)
    return logger


def add_arguments(argname, type, default, help, argparser, **kwargs):
    """ref utils.py add_arguments (fluid-era argparse helper)."""
    type = (lambda v: v.lower() in ("true", "1")) if type == bool else type
    argparser.add_argument(
        "--" + argname, default=default, type=type,
        help=help + " Default: %(default)s.", **kwargs)
