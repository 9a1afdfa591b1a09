"""paddle.sysconfig (the port of `paddle_tpu/sysconfig.py`; ref
python/paddle/sysconfig.py): the package's include and library
directories."""
import os


def get_include():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "include")


def get_lib():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "libs")
