"""Host runtime of the port: the native seqlock exchange
(`exchange.cpp`, built with g++ by `native.py`)."""

from .native import NativeWindow, PySeqlockWindow, available  # noqa: F401
