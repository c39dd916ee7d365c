"""Version of the port, in one importable place (the JAX package's
``version.py``); the daemon's ``ping`` reply and build-info gauge carry
it."""

__version__ = "0.1.0"
