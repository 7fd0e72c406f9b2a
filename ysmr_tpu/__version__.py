"""Version of ysmr_tpu.

Mirrors the reference's version module (ysmr/__version__.py:11-13) but
versions the JAX rebuild independently.
"""

VERSION = (0, 1, 0)

__version__ = '.'.join(map(str, VERSION))
