"""The DRAM device model's error type.

Only ``AmbitError`` lives here for now, so that the port's import paths
match the reference package's; the device model itself (``AmbitSubarray``,
``AmbitDevice``) is ported with the ``ambit_sim`` backend (ROADMAP queue 1
item 8).
"""


class AmbitError(RuntimeError):
    """Raised when a command stream has undefined analog behaviour."""
